"""Failure detection and recovery (port of
dregnerf_tpu/runtime/resilience.py).

  * `run_with_retries(fn, on_failure)`: transient runtime errors are
    retried with exponential backoff; fatal ones (and transient ones past
    the budget) call `on_failure` (an emergency checkpoint) and re-raise;
  * `Watchdog`: a hang detector that exits the process hard when the
    training heartbeat goes stale, so that an outer supervisor restarts it
    and training resumes from the latest checkpoint;
  * `guard_nans(tree, where)`: a NaN/Inf tripwire for debugging runs.
"""
from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from dregnerf_tpu_torch.runtime.checkpoint import leaves_with_paths

_TRANSIENT_MARKERS = (
    "Broken pipe",
    "response body closed",
    "length limit exceeded",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "Network Error",
    "Connection reset",
)


def is_transient(exc: BaseException) -> bool:
    msg = str(exc)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def run_with_retries(
    fn: Callable[[], Any],
    max_retries: int = 3,
    backoff_s: float = 5.0,
    on_failure: Optional[Callable[[BaseException], None]] = None,
) -> Any:
    """Run fn; retry transient runtime errors with exponential backoff.

    Non-transient errors (and transient ones past the retry budget) invoke
    `on_failure` (e.g. an emergency checkpoint save) and re-raise.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as exc:  # noqa: BLE001 — classification below
            if is_transient(exc) and attempt < max_retries:
                attempt += 1
                wait = backoff_s * (2 ** (attempt - 1))
                print(
                    f"[resilience] transient failure (attempt {attempt}/"
                    f"{max_retries}), retrying in {wait:.0f}s: "
                    f"{str(exc)[:200]}",
                    flush=True,
                )
                time.sleep(wait)
                continue
            if on_failure is not None:
                try:
                    on_failure(exc)
                except Exception as save_exc:  # noqa: BLE001
                    print(f"[resilience] emergency save failed: {save_exc}")
            raise


class Watchdog:
    """In-process hang detector for long runs.

    A process wedged in a device wait raises no exception, so
    `run_with_retries` never fires; a wedged device sync cannot be
    interrupted from inside the process. The recovery is process death and
    resume-from-checkpoint::

        with Watchdog(timeout_s=1200, name="ngp") as wd:
            for step in ...:
                train_iteration(step)
                wd.beat()

    A daemon thread checks the heartbeat; when it is older than `timeout_s`
    the process exits hard (os._exit) with `exit_code`, for an outer
    supervisor to relaunch it. timeout_s <= 0 disables the watchdog.
    """

    EXIT_CODE = 86

    def __init__(self, timeout_s: float, name: str = "", exit_code: int = EXIT_CODE):
        self.timeout_s = float(timeout_s)
        self.name = name
        self.exit_code = exit_code
        self._last = time.time()
        self._stop = None

    def beat(self) -> None:
        self._last = time.time()

    def __enter__(self) -> "Watchdog":
        if self.timeout_s <= 0:
            return self
        self._stop = threading.Event()
        self.beat()

        def watch():
            poll = max(min(self.timeout_s / 4.0, 30.0), 1.0)
            while not self._stop.wait(poll):
                stale = time.time() - self._last
                if stale > self.timeout_s:
                    print(
                        f"[watchdog:{self.name}] no heartbeat for "
                        f"{stale:.0f}s (> {self.timeout_s:.0f}s) — "
                        f"exiting {self.exit_code} for supervisor restart",
                        flush=True,
                    )
                    sys.stdout.flush()
                    sys.stderr.flush()
                    os._exit(self.exit_code)

        threading.Thread(target=watch, daemon=True, name=f"watchdog-{self.name}").start()
        return self

    def __exit__(self, *exc) -> None:
        if self._stop is not None:
            self._stop.set()


def guard_nans(tree: Any, where: str = "") -> None:
    """Raise if a floating leaf of a tree of tensors and arrays holds NaN or
    Inf (reads the leaves on the host; call sparingly). The leaf is named by
    its checkpoint path (runtime/checkpoint.py::leaves_with_paths)."""
    for path, leaf in leaves_with_paths(tree).items():
        if isinstance(leaf, torch.Tensor):
            finite = not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            finite = arr.dtype.kind != "f" or bool(np.isfinite(arr).all())
        if not finite:
            raise FloatingPointError(f"non-finite values at {where}:{path}")
