"""Self-describing npz checkpoints (port of dregnerf_tpu/runtime/checkpoint.py).

One `.npz` per checkpoint: every array leaf under a `name::a/b/0` key
(dicts by key, lists by index, as the JAX package flattens its pytrees),
plus a `__meta__` JSON string with all non-array state. The JAX package
reads the port's `model::` and `occupancy::` keys and vice versa.
`CheckpointManager` keeps step-stamped files, a latest copy (`model.ckpt`),
a best-by-score copy and a `checkpoints.txt` registry.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {prefix + "a/b/0": ndarray}."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            out[prefix + "/".join(path)] = _to_numpy(node)

    walk(tree, [])
    return out


def tree_under(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    """The nested tree of the flat checkpoint keys that start with `prefix`."""
    tree: dict = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            node = tree
            *dirs, leaf = key[len(prefix):].split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[leaf] = value
    return tree


def save_checkpoint(path: str, state: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write `state` (trees of arrays, keyed by name) + JSON-able `meta`."""
    flat: Dict[str, np.ndarray] = {}
    for name, tree in state.items():
        flat.update(flatten(tree, prefix=name + "::"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
             **flat)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(flat {'name::a/b': ndarray}, meta)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    return flat, meta


class CheckpointManager:
    """Directory-level manager with registry, retention and best tracking."""

    def __init__(self, save_dir: str, max_to_keep: int = 5,
                 keep_checkpoint_every_n_hours: float = 10000.0):
        self.save_dir = save_dir
        self.max_to_keep = max_to_keep
        self.keep_every_s = keep_checkpoint_every_n_hours * 3600.0
        self.best_score = -np.inf
        self._kept: list[tuple[str, float]] = []
        self._last_permanent = time.time()
        os.makedirs(save_dir, exist_ok=True)
        if os.path.exists(self.registry_path):
            with open(self.registry_path) as f:
                for line in f:
                    p = os.path.join(save_dir, line.strip())
                    if line.strip() and os.path.exists(p):
                        self._kept.append((p, os.path.getmtime(p)))
        if os.path.exists(self.best_path):
            _, meta = load_checkpoint(self.best_path)
            self.best_score = float(meta.get("_score", -np.inf))

    def step_path(self, step: int) -> str:
        return os.path.join(self.save_dir, f"model_{step:06d}.ckpt")

    @property
    def latest_path(self) -> str:
        return os.path.join(self.save_dir, "model.ckpt")

    @property
    def best_path(self) -> str:
        return os.path.join(self.save_dir, "model_best.ckpt")

    @property
    def registry_path(self) -> str:
        return os.path.join(self.save_dir, "checkpoints.txt")

    def save(self, step: int, state: Dict[str, Any], meta: Dict[str, Any],
             score: Optional[float] = None) -> str:
        meta = dict(meta, step=step)
        if score is not None:
            meta["_score"] = float(score)
        path = self.step_path(step)
        save_checkpoint(path, state, meta)
        shutil.copyfile(path, self.latest_path)
        if score is not None and score > self.best_score:
            self.best_score = score
            shutil.copyfile(path, self.best_path)
        now = time.time()
        if now - self._last_permanent >= self.keep_every_s:
            self._last_permanent = now  # this one is permanent: don't track
        else:
            self._kept.append((path, now))
            while len(self._kept) > self.max_to_keep:
                old, _ = self._kept.pop(0)
                if os.path.exists(old):
                    os.remove(old)
        with open(self.registry_path, "w") as f:
            f.writelines(os.path.basename(p) + "\n" for p, _ in self._kept)
        return path

    def resolve(self, path: str = "") -> Optional[str]:
        """The checkpoint to resume from: `path` (a directory means its
        model.ckpt), else the latest copy, else None."""
        for cand in ([path] if path else []) + [self.latest_path]:
            if os.path.isdir(cand):
                cand = os.path.join(cand, "model.ckpt")
            if os.path.exists(cand):
                return cand
        return None
