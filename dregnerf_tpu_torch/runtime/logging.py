"""Scalar and image logging (port of dregnerf_tpu/runtime/logging.py): a
tensorboardX SummaryWriter under logs/<exp> when asked for and installed
(the card's machine has no tensorboardX: the logger then says so and goes
on), a printed line per call and its plain-text mirror."""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class ScalarLogger:
    def __init__(
        self,
        log_dir: str,
        text_path: Optional[str] = None,
        enable_tensorboard: bool = False,
    ):
        self.writer = None
        if enable_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                os.makedirs(log_dir, exist_ok=True)
                self.writer = SummaryWriter(log_dir)
            except Exception as e:  # noqa: BLE001 — logging must not stop training
                print(f"[logging] tensorboard unavailable: {e}")
        self.text_file = open(text_path, "a") if text_path else None

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        if self.writer is not None:
            for k, v in scalars.items():
                self.writer.add_scalar(k, float(v), step)
        line = f"step {step} | " + " | ".join(
            f"{k} {float(v):.5g}" for k, v in scalars.items()
        )
        print(line, flush=True)
        if self.text_file:
            self.text_file.write(line + "\n")
            self.text_file.flush()

    def log_image(self, step: int, tag: str, image: np.ndarray) -> None:
        """image: [H, W, 3] float in [0, 1] or uint8."""
        if self.writer is None:
            return
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        self.writer.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        if self.text_file:
            self.text_file.close()
