"""Batch samplers (port of dregnerf_tpu/utils/sampler.py): shuffled index
batches with an automatic reshuffle each epoch, and an endless iterator.
The trainers draw their rays on the device and use neither."""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np


class SimpleSampler:
    """Shuffled batch index sampler with automatic epoch reshuffle."""

    def __init__(self, total: int, batch: int, seed: int = 0):
        self.total = total
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.curr = total
        self.ids: np.ndarray | None = None

    def nextids(self) -> np.ndarray:
        if self.ids is None or self.curr >= self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        out = self.ids[self.curr : self.curr + self.batch]
        self.curr += self.batch
        return out


def cycle(iterable: Iterable) -> Iterator:
    """Endless iterator over a (re-iterable) collection."""
    while True:
        for item in iterable:
            yield item
