"""Reconnect backoff (the subset of ``handyrl_tpu/fault.py`` the serving
path uses)."""

from __future__ import annotations

import random
from typing import Optional


class Backoff:
    """Exponential backoff with jitter: delays double from ``initial`` up to
    ``maximum``; each delay is uniformly jittered into
    ``[(1 - jitter) * d, d]`` so synchronized failures desynchronize."""

    def __init__(self, initial: float = 1.0, maximum: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.initial = float(initial)
        self.maximum = float(maximum)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = rng or random
        self._cur = self.initial

    def next_delay(self) -> float:
        base = min(self._cur, self.maximum)
        self._cur = min(self._cur * self.factor, self.maximum)
        return base * (1.0 - self.jitter * self._rng.random())

    def reset(self):
        self._cur = self.initial
