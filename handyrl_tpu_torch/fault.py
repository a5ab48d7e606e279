"""Reconnect backoff and the chaos knobs (the subset of
``handyrl_tpu/fault.py`` the serving path and the learner use)."""

from __future__ import annotations

import os
import random
from typing import Dict, Optional


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


def parse_chaos(spec: Optional[str] = None) -> Dict[str, float]:
    """Parse ``HANDYRL_TPU_CHAOS`` (or an explicit spec string) into a dict
    of float knobs; empty/unset means chaos off. Malformed entries are
    ignored rather than crashing a production run."""
    if spec is None:
        spec = os.environ.get('HANDYRL_TPU_CHAOS', '')
    out: Dict[str, float] = {}
    for part in (spec or '').split(','):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition('=')
        try:
            out[key.strip()] = float(value)
        except ValueError:
            print('ignoring malformed HANDYRL_TPU_CHAOS entry %r' % part)
    return out
