"""The replay ring's sampling rule and size, for the device-resident loop.

The port of ``handyrl_tpu/ops/replay.py:36-53`` (``recency_slots``) and of
the ring-capacity rule of the JAX learner (``handyrl_tpu/train.py:445-
460``). The ring itself lives in ``ops/device_windows.py`` (flat rows per
window leaf) and is read by ``ops/train_step.ReplayUpdateStep``.

What waits (ROADMAP.md): ``DeviceReplay.push``/``sample``, the ring the
host pushes windows into for the threaded replay trainer.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

Tensor = torch.Tensor

# the JAX learner's caps on the ring: at most 4096 episodes' worth of
# windows, and at most 49152 windows in all
MAX_RING_EPISODES = 4096
MAX_RING_WINDOWS = 49152


def windows_per_episode(args: Dict[str, Any]) -> int:
    """Windows an episode contributes to the ring (and the most one
    episode's ingest draws): ``replay_windows_per_episode``, or
    max(1, 64 // forward_steps)."""
    return int(args.get('replay_windows_per_episode')
               or max(1, 64 // args['forward_steps']))


def sgd_steps_per_chunk(args: Dict[str, Any]) -> int:
    """Update steps a fused dispatch (they pin the replay ratio):
    ``sgd_steps_per_chunk``, or 16."""
    return int(args.get('sgd_steps_per_chunk') or 16)


def ring_capacity(args: Dict[str, Any]) -> int:
    """min(min(maximum_episodes, 4096) * windows per episode, 49152)."""
    return min(min(int(args['maximum_episodes']), MAX_RING_EPISODES)
               * windows_per_episode(args), MAX_RING_WINDOWS)


def recency_slots(u: Tensor, size: Tensor, cursor: Tensor,
                  capacity: int) -> Tensor:
    """Ring slots for uniforms ``u`` (B,) with the reference's recency bias:
    buffer index i of ``size`` windows with probability proportional to
    i + 1 (newest most likely), by the triangular inverse CDF
    i = floor(sqrt(u) * size), clipped to [0, max(size - 1, 0)] (size 0
    gives slot 0); indices count from the oldest window, which sits at
    ``cursor`` once the ring is full. ``size`` and ``cursor`` are 0-d
    integer tensors; the result is int64 (B,)."""
    idx = (torch.sqrt(u) * size.float()).to(torch.int64)
    idx = torch.minimum(idx.clamp(min=0), (size - 1).clamp(min=0))
    start = torch.where(size >= capacity, cursor, torch.zeros_like(cursor))
    return torch.remainder(start + idx, capacity)
