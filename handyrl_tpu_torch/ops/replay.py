"""The replay ring on the device: its sampling rule, its size, and the ring
the host pushes windows into.

The port of ``handyrl_tpu/ops/replay.py`` (``recency_slots`` and
``DeviceReplay``) and of the ring-capacity rule of the JAX learner
(``handyrl_tpu/train.py:445-460``). The fused loop and the threaded
trainer's device ingest keep their ring in ``ops/device_windows.py``;
:class:`DeviceReplay` is the ring of the threaded trainer's host push
(windows built on the host from whole episodes). Both hold one flat row
per window leaf and are read by ``ops/train_step.ReplayUpdateStep``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import telemetry
from .device_windows import flatten_window_keys

Tensor = torch.Tensor

# the JAX learner's caps on the ring: at most 4096 episodes' worth of
# windows, and at most 49152 windows in all
MAX_RING_EPISODES = 4096
MAX_RING_WINDOWS = 49152


# the ring's host-side accounting (pushes and eager samples; a captured
# K-step update draws its slots inside the graph)
_WINDOWS = telemetry.counter('replay_windows_ingested_total')
_SAMPLES = telemetry.counter('replay_samples_drawn_total')
_SIZE = telemetry.gauge('replay_ring_size')
_OCC = telemetry.gauge('replay_ring_occupancy')


def windows_per_episode(args: Dict[str, Any]) -> int:
    """Windows an episode contributes to the ring (and the most one
    episode's ingest draws): ``replay_windows_per_episode``, or
    max(1, 64 // forward_steps)."""
    return int(args.get('replay_windows_per_episode')
               or max(1, 64 // args['forward_steps']))


def resolve_windows_per_episode(args: Dict[str, Any], env_mod) -> None:
    """The JAX learner's resolution of an unset
    ``replay_windows_per_episode`` when ``device_replay`` is on
    (handyrl_tpu/train.py:1212-1224): max(1, MAX_STEPS // forward_steps)
    of the env twin ``env_mod``, written into ``args`` before the ring and
    the windower are sized, so both read it."""
    if not args.get('replay_windows_per_episode'):
        max_steps = int(getattr(env_mod, 'MAX_STEPS',
                                getattr(env_mod, 'MAX_PLIES', 64)))
        args['replay_windows_per_episode'] = max(
            1, max_steps // args['forward_steps'])


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


class DeviceReplay:
    """A fixed-capacity ring of training windows in device memory, the
    port of the JAX package's ``DeviceReplay`` (ops/replay.py:56-130 there).

    Windows are flat dicts of arrays shaped (T, P, ...) as
    ``ops/batch.py`` builds them. The ring is one (capacity, prod(window
    shape)) tensor a leaf, allocated at the first :meth:`push` from its
    shapes; :attr:`window_spec` keeps each leaf's shape and dtype, and
    :meth:`sample` restores them. :meth:`push` writes at the cursor with
    wrap. ``size_t`` and ``cursor_t`` are 0-d device tensors that follow
    :attr:`size` and :attr:`cursor` in place, so a captured update step
    bound to :attr:`buffers` reads the ring's current extent."""

    def __init__(self, capacity: int, device: Any = 'cpu'):
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.buffers: Dict[str, Tensor] = {}
        self.window_spec: Dict[str, Tuple[tuple, torch.dtype]] = {}
        self.cursor = 0
        self.size = 0
        self.size_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self.cursor_t = torch.zeros((), dtype=torch.int64, device=self.device)

    def push(self, windows: Dict[str, Any]) -> None:
        """Append a stack of windows (leading axis = window count), numpy
        arrays or tensors; a dict observation's leaves go to one ring leaf
        each ('observation.board')."""
        leaves = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v)
            for k, v in flatten_window_keys(windows).items()}
        n = next(iter(leaves.values())).shape[0]
        if not self.buffers:
            self.window_spec = {k: (tuple(v.shape[1:]), v.dtype)
                                for k, v in leaves.items()}
            self.buffers = {
                k: torch.zeros((self.capacity, max(1, int(np.prod(shape)))),
                               dtype=dtype, device=self.device)
                for k, (shape, dtype) in self.window_spec.items()}
        idx = torch.remainder(self.cursor + torch.arange(n), self.capacity
                              ).to(self.device)
        for k, buf in self.buffers.items():
            buf[idx] = leaves[k].reshape(n, -1).to(self.device, buf.dtype)
        self.cursor = (self.cursor + n) % self.capacity
        self.size = min(self.size + n, self.capacity)
        self.size_t.fill_(self.size)
        self.cursor_t.fill_(self.cursor)
        _WINDOWS.inc(n)
        _SIZE.set(self.size)
        _OCC.set(self.size / self.capacity)

    def sample(self, batch_size: int, generator: Optional[torch.Generator]
               = None, u: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """A (B, T, P, ...) batch of ring windows drawn with
        :func:`recency_slots`, from uniforms ``u`` (B,) or drawn from
        ``generator``."""
        if self.size <= 0:
            raise ValueError('sampling from an empty replay buffer')
        _SAMPLES.inc(batch_size)
        if u is None:
            u = torch.rand((batch_size,), generator=generator,
                           device=self.device)
        slots = recency_slots(u.to(self.device), self.size_t, self.cursor_t,
                              self.capacity)
        return {k: buf[slots].reshape((batch_size,) + self.window_spec[k][0])
                for k, buf in self.buffers.items()}
