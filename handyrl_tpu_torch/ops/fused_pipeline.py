"""The fused device loop: a dispatch is a rollout chunk, its window ingest
and K recency-sampled SGD steps, and the host reads one packed tensor.

The port of ``handyrl_tpu/ops/fused_pipeline.py:48-385`` on one device.
Where the JAX package compiles a dispatch into one XLA program with
donated buffers, this keeps the loop's state in static tensors updated in
place (the env state, the per-env history, the ring and its cursor and
size, the train state inside ``ReplayUpdateStep``, the actor's parameters,
a recurrent actor's hidden state)
and runs a dispatch as CUDA graphs:

    the chunk graph: ``chunk_steps`` self-play plies (device_generation.
      make_gen_body) -> the windower's ingest into the ring;
    the step graph, replayed K times: slots drawn, the batch gathered from
      the ring, lr from the device step counter, the update step.

The warm-up dispatch (before ``minimum_episodes``) replays the chunk graph
alone, so the step counter and Adam never see an empty ring. Each dispatch
packs done, outcome, the ring's size, the windows it ingested and the K
steps' summed metrics into one tensor, copied to pinned host memory without
blocking; the host parses a dispatch's tensor after it has enqueued the next
dispatch (one deep, as the JAX package's ``_pending``/``_flip``).

Actor parameters: self-play acts with the epoch's snapshot while the
optimiser moves on; the actor module's own parameters are the snapshot,
refreshed on the device with ``copy_`` (:meth:`refresh_actor`), which keeps
the graph's pointers valid.

Launches count under 'generation' (the chunk: K1's serving form) and
'training' (the steps: K1's training form, K2 and the targets' kernels),
once a replay by ``CapturedCall``'s bookkeeping.

Sharded over the ranks of a data-parallel job (``mesh`` of W ranks, one
card a rank; the JAX package's ``_shard_loop_state`` and
``_build_sharded``, fused_pipeline.py:239-331 there): each rank owns
``n_envs / W`` envs (its rows of the global initial env state), a ring of
``capacity`` rows (the learner divides the ring's budget by W), its own
cursor, size and generators (seeded by rank; a world of 1 keeps the seeds
of one card) and draws ``batch_size / W`` windows a step; the update step
sums the grads over the ranks (``ops/train_step.py``). The packed fetch is
global on every rank: at the parse, after the next dispatch is enqueued,
each rank's pack is gathered over the job's host group, so done and
outcome are (K, N) and (K, N, P) of every env, the ring's size is summed,
its minimum over the ranks kept (the warm-up holds until every rank's
ring holds a window) and the windows ingested summed, as JAX's
``psum``/``pmin`` (:278-294 there); every rank's learner then counts the
same episodes and closes the same epochs. The learner's stop flags (the
deadline, a preemption signal) ride the same gather, ORed over the ranks
(:attr:`FusedPipeline.agreed_flags`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device_generation import (copy_hidden_, copy_state_, env_generator,
                                 is_recurrent, make_gen_body, rank_seed,
                                 state_rows)
from ..utils.tree import map_structure
from . import launches
from .graphs import CapturedCall, PackedFetch
from .train_step import ReplayUpdateStep

Tensor = torch.Tensor


class FusedPipeline:
    """Owns the device-resident loop state (env state, windower history,
    ring) and the chunk program; the train state lives in ``update_step``
    (a :class:`ReplayUpdateStep`, bound here to the ring), the actor's
    parameters in ``actor`` (the module self-play runs)."""

    def __init__(self, env_mod, actor: torch.nn.Module, update_step:
                 ReplayUpdateStep, windower, n_envs: int, chunk_steps: int,
                 sgd_steps: int, batch_size: int, seed: int = 0, mesh=None):
        self.env_mod, self.actor = env_mod, actor
        self.update_step, self.windower = update_step, windower
        self.n_envs, self.chunk_steps = int(n_envs), int(chunk_steps)
        self.sgd_steps, self.batch_size = int(sgd_steps), int(batch_size)
        self.num_players = int(env_mod.NUM_PLAYERS)
        self.device = next(actor.parameters()).device
        dev = self.device
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        ndev = self.mesh.size if self.mesh is not None else 1
        if self.n_envs % ndev or self.batch_size % ndev:
            raise ValueError('generation_envs %d and batch_size %d must '
                             'divide over the %d ranks'
                             % (self.n_envs, self.batch_size, ndev))
        self.ndev = ndev
        self.n_loc = self.n_envs // ndev          # this rank's envs
        self.b_loc = self.batch_size // ndev      # this rank's batch slice
        # streams of draws: the envs and the actions; the windows' train
        # starts and seats; the steps' slots (each registered with one graph)
        self.generator = env_generator(dev, seed)
        self.state = env_mod.init_state(self.n_envs,
                                        generator=self.generator, device=dev)
        if self.mesh is not None:
            # this rank's rows of the global reset; its own streams
            lo = self.mesh.index * self.n_loc
            self.state = state_rows(self.state, lo, lo + self.n_loc)
            seed = rank_seed(seed, self.mesh.index)
            self.generator = env_generator(dev, seed)
        self.window_generator = env_generator(dev, seed + 1)
        self.slot_generator = env_generator(dev, seed + 2)
        # a recurrent actor's state (N, P, ...) a leaf, static as the env's
        self.hidden = (actor.init_hidden((self.n_loc, self.num_players))
                       if is_recurrent(actor) else None)
        self._rollout = make_gen_body(env_mod, actor)

        # the history and the ring, shaped after the records of one ply
        probe = self._probe_records()
        self.wstate = windower.init_state(probe)
        self.ring = windower.init_ring(probe)
        self.capacity = windower.capacity
        self.cursor = torch.zeros((), dtype=torch.int64, device=dev)
        self.size = torch.zeros((), dtype=torch.int64, device=dev)
        update_step.bind(self.ring, windower.window_spec, self.size,
                         self.cursor, self.capacity, self.b_loc,
                         self.slot_generator)

        self._chunk = CapturedCall(self._gen_ingest, dev,
                                   [self.generator, self.window_generator])
        self._fetch = PackedFetch(dev)
        self._pending = None
        self.metric_names = ()
        self.dispatches = 0
        self.fused_dispatches = 0        # the dispatches that trained
        self.ring_size_host = 0          # summed over the ranks
        self.ring_min_host = 0           # the smallest rank's
        self.windows_ingested_host = 0   # cumulative, past the ring's wraps
        # on a mesh, host flags (a callable's bools, read at the parse)
        # ride the gathered pack and are ORed over the ranks: how the
        # learner's stop decisions land at the same dispatch on every rank
        # without a collective of their own
        self.host_flags = None
        self.agreed_flags: Tuple[bool, ...] = ()
        self.fetch_seconds = 0.0   # the host's waits on the packed fetches

    @torch.no_grad()
    def _probe_records(self) -> Dict[str, Tensor]:
        """Zero records of one ply, (1, N, ...), for the shapes: what the
        rollout records for a copy of ``self.state`` (nothing advances; its
        forward counts under 'generation')."""
        state = type(self.state)(*[t.clone() for t in self.state])
        hidden = (None if self.hidden is None else
                  map_structure(torch.clone, self.hidden))
        with launches.path('generation'):
            records = self._rollout(state, 1, torch.Generator(
                device=self.device).manual_seed(0), hidden)[1]
        return {k: map_structure(torch.zeros_like, v)
                for k, v in records.items()}

    def _gen_ingest(self) -> Dict[str, Tensor]:
        """One chunk of self-play, ingested; the static state in place."""
        state, records, hidden = self._rollout(
            self.state, self.chunk_steps, self.generator, self.hidden)
        copy_state_(self.state, state)
        copy_hidden_(self.hidden, hidden)
        _, n_win = self.windower.ingest(records, self.wstate, self.ring,
                                        self.cursor, self.size,
                                        self.window_generator)
        return {'done': records['done'], 'outcome': records['outcome'],
                'action': records['action'], 'n_win': n_win}

    def _pack(self, chunk: Dict[str, Tensor],
              metrics: Optional[Tensor]) -> Tensor:
        parts = [chunk['done'].float().reshape(-1),
                 chunk['outcome'].float().reshape(-1),
                 self.size.float().reshape(1),
                 chunk['n_win'].float().reshape(1)]
        if metrics is not None:
            parts.append(metrics.float().reshape(-1))
        return torch.cat(parts)

    def _parse(self, flat: np.ndarray) -> Dict[str, Any]:
        K, N, P = self.chunk_steps, self.n_loc, self.num_players
        packs = [flat]
        if self.mesh is not None:
            from ..parallel.multihost import all_gather_host
            mine = np.asarray(self.host_flags() if self.host_flags else (),
                              flat.dtype)
            packs = all_gather_host(np.concatenate([flat, mine]))
            self.agreed_flags = tuple(
                bool(v) for v in np.max([f[flat.size:] for f in packs],
                                        axis=0))
            packs = [f[:flat.size] for f in packs]
        # each rank's envs are its rows of the global env axis
        done = np.concatenate([f[:K * N].reshape(K, N) for f in packs],
                              axis=1) > 0.5
        outcome = np.concatenate(
            [f[K * N:K * N * (1 + P)].reshape(K, N, P) for f in packs],
            axis=1)
        tails = [f[K * N * (1 + P):] for f in packs]
        rest = flat[K * N * (1 + P):]   # the metrics: summed on every rank
        self.ring_size_host = sum(int(t[0]) for t in tails)
        self.ring_min_host = min(int(t[0]) for t in tails)
        self.windows_ingested_host += sum(int(t[1]) for t in tails)
        metrics = None
        if len(rest) > 2:
            metrics = {k: float(v) for k, v in zip(self.metric_names,
                                                   rest[2:])}
        return {'done': done, 'outcome': outcome, 'metrics': metrics}

    def _flip(self, packed: Tensor) -> Optional[Dict[str, Any]]:
        prev, self._pending = self._pending, self._fetch.put(packed)
        self.dispatches += 1
        if prev is None:
            return None
        return self._parse(self._wait(prev))

    def _wait(self, handle) -> np.ndarray:
        t0 = time.perf_counter()
        try:
            return PackedFetch.get(handle)
        finally:
            self.fetch_seconds += time.perf_counter() - t0

    def refresh_actor(self, params: Dict[str, Tensor]) -> None:
        """Copy ``params`` (the trainer's, on the device) into the actor's
        parameters and buffers (a 'batch' net's running averages) in
        place."""
        with torch.no_grad():
            for name, p in self.actor.named_parameters():
                p.copy_(params[name])
            for name, b in self.actor.named_buffers():
                b.copy_(params[name])

    def warm_step(self) -> Optional[Dict[str, Any]]:
        """A chunk and its ingest, no SGD. Returns the PREVIOUS dispatch's
        parsed accounting, or None on the first call."""
        with launches.path('generation'):
            chunk = self._chunk()
        return self._flip(self._pack(chunk, None))

    def train_step(self, data_cnt_ema: float) -> Optional[Dict[str, Any]]:
        """A chunk, its ingest and ``sgd_steps`` update steps. Returns the
        previous dispatch's parsed accounting (with its summed metrics, or
        None as metrics after a warm-up dispatch)."""
        with launches.path('generation'):
            chunk = self._chunk()
        with launches.path('training'):
            metrics = self.update_step.run(self.sgd_steps, data_cnt_ema)
        self.metric_names = self.update_step.metric_names
        self.fused_dispatches += 1
        return self._flip(self._pack(chunk, metrics))

    def drain(self) -> Optional[Dict[str, Any]]:
        """The in-flight dispatch's accounting, at the loop's end."""
        if self._pending is None:
            return None
        prev, self._pending = self._pending, None
        return self._parse(self._wait(prev))

    def release(self) -> None:
        """Drop the graphs, the ring and the history (the counters stay)."""
        self._chunk = None
        self._pending = None
        self.ring = self.wstate = None
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
