"""The learner: ``python -m handyrl_tpu_torch.train --config FILE.json
[--device cuda|cpu] [--server]``.

The port of the JAX package's ``python main.py --train`` and
``--train-server`` (handyrl_tpu/train.py). In its default local form
(``batched_generation: True``) one process generates episodes by batched
self-play, evaluates the model online and trains it. With
``batched_generation: false`` the learner serves the worker plane's four
RPCs (:meth:`Learner.server`) to a local worker cluster of spawned gather
and worker processes; with ``--server`` it listens for worker hosts
(``python -m handyrl_tpu_torch.worker``) on the entry and data ports.
A gather's backend is ``generation.backend`` or a host's
``worker_args.backend``: 'worker' processes, or 'device', the fused
rollout on the gather's card (``worker.DeviceActorGather``); the worker
plane never reads ``device_generation``. Every task is booked in a
``fault.TaskLedger`` (stranded tasks re-issued, duplicate uploads
dropped) and every host has a health state
(``fault.FleetController``). A local run whose gathers are lost stops with
exit 1 naming them (the JAX learner waits for them forever).

The durable training plane (``--server`` only; the ``durability``
block): every admitted episode or streamed chunk is written ahead to the
episode spool (``spool.EpisodeSpool``) before it is counted, the book is
journaled (``fault.LedgerJournal``: a snapshot at each checkpoint, deltas
between) and a resume token (``run_token.json``: the run id and a restart
generation) rides the entry handshake. A learner restarted after a
SIGKILL (``restart_epoch: -1``) adopts the token, restores the book and
the counters, replays the spool past the checkpoint's horizon and answers
the gathers' ``RESUME_KIND`` handshake, so they reattach without a
respawn. With ``streaming.enabled`` the uploads are chunks
(``feed_chunks``, ``streaming.ChunkAssembler``), trained on as their
prefix grows; ``streaming.target_clip`` > 0 trains through the IMPACT
target network, synced into the step's buffers every
``target_sync_epochs``.

The league (``league.enabled``, the worker plane's tasks only; the
JAX learner's): ``league.LeaguePool`` over the registry line the learner
publishes to, PFSP-drawn members stamped on a share of the 'g' tasks and
round-robin rating matches on a stride of the 'e' tasks
(:meth:`Learner._fresh_task`), their outcomes booked in a
``league.RatingBook`` journaled under the registry root, and the
champion promoted at an epoch's close only through the rating gate
(:meth:`Learner._league_epoch_sync`).

* :class:`Batcher`: threads (or, with ``batcher_processes``, spawned
  processes that build into shared-memory slots with
  ``batcher_shared_memory``) that sample windows from the episode buffer
  (recency-biased) and build ``(B, T, P, ...)`` numpy batches.
* :class:`Trainer`: a thread that stages batches to the device (pinned host
  memory, a copy stream, ``prefetch_depth`` slots ahead) and runs the
  update step with the EMA learning rate (lr = 3e-8 * data_cnt_ema / (1 +
  steps * 1e-5)). On a CUDA device the step is one CUDA graph
  (``GraphedUpdateStep``; its capture or replay failing raises); on the CPU
  it is the same body on static buffers (``StaticUpdateStep``, which the
  graph captures). Metrics come back in one packed copy every 8 steps; the
  non-finite guard skips, rolls back or aborts.
* :class:`Learner`: the generator and evaluator in the main thread, the
  episode and result accounting, the epoch cadence (every
  ``update_episodes`` returned episodes past ``minimum_episodes``), the
  checkpoints (``<epoch>.ckpt``, ``latest.ckpt``: the param tree in flax's
  ``to_bytes`` layout; ``trainer_state.ckpt``: the train state in the JAX
  package's layout; each with a CRC sidecar) and resume from either
  package's files.

With ``device_generation`` and ``device_replay`` (the JAX package's
``_run_fused``: Hungry Geese in the 'solo' layout, TicTacToe in the
'turn' layout) the learner runs the fused device loop
in one thread instead (``ops/fused_pipeline.py``): each dispatch is a
rollout chunk on the env's tensor twin, its window ingest into a ring on
the device and ``sgd_steps_per_chunk`` recency-sampled update steps
(``ReplayUpdateStep``), as CUDA graphs on the card; evaluation plays whole
matches on the device (``DeviceEvaluator``); the host reads one packed
tensor a dispatch, one dispatch late (``feed_device_chunk``), and writes
the checkpoints every ``checkpoint_interval`` epochs and at the last.
The JAX learner's other device branches run with the trainer thread
(:func:`ingest_layout` picks them as the JAX learner does): with
``device_generation`` the rollout chunks run on the card
(``DeviceGenerator``, on a stream of its own) and the host splices their
episodes, or, with ``device_replay`` and an ingest layout but
``fused_pipeline: false``, hands their records to the trainer thread,
which writes their windows into the windower's ring; with
``device_replay`` and no ingest the host builds windows from whole
episodes and pushes them into ``ops/replay.DeviceReplay``. Either ring
feeds the threaded replay trainer: ``replay_fused_steps`` recency-sampled
update steps a dispatch (a CUDA graph replayed K times), reuse capped by
``max_sample_reuse``.

The run plane (handyrl_tpu/train.py's, on both loops): a ``metrics_jsonl``
row per closed epoch; the ``HANDYRL_TPU_DEADLINE`` wall-clock budget;
SIGTERM/SIGINT (``guard.PreemptionGuard``) stop the loop at its next safe
point, where :meth:`Learner.final_flush` writes the checkpoint pair once,
then a ``preempted`` row, and the CLI exits 75 (``restart_epoch: -1``
resumes); ``keep_checkpoints`` retention; the registry publish hook
(``serving.publish``); the ``init_params`` warm start; the
``HANDYRL_TPU_CHAOS`` drills (``preempt``, ``nanstep``/``nanepoch``).

Kernel launches are counted by path (``ops.launches``): 'generation' and
'evaluation' run K1's serving form in the main thread, 'training' K1's
training form, K2 and the targets' kernels in the trainer thread (in the
fused loop, all three in the main thread). The worker plane's workers
count their own launches, which reach the learner on their beacons. The
CLI prints the log lines of the JAX package's learner (and its ``fleet:``
line an epoch on the worker plane) and, at exit, one JSON line of rates,
epoch times, peak device memory, the last epoch's losses and the launches
by path (and the fused loop's dispatches, sample reuse, ring and host
seconds; the worker plane's fleet snapshot, the workers' launches and
play stats, the episodes stamped ``record_version`` and the device actor
gathers' counts). It exits 75 after a preemption flush and 1 when the trainer
or the local worker cluster failed.

Telemetry (``telemetry``, ``telemetry_port``, ``profile_epochs``,
``profile_dir``; the JAX learner's): the learner adopts the run's
telemetry block (tracing, the flight recorder, the perf plane), keeps the
alert engine (:data:`telemetry.BUILTIN_ALERTS` with the block's
overrides), merges the registry snapshots that ride the gathers' beacons
into a fleet view, and serves ``/metrics`` and ``/statusz`` on
``telemetry_port``. Each metrics row carries the registry summary, the
fleet's (``fleet_telemetry``), the alert block, the policy-lag means and
the device memory; after ``retrace_warmup_epochs`` epochs that trained
the steady-state sentinel counts any CUDA graph capture or kernel build
as a retrace. The trainer times its stages (``utils/timing.StageTimer``:
``dispatch`` is the graphed step's launch, ``host_block`` the fetch of
its losses) for the utilization proxy, and writes a ``train_step`` trace
event for the sampled episodes a batch trained on. :class:`Profiler`
wraps the epochs ``profile_epochs`` names in a ``torch.profiler`` trace
with CUDA activity, written as Chrome JSON under ``profile_dir`` or
``<trace_dir|model_dir>/profile``; ``profile_dir`` alone traces
PROFILE_STEPS update steps once.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import queue
import random
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import guard as guard_mod
from . import league as league_mod
from . import telemetry
from .config import apply_defaults, parse_epoch_set
from .environment import make_env
from .connection import RESUME_KIND, pack as conn_pack, unpack as conn_unpack
from .fault import FleetController, LedgerJournal, TaskLedger
from .generation import BatchedEvaluator, BatchedGenerator
from .model import (ModelWrapper, fp32_on_card, load_params_bytes,
                    params_bytes, param_trees, resolve_device)
from .ops import launches, reset_kernel_launches
from .ops.batch import (build_window_reference, decompress_moments,
                        make_batch, make_block_cache, select_episode,
                        stack_windows)
from .ops.graphs import CapturedCall
from .ops.replay import (DeviceReplay, resolve_windows_per_episode,
                         ring_capacity)
from .ops.shm_batch import (_SHM_SLOTS, JOB_ARG_KEYS, ArenaMap, SharedBatch,
                            batcher_process as _batcher_process,
                            batcher_process_shm as _batcher_process_shm,
                            selected_trace_ids)
from .ops.losses import LossConfig
from .models.blocks import set_compute_dtype
from .ops.train_step import (GraphedUpdateStep, ReplayUpdateStep,
                              StaticUpdateStep, TrainState, init_train_state,
                              opt_state_from_flax, opt_state_to_flax)
from .utils import flax_msgpack
from .spool import EpisodeSpool
from .streaming import ChunkAssembler, chunk_key
from .utils.fs import (append_jsonl, atomic_write_bytes,
                       checksummed_write_bytes, read_verified_bytes,
                       rotate_file, sidecar_path, verify_checkpoint)
from .utils.timing import StageTimer
from .ops.device_windows import flatten_window_keys
from .utils.tree import map_structure, map_zip
from .worker import WorkerCluster, WorkerServer, beacon_soft_faults

_LOG = telemetry.get_logger('train')

Tensor = torch.Tensor
METRICS_PER_DRAIN = 8   # update steps whose metrics come back in one copy
PROFILE_STEPS = 20      # update steps a profile_dir trace covers (no epochs)


class Profiler:
    """``torch.profiler`` traces of the training loop, each written as
    Chrome JSON to ``<directory>/profile-<run_id>-<tag>.json``: CUDA
    activity on the card (every thread's kernels, graph replays included),
    CPU activity on the host. With ``epochs`` (``profile_epochs``) the
    learner opens a trace at the boundary before each named epoch and
    closes it at that epoch's close (:meth:`epoch`); with a ``directory``
    alone the first PROFILE_STEPS update steps after the first are traced
    once (:meth:`step`, called by the trainer after its updates). A trace
    is stopped on the thread that started it (torch.profiler's sessions
    are per thread: stopping another thread's crashes the process), so
    :meth:`stop` on any other thread does nothing; the trainer closes its
    window at its thread's end."""

    def __init__(self, device: torch.device, directory: str = '',
                 epochs: frozenset = frozenset()):
        self.device = device
        self.directory = directory
        self.epochs = epochs
        self.paths: List[str] = []
        self._prof = None
        self._owner = None     # the thread that started the open trace
        self._tag = ''
        # the one-shot window: pending until the first step, then the
        # step count that closes it
        self._steps_pending = bool(directory) and not epochs
        self._stop_at = -1
        self._steps = 0        # the trainer's steps at its last call

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self, tag: str):
        from torch.profiler import ProfilerActivity, profile
        activity = (ProfilerActivity.CUDA if self.device.type == 'cuda'
                    else ProfilerActivity.CPU)
        self._prof = profile(activities=[activity])
        self._prof.start()
        self._owner = threading.get_ident()
        self._tag = tag

    def stop(self):
        """Close the open trace and write it (idempotent; a failure is
        logged, never raised); a no-op on a thread that did not start it."""
        if self._prof is None or self._owner != threading.get_ident():
            return
        prof, self._prof = self._prof, None
        try:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            prof.stop()
            os.makedirs(self.directory, exist_ok=True)
            tag = self._tag
            if tag.startswith('steps'):   # the steps it covered
                tag += '-%d' % self._steps
            path = os.path.join(self.directory, 'profile-%s-%s.json' % (
                telemetry.run_id(), tag))
            prof.export_chrome_trace(path)
        except Exception as exc:
            _LOG.warning('profiler stop failed (%s: %s)',
                         type(exc).__name__, str(exc)[:120])
            return
        self.paths.append(path)
        _LOG.info('profiler trace written to %s', path)

    def step(self, steps: int):
        """After the trainer's updates (``steps`` in all): open the
        one-shot window after the first, close it PROFILE_STEPS later."""
        self._steps = steps
        if self._steps_pending and steps > 0:
            self._steps_pending = False
            self._stop_at = steps + PROFILE_STEPS
            self.start('steps%d' % steps)
        elif 0 <= self._stop_at <= steps:
            self._stop_at = -1
            self.stop()

    def epoch(self, model_epoch: int):
        """At an epoch boundary (``model_epoch`` closed): close the open
        epoch trace, and open one when the next epoch is named."""
        if not self.epochs:
            return
        self.stop()
        if model_epoch + 1 in self.epochs:
            _LOG.info('profiling epoch %d (torch.profiler -> %s)',
                      model_epoch + 1, self.directory)
            try:
                self.start('epoch%d' % (model_epoch + 1))
            except Exception as exc:
                _LOG.warning('profiler start failed (%s: %s)',
                             type(exc).__name__, str(exc)[:120])


def ingest_layout(args: Dict[str, Any]) -> Optional[str]:
    """The device ingest's window layout, as the JAX learner chooses it
    (handyrl_tpu/train.py:2590-2606): 'solo' for a simultaneous env
    trained simultaneously, 'turn' for a turn-based env with
    ``turn_based_training``, with ``device_generation``, ``device_replay``
    and ``device_ingest`` on; None otherwise (the split generator splices
    episodes on the host)."""
    if not (args['device_generation'] and args['device_replay']
            and args['device_ingest']):
        return None
    from .environment import make_device_env
    simult = bool(getattr(make_device_env(args['env']), 'SIMULTANEOUS',
                          False))
    if simult != bool(args['turn_based_training']):
        return 'solo' if simult else 'turn'
    return None


def loss_config(args: Dict[str, Any]) -> LossConfig:
    """The update step's configuration from ``train_args``."""
    return LossConfig(
        turn_based_training=bool(args['turn_based_training']),
        observation=bool(args['observation']),
        burn_in_steps=int(args['burn_in_steps']),
        policy_target=str(args['policy_target']),
        value_target=str(args['value_target']),
        lmb=float(args['lambda']), gamma=float(args['gamma']),
        entropy_regularization=float(args['entropy_regularization']),
        entropy_regularization_decay=float(
            args['entropy_regularization_decay']),
        target_clip=float((args.get('streaming') or {})
                          .get('target_clip') or 0.0))


class Batcher:
    """Batch prefetch over the shared episode deque: each batch is
    ``batch_size`` windows selected (recency-biased) and built into one
    numpy batch.

    By default, threads (bz2 and numpy release the interpreter lock for
    their heavy parts) with one decoded block cache between them. With
    ``batcher_processes``, selection stays in this process and the builds
    fan out to spawned children (``connection.JobPool``; each child keeps
    its own cache); with ``batcher_shared_memory`` too, the children build
    into shared-memory slots and :meth:`batch` yields
    ``ops.shm_batch.SharedBatch`` views whose ``release()`` frees the slot.
    A lost child makes :meth:`batch` raise, naming it."""

    def __init__(self, args: Dict[str, Any], episodes: deque,
                 timer: Optional[StageTimer] = None):
        self.args = args
        self.episodes = episodes
        self.timer = timer
        self.cache = make_block_cache(args)
        # policy-lag accounting at window selection (the consumption
        # point): epochs between the learner and the model that played the
        # episode, and seconds since the learner received it. The learner
        # installs ``epoch_fn`` (it owns the model epoch)
        self.epoch_fn = None
        self._m_lag = telemetry.histogram(
            'policy_lag_epochs', buckets=telemetry.LAG_EPOCH_BUCKETS)
        self._m_age = telemetry.histogram(
            'sample_age_seconds', buckets=telemetry.AGE_SECOND_BUCKETS)
        self.output_queue: queue.Queue = queue.Queue(maxsize=8)
        self.stop_flag = False
        self._threads: List[threading.Thread] = []
        self._pool = None
        self._arena_map = None
        # per child: (spec, segment names) from its first descriptor
        self._shm_layouts: Dict[int, tuple] = {}
        self._shm_slots_used: set = set()
        self.shm_batches = 0
        if args.get('batcher_shared_memory'):
            self.mode = 'shared_memory'
        elif args.get('batcher_processes'):
            self.mode = 'processes'
        else:
            self.mode = 'threads'

    def run(self):
        if self._threads or self._pool is not None:
            return
        n = self.args['num_batchers']
        if self.mode != 'threads':
            from .connection import JobPool
            if self.mode == 'shared_memory':
                self._arena_map = ArenaMap()
                self._pool = JobPool(_batcher_process_shm, self._selector(),
                                     n, transform=self._map_shm,
                                     name='batcher process')
            else:
                self._pool = JobPool(_batcher_process, self._selector(), n,
                                     name='batcher process')
            self._pool.start()
            print('batcher processes: %d spawned (%s)' % (
                n, 'shared-memory batches, %d slots each' % _SHM_SLOTS
                if self.mode == 'shared_memory' else 'pickled batches'))
            return
        for i in range(n):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name='batcher-%d' % i, daemon=True)
            t.start()
            self._threads.append(t)

    def _select(self) -> List[dict]:
        t0 = time.perf_counter()
        selected = [select_episode(self.episodes, self.args)
                    for _ in range(self.args['batch_size'])]
        if self.timer is not None:
            self.timer.add('select', time.perf_counter() - t0)
        self._observe_lag(selected)
        return selected

    def _observe_lag(self, selected: List[dict]):
        fn = self.epoch_fn
        if fn is None or not telemetry.enabled():
            return
        epoch, now = int(fn()), time.time()
        for sel in selected:
            for mid in ((sel.get('args') or {}).get('model_id')
                        or {}).values():
                if mid is not None and mid >= 0:
                    self._m_lag.observe(max(0, epoch - int(mid)))
            rt = sel.get('recv_time')
            if rt is not None:
                self._m_age.observe(max(0.0, now - float(rt)))

    def _selector(self):
        """The process pool's jobs: selected windows and the args a
        child's ``make_batch`` reads."""
        job_args = {k: self.args[k] for k in JOB_ARG_KEYS}
        while not self.stop_flag:
            try:
                selected = self._select()
            except (IndexError, ValueError):   # buffer transiently empty
                time.sleep(0.1)
                continue
            yield selected, job_args

    def _map_shm(self, desc: Dict[str, Any]) -> SharedBatch:
        """A child's slot descriptor as a mapped :class:`SharedBatch` (on
        the pool's dispatcher thread)."""
        bid, slot = desc['bid'], desc['slot']
        if 'spec' in desc:
            self._shm_layouts[bid] = (desc['spec'], desc['names'])
        spec, names = self._shm_layouts[bid]
        views = self._arena_map.attach(names[slot], spec)
        self._shm_slots_used.add((bid, slot))
        self.shm_batches += 1
        pool = self._pool
        return SharedBatch(views,
                           lambda: pool.send_to(bid, ('__free__', slot)),
                           trace_ids=desc.get('trace'))

    def _worker(self, bid: int):
        _LOG.info('started batcher %d', bid)
        while not self.stop_flag:
            try:
                selected = self._select()
                batch = make_batch(selected, self.args, cache=self.cache)
            except (IndexError, ValueError):   # buffer transiently empty
                time.sleep(0.1)
                continue
            # the trace ids ride the batch as a shared-memory batch's do
            batch = SharedBatch(batch, None, trace_ids=(
                selected_trace_ids(selected)
                if telemetry.trace_enabled() else None))
            while not self.stop_flag:
                try:
                    self.output_queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def batch(self, timeout: Optional[float] = None):
        """The next batch: a :class:`SharedBatch` (its ``trace_ids`` the
        sampled episode trace ids of its windows while tracing), or a dict
        of numpy arrays from pickling batcher processes; ``queue.Empty``
        after ``timeout``."""
        if self._pool is not None:
            telemetry.gauge('batcher_queue_depth').set(
                self._pool.results.qsize())
            return self._pool.recv(timeout)
        telemetry.gauge('batcher_queue_depth').set(self.output_queue.qsize())
        return self.output_queue.get(timeout=timeout)

    def shm_summary(self) -> Dict[str, Any]:
        """What the shared-memory path did: its segments' names (each child
        unlinks its own at exit), the slots used and the batches mapped."""
        names = sorted(n for _, ns in self._shm_layouts.values() for n in ns)
        return {'segments': names, 'slots_used': len(self._shm_slots_used),
                'slots_per_batcher': _SHM_SLOTS, 'batches': self.shm_batches}

    def stop(self):
        """Stop the threads, or the children (each unlinks its segments as
        it exits). The trainer's mappings stay open: it may still be
        copying a mapped batch, and unlinking a name leaves the pages
        mapped until then."""
        self.stop_flag = True
        for t in self._threads:
            t.join(timeout=5)
        if self._pool is not None:
            self._pool.close()


class _Slot:
    """One staged batch: pinned host buffers, their device copies, and
    the events of its upload (on the copy stream) and of the step that
    read it (on the step's stream)."""

    def __init__(self, batch: Dict[str, np.ndarray], device: torch.device):
        self.host = {k: torch.empty_like(torch.from_numpy(v),
                                         pin_memory=True)
                     for k, v in batch.items()}
        self.device = {k: torch.empty_like(t, device=device)
                       for k, t in self.host.items()}
        self.uploaded = torch.cuda.Event()
        self.consumed = torch.cuda.Event()


class _DeviceStager:
    """A ring of :class:`_Slot` s that uploads batches on a copy stream
    ahead of the update step (the JAX trainer's ``prefetch_depth`` ring).
    A slot's host buffers are rewritten only after its last upload
    finished, and its device buffers only after the step that read them;
    the step's stream waits for the upload. Every call is made on the
    trainer thread."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.depth = depth
        self.stream = torch.cuda.Stream(device)
        self.slots: List[_Slot] = []
        self._next = 0

    def stage(self, batch: Dict[str, np.ndarray]) -> _Slot:
        if not self.slots:
            self.slots = [_Slot(batch, self.device)
                          for _ in range(self.depth)]
        slot = self.slots[self._next]
        self._next = (self._next + 1) % self.depth
        slot.uploaded.synchronize()
        for k, v in batch.items():
            np.copyto(slot.host[k].numpy(), v)
        self.stream.wait_event(slot.consumed)
        with torch.cuda.stream(self.stream):
            for k, t in slot.device.items():
                t.copy_(slot.host[k], non_blocking=True)
            slot.uploaded.record(self.stream)
        return slot

    def take(self, slot: _Slot) -> Dict[str, Tensor]:
        torch.cuda.current_stream(self.device).wait_event(slot.uploaded)
        return slot.device

    def release(self, slot: _Slot):
        slot.consumed.record(torch.cuda.current_stream(self.device))


class Trainer:
    """The SGD loop thread: the update step on static buffers (a CUDA graph
    on the card) fed by the batchers, with the EMA learning-rate schedule.
    ``module`` is the net on the training device; its parameters are the
    initial state."""

    def __init__(self, args: Dict[str, Any], module: torch.nn.Module):
        self.args = args
        self.module = module
        self.device = next(module.parameters()).device
        self.episodes: deque = deque()
        self.cfg = loss_config(args)
        self.default_lr = 3e-8
        # the IMPACT target network (streaming.target_clip > 0;
        # handyrl_tpu/train.py:401-416): buffers of the update step,
        # refreshed every target_sync_epochs epochs and after a load or a
        # rollback, never checkpointed. The replay trainers have no target
        # variant, so device_replay ignores the knob, as the JAX trainer
        # does
        stm = args.get('streaming') or {}
        self.use_target = self.cfg.target_clip > 0
        if self.use_target and args.get('device_replay'):
            _LOG.warning('streaming.target_clip is ignored in device_replay '
                         'mode (the fused trainer has no target variant)')
            self.use_target = False
            self.cfg = self.cfg._replace(target_clip=0.0)
        self.target_sync_epochs = max(
            1, int(stm.get('target_sync_epochs') or 1))
        self._target_age_epochs = 0
        self._target_stale = True      # synced at the next epoch's start
        # the device ring (device_replay): the fused loop's pipeline binds
        # the K-step update to its ring (ops/fused_pipeline.py); the
        # threaded replay trainer binds it at its first dispatch to the
        # windower's ring (device ingest) or to the ring the host pushes
        # windows into (DeviceReplay)
        self.replay: Optional[DeviceReplay] = None
        self.windower = None    # installed by the learner for device ingest
        self.seen_episodes = 0  # episodes of device ingest (no host deque)
        if args.get('device_replay'):
            # the 'turn' ring holds the compact layout, so the loss runs
            # with observation=False there (the JAX learner's device_cfg)
            self.device_cfg = (self.cfg._replace(observation=False)
                               if ingest_layout(args) == 'turn' else self.cfg)
            self.update_step = ReplayUpdateStep(
                module, self.device_cfg, init_train_state(module),
                self.default_lr)
            self.replay = DeviceReplay(ring_capacity(args), self.device)
            self.fused_steps = int(args['replay_fused_steps'])
            self.replay_stats = {'dropped_episodes': 0,
                                 'windows_ingested': 0, 'samples_drawn': 0}
            self.ingest_queue: queue.Queue = queue.Queue(maxsize=1024)
            self.chunk_queue: queue.Queue = queue.Queue(maxsize=4)
            self._pending_rows: List[Dict[str, Any]] = []
            self._ring = None          # the windower's ring and history
            self._ring_ready = False
            self._ring_size_host = 0
            self._windows_pending = 0
            self._bound = False
            self._ingest_generator = torch.Generator(
                device=self.device).manual_seed(args['seed'] + 2)
            self._slot_generator = torch.Generator(
                device=self.device).manual_seed(args['seed'] + 1)
        else:
            step_cls = (GraphedUpdateStep if self.device.type == 'cuda'
                        else StaticUpdateStep)
            self.update_step = step_cls(module, self.cfg,
                                        init_train_state(module))
        self.data_cnt_ema = args['batch_size'] * args['forward_steps']
        self.steps = 0
        # the ingest path's seconds by stage (select, ipc, h2d, dispatch,
        # host_block), mirrored into the stage_seconds histograms; an
        # epoch's feed the utilization proxy and, with
        # HANDYRL_TPU_TIMING=1, a timing line
        self.ingest_timer = StageTimer(registry=telemetry.REGISTRY)
        self.batcher = Batcher(args, self.episodes, timer=self.ingest_timer)
        self.prefetch_depth = max(1, int(args.get('prefetch_depth') or 1))
        self._stager = (_DeviceStager(self.device, self.prefetch_depth)
                        if self.device.type == 'cuda' else None)
        # (staged batch, the sampled episode trace ids of its windows)
        self._staged: deque = deque()
        self.update_flag = False
        self.update_queue: queue.Queue = queue.Queue(maxsize=1)
        self._loss_sum: Dict[str, float] = {}
        self.last_losses: Dict[str, float] = {}
        self.shutdown_flag = False
        self.failed = False
        self.failed_reason = ''
        # the step counter and wall clock when training started and
        # stopped, and the seconds spent waiting for the batchers, for rates
        self.steps_at_start = 0
        self.train_started_at: Optional[float] = None
        self.first_step_at: Optional[float] = None   # wall clock
        self.train_stopped_at: Optional[float] = None
        self.batch_wait_seconds = 0.0
        self.guard = guard_mod.NonFiniteGuard(args.get('guard') or {})
        # HANDYRL_TPU_CHAOS nanstep/nanepoch/nanburst: a NaN lr on the
        # updates of the drill's window
        self.chaos_nan = guard_mod.ChaosNaN()
        # the epoch's SGD steps/s and learning dynamics (the diag_* sums
        # reduced), for the metrics rows
        self.last_steps_per_sec = 0.0
        self._diag_sum: Dict[str, float] = {}
        self.last_dynamics: Dict[str, float] = {}
        # installed by the Learner, which owns the checkpoint files
        self.rollback_source = None
        self.rollback_epoch: Optional[int] = None
        # the learner's torch.profiler traces (a no-op until it installs
        # its own): the trainer marks its step boundaries
        self.profile = Profiler(self.device)

    def _lr(self) -> float:
        return self.default_lr * self.data_cnt_ema / (1 + self.steps * 1e-5)

    # -- the state, in the JAX package's checkpoint layout ---------------
    def host_params(self) -> Dict[str, Tensor]:
        """CPU copies of the current parameters. Call it on the trainer
        thread (or with the trainer stopped): the copies wait for the
        step's stream, and the next step overwrites the buffers."""
        return {k: v.detach().cpu().clone()
                for k, v in self.update_step.state.params.items()}

    def state_bytes(self) -> bytes:
        """The JAX trainer's ``trainer_state.ckpt`` bytes: flax's
        ``to_bytes`` of ``{'state': TrainState, 'steps', 'data_cnt_ema'}``
        with the Adam state in optax's chain layout (two empty states
        before ``ScaleByAdamState``)."""
        to_flax, _ = param_trees(self.module)
        st = self.update_step.state
        payload = {
            'state': {'params': to_flax(st.params),
                      'opt_state': {'0': {}, '1': {},
                                    '2': opt_state_to_flax(st.opt_state,
                                                           to_flax)},
                      'steps': np.asarray(int(st.steps), np.int32)},
            'steps': self.steps, 'data_cnt_ema': self.data_cnt_ema}
        return flax_msgpack.to_bytes(payload)

    def load_state_bytes(self, raw: bytes):
        """Restore :meth:`state_bytes` of either package in place; a bad
        payload raises and leaves the state as it was."""
        _, from_flax = param_trees(self.module)
        payload = flax_msgpack.from_bytes(raw)
        st = payload['state']
        adam = st['opt_state']['2']
        dev = self.device
        state = TrainState(
            params={k: v.to(dev) for k, v in from_flax(st['params']).items()},
            opt_state=opt_state_from_flax(adam['count'], adam['mu'],
                                          adam['nu'], from_flax, dev),
            steps=torch.tensor(int(st['steps']), dtype=torch.int32,
                               device=dev))
        steps, ema = int(payload['steps']), float(payload['data_cnt_ema'])
        self.update_step.load_state(state)
        self.steps, self.data_cnt_ema = steps, ema
        # the target is not part of the checkpoint: the next epoch
        # re-syncs it from the loaded params
        self._target_stale = True

    def update(self, timeout: Optional[float] = None):
        """Called by the learner at each epoch boundary; blocks until the
        trainer hands over (params on the host, steps, the state's bytes),
        made on its thread after the epoch's last step."""
        self.update_flag = True
        return self.update_queue.get(timeout=timeout)

    # -- the loop ----------------------------------------------------------
    def _stage(self, batch):
        """A batch staged for its step: on the card, copied into a staging
        slot's pinned buffers (a shared-memory batch is released right
        after that copy); on the CPU, the batch itself."""
        if self._stager is None:
            return batch
        if isinstance(batch, SharedBatch):
            try:
                return self._stager.stage(flatten_window_keys(batch.batch))
            finally:
                batch.release()
        return self._stager.stage(flatten_window_keys(batch))

    def _step(self, staged) -> Dict[str, Tensor]:
        lr_val = self._lr()
        if self.chaos_nan.due(self.steps):
            _LOG.warning('chaos: injecting non-finite update at step %d',
                         self.steps)
            lr_val = float('nan')
        lr = torch.full((), lr_val, dtype=torch.float32, device=self.device)
        if self._stager is None:
            shared = isinstance(staged, SharedBatch)
            try:
                return self.update_step(
                    {k: torch.from_numpy(v) for k, v in flatten_window_keys(
                        staged.batch if shared else staged).items()}, lr)
            finally:
                if shared:   # the CPU step has read the mapped pages
                    staged.release()
        metrics = self.update_step(self._stager.take(staged), lr)
        self._stager.release(staged)
        return metrics

    def train(self) -> Dict[str, Tensor]:
        """One epoch: steps until the learner asks for the update (and at
        least one batch's metrics are in). Returns the host params."""
        if self.replay is not None:
            return self._train_replay()
        batch_cnt, data_cnt = 0, 0
        pending: List[Dict[str, Tensor]] = []
        staged = self._staged
        timer = self.ingest_timer
        epoch_t0 = time.time()
        if self.use_target and (
                self._target_stale
                or self._target_age_epochs >= self.target_sync_epochs):
            # copy_ into the step's target buffers: no new capture
            self.update_step.sync_target()
            self._target_age_epochs = 0
            self._target_stale = False

        def top_up():
            while len(staged) < self.prefetch_depth:
                t0 = time.perf_counter()
                try:
                    nxt = self.batcher.batch(timeout=1.0)
                except queue.Empty:
                    break
                finally:
                    dt = time.perf_counter() - t0
                    self.batch_wait_seconds += dt
                    timer.add('ipc', dt)
                t0 = time.perf_counter()
                staged.append((self._stage(nxt),
                               getattr(nxt, 'trace_ids', None)))
                timer.add('h2d', time.perf_counter() - t0)

        while ((data_cnt == 0 or not self.update_flag)
               and not self.shutdown_flag):
            if not staged:
                top_up()
                if not staged:
                    continue
            batch, batch_tids = staged.popleft()
            t_wall = time.time()
            t0 = time.perf_counter()
            metrics = self._step(batch)
            dt = time.perf_counter() - t0
            timer.add('dispatch', dt)
            if batch_tids:
                # the gradient end of the episode trace: one event an
                # update, naming every sampled episode its windows came from
                telemetry.trace_event('train_step', ts=t_wall, dur=dt,
                                      always=True, trace_ids=batch_tids,
                                      steps=self.steps)
            if self.first_step_at is None:
                self.first_step_at = time.time()
            # the next uploads are staged while the step runs on the device
            top_up()
            pending.append(metrics)
            batch_cnt += 1
            if len(pending) >= METRICS_PER_DRAIN:
                data_cnt += self._drain_metrics(pending)
                pending = []
            self.steps += 1
            self.profile.step(self.steps)
        if pending:
            data_cnt += self._drain_metrics(pending)

        self._close_epoch(batch_cnt, data_cnt, epoch_t0)
        return self.host_params()

    def _close_epoch(self, batch_cnt: int, data_cnt: int, epoch_t0: float):
        """The epoch's loss line, lr EMA, step rate and dynamics."""
        if batch_cnt > 0:   # zero only when interrupted by shutdown
            loss_sum, self._loss_sum = self._loss_sum, {}
            self.last_losses = {k: l / max(data_cnt, 1)
                                for k, l in loss_sum.items()}
            print('loss = %s' % ' '.join(
                [k + ':' + '%.3f' % v for k, v in self.last_losses.items()]))
            self.data_cnt_ema = (self.data_cnt_ema * 0.8
                                 + data_cnt / (1e-2 + batch_cnt) * 0.2)
            self.last_steps_per_sec = batch_cnt / max(time.time() - epoch_t0,
                                                      1e-9)
            if self.use_target:
                self._target_age_epochs += 1
            self.last_dynamics = self._epoch_dynamics(loss_sum, data_cnt,
                                                      batch_cnt)
            # the epoch's stage seconds feed the utilization proxy
            # (host_block over the ingest path's total)
            line = self.ingest_timer.snapshot(reset=True)
            util = telemetry.utilization_from_stages(line)
            telemetry.set_utilization_proxy(util)
            if os.environ.get('HANDYRL_TPU_TIMING') == '1':
                if util is not None:
                    line['util'] = round(util, 4)
                if self.last_dynamics:
                    line['dynamics'] = self.last_dynamics
                print('ingest timing: %s' % json.dumps(line))

    # -- the threaded replay trainer (device_replay without the fused loop)
    PUSH_CHUNK = 8   # windows a host push (the JAX package's fixed size)

    def _train_replay(self) -> Dict[str, Tensor]:
        """One epoch of the threaded replay trainer (handyrl_tpu/train.py:
        696-770): each dispatch is ``replay_fused_steps`` recency-sampled
        update steps on the device ring (``ReplayUpdateStep``, a CUDA graph
        replayed K times on the card), after ingesting what arrived: rollout
        chunks through the windower (device ingest) or host-built windows
        pushed to :class:`DeviceReplay`. ``max_sample_reuse`` holds samples
        drawn to at most cap x windows ingested, except for an epoch that
        waits to close. The seconds it waits for data (an empty ring, or
        the cap) count as ``batch_wait_seconds``."""
        batch_cnt, data_cnt = 0, 0
        pending: List[Tensor] = []
        epoch_t0 = time.time()
        B, K = self.args['batch_size'], self.fused_steps
        cap = self.args.get('max_sample_reuse')
        stats = self.replay_stats
        while ((data_cnt == 0 or not self.update_flag)
               and not self.shutdown_flag):
            t0 = time.perf_counter()
            if not self._replay_ready():
                time.sleep(0.02)
                self.batch_wait_seconds += time.perf_counter() - t0
                continue
            # never throttle an epoch that is waiting to close: the loop
            # must make a dispatch an epoch to hand back
            if cap and not self.update_flag and (
                    stats['samples_drawn'] + B * K
                    > float(cap) * max(1, stats['windows_ingested'])):
                time.sleep(0.01)
                self.batch_wait_seconds += time.perf_counter() - t0
                continue
            ema = self.data_cnt_ema
            if self.chaos_nan.due(self.steps, K):
                _LOG.warning('chaos: injecting non-finite update at step %d',
                             self.steps)
                ema = float('nan')   # a NaN lr on the graphed steps
            t0 = time.perf_counter()
            pending.append(self.update_step.run(K, ema).clone())
            self.ingest_timer.add('dispatch', time.perf_counter() - t0)
            stats['samples_drawn'] += B * K
            batch_cnt += K
            self.steps += K
            self.profile.step(self.steps)
            # one copy of the metrics every 4 dispatches, at once when an
            # epoch waits to close
            if len(pending) >= 4 or self.update_flag:
                data_cnt += self._drain_metrics(
                    [self.update_step.unpack(m) for m in pending], K)
                pending = []
        if pending:
            data_cnt += self._drain_metrics(
                [self.update_step.unpack(m) for m in pending], K)
        self._close_epoch(batch_cnt, data_cnt, epoch_t0)
        return self.host_params()

    def _replay_ready(self) -> bool:
        """Ingest what arrived; bind the update step to the ring at the
        first dispatch (the ring's window shapes are known only after the
        first windows). False while the ring holds nothing."""
        if self.windower is not None:
            self._ingest_device_chunks()
            if not self._ring_ready:
                return False
            ring, spec = self._ring, self.windower.window_spec
            size, cursor, capacity = (self._size, self._cursor,
                                      self.windower.capacity)
        else:
            self._ingest_new_episodes()
            if self.replay.size == 0:
                return False
            ring, spec = self.replay.buffers, self.replay.window_spec
            size, cursor = self.replay.size_t, self.replay.cursor_t
            capacity = self.replay.capacity
        if not self._bound:
            self.update_step.bind(ring, spec, size, cursor, capacity,
                                  self.args['batch_size'],
                                  self._slot_generator)
            self._bound = True
        return True

    def _ingest_device_chunks(self):
        """Drain rollout chunks (:class:`~..device_generation.DeviceChunk`)
        into the windower's ring, at most 8 a call. The first chunk
        allocates the history and the ring from its shapes. Each chunk is
        copied into static input tensors after its ready event, and the
        ingest runs as one CUDA graph on the card (``CapturedCall``; its
        window draws from a registered generator); the windows it wrote
        are summed on the device and read at startup, every 8 chunks, or
        on every call when ``max_sample_reuse`` needs them current."""
        ingested = 0
        while ingested < 8:
            try:
                chunk = self.chunk_queue.get_nowait()
            except queue.Empty:
                break
            ingested += 1
            self._ingest_chunk(chunk)
        self._windows_pending += ingested
        if self._windows_pending and (not self._ring_ready
                                      or self._windows_pending >= 8
                                      or self.args.get('max_sample_reuse')):
            self._windows_pending = 0
            total = int(self._windows_total.item())
            new = total - self.replay_stats['windows_ingested']
            self.replay_stats['windows_ingested'] = total
            self._ring_size_host = min(self._ring_size_host + new,
                                       self.windower.capacity)
            if total > 0:
                self._ring_ready = True

    def _ingest_chunk(self, chunk):
        records = chunk.records
        if chunk.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(chunk.ready)
            map_structure(lambda t: t.record_stream(stream), records)
        if self._ring is None:
            w, dev = self.windower, self.device
            self._wstate = w.init_state(records)
            self._ring = w.init_ring(records)
            self._cursor = torch.zeros((), dtype=torch.int64, device=dev)
            self._size = torch.zeros((), dtype=torch.int64, device=dev)
            self._windows_total = torch.zeros((), dtype=torch.int64,
                                              device=dev)
            self._chunk_in = map_structure(torch.empty_like, records)
            self._ingest_call = CapturedCall(self._ingest_static, dev,
                                             [self._ingest_generator])
        map_zip(lambda d, v: d.copy_(v), self._chunk_in, records)
        self._ingest_call()

    def _ingest_static(self):
        _, n_win = self.windower.ingest(self._chunk_in, self._wstate,
                                        self._ring, self._cursor, self._size,
                                        self._ingest_generator)
        self._windows_total.add_(n_win)

    def ring_occupancy(self) -> float:
        if self.replay is None:
            return 0.0
        if self.windower is not None:
            return self._ring_size_host / self.windower.capacity
        return self.replay.size / self.replay.capacity

    def _ingest_new_episodes(self):
        """Window freshly generated episodes and push them into the ring
        (handyrl_tpu/train.py:890-918): each episode decompressed once,
        about steps / forward_steps windows at uniform train starts, pushed
        :attr:`PUSH_CHUNK` at a time."""
        ingested = 0
        fs, bi = self.args['forward_steps'], self.args['burn_in_steps']
        while ingested < 64:
            try:
                ep = self.ingest_queue.get_nowait()
            except queue.Empty:
                break
            ingested += 1
            moments = decompress_moments(ep['moment'])
            for _ in range(max(1, ep['steps'] // fs)):
                train_st = random.randrange(1 + max(0, ep['steps'] - fs))
                st = max(0, train_st - bi)
                ed = min(train_st + fs, ep['steps'])
                meta = {'outcome': ep['outcome'], 'start': st, 'end': ed,
                        'train_start': train_st, 'total': ep['steps']}
                self._pending_rows.append(
                    build_window_reference(moments[st:ed], meta, self.args))
        while len(self._pending_rows) >= self.PUSH_CHUNK:
            chunk = self._pending_rows[:self.PUSH_CHUNK]
            self._pending_rows = self._pending_rows[self.PUSH_CHUNK:]
            self.replay.push(stack_windows(chunk))
            self.replay_stats['windows_ingested'] += self.PUSH_CHUNK

    def _epoch_dynamics(self, loss_sum: Dict[str, float], data_cnt: int,
                        n_updates: int) -> Dict[str, float]:
        """The epoch's learning dynamics from the summed ``diag_*`` metrics
        (handyrl_tpu/train.py:950-985): V-Trace rho/c clip fractions,
        importance-ratio mean and std, entropy per acting sample and the
        mean pre-clip grad norm a step."""
        d, self._diag_sum = self._diag_sum, {}
        dc, nu = max(1, data_cnt), max(1, n_updates)
        out: Dict[str, float] = {}
        if 'ent' in loss_sum:
            out['entropy'] = loss_sum['ent'] / dc
        if 'diag_rho_clip' in d:
            out['rho_clip_fraction'] = d['diag_rho_clip'] / dc
            out['c_clip_fraction'] = d.get('diag_c_clip', 0.0) / dc
        if 'diag_rho_sum' in d:
            mean = d['diag_rho_sum'] / dc
            out['importance_ratio_mean'] = mean
            var = max(0.0, d.get('diag_rho_sq_sum', 0.0) / dc - mean * mean)
            out['importance_ratio_std'] = var ** 0.5
        if 'diag_target_clip' in d:
            # the IMPACT target's clip fraction, mean target / behavior
            # ratio and mean current-vs-target log-prob gap
            out['target_clip_fraction'] = d['diag_target_clip'] / dc
            out['target_ratio_mean'] = (
                d.get('diag_target_ratio_sum', 0.0) / dc)
            out['target_gap_mean'] = d.get('diag_target_gap_sum', 0.0) / dc
        if 'diag_grad_norm' in d:
            out['grad_norm'] = d['diag_grad_norm'] / nu
        out = {k: round(float(v), 6) for k, v in out.items()}
        for k, v in out.items():
            telemetry.gauge(k).set(v)
        return out

    def _drain_metrics(self, pending: List[Dict[str, Tensor]],
                       per_entry: int = 1) -> int:
        """Bring the queued metric dicts to the host in one copy and fold
        them into the epoch's loss sums; returns the summed data count.
        The 'nonfinite' counts go to the guard; an entry sums
        ``per_entry`` update steps."""
        names = list(pending[0])
        t0 = time.perf_counter()    # the host waits on the card here
        rows = torch.stack([torch.stack([m[k] for k in names])
                            for m in pending]).cpu().numpy()
        self.ingest_timer.add('host_block', time.perf_counter() - t0)
        data_cnt = bad = 0
        total_sum = 0.0
        for row in rows:
            for k, v in zip(names, row):
                if k == 'data_count':
                    data_cnt += int(v)
                elif k == 'nonfinite':
                    bad += int(v)
                elif k.startswith('diag_'):
                    self._diag_sum[k] = self._diag_sum.get(k, 0.0) + float(v)
                else:
                    if k == 'total':
                        total_sum += float(v)
                    self._loss_sum[k] = self._loss_sum.get(k, 0.0) + float(v)
        self._guard_observe(bad, len(pending) * per_entry - bad,
                            total_sum / data_cnt if data_cnt else None)
        return data_cnt

    def _guard_observe(self, bad: int, good: int,
                       loss_mean: Optional[float] = None):
        """Skip is counted, rollback restores the last good checkpoint in
        place, abort raises (run() turns that into the failed path)."""
        if bad:
            telemetry.counter('guard_nonfinite_total').inc(bad)
        action = self.guard.observe(bad, good, loss_mean)
        if action == 'abort':
            raise RuntimeError('guard: %d non-finite update(s) under '
                               'nonfinite_policy=abort' % bad)
        if action == 'rollback':
            self._do_rollback()
        elif bad:
            _LOG.warning('guard: skipped %d non-finite update(s) '
                         '(%d consecutive)', bad, self.guard.consecutive)

    def _do_rollback(self):
        """Restore the last good checkpoint's train state in place and hand
        the model-epoch rewind to the learner (``rollback_epoch``)."""
        src = self.rollback_source() if self.rollback_source else None
        if src is None:
            _LOG.error('guard: rollback tripped but no valid checkpoint '
                       'exists yet; continuing with skipped updates')
            self.guard.reset_streak()
            return
        epoch, blob = src
        self.load_state_bytes(blob)
        self.guard.reset_streak()
        self.guard.rollbacks += 1
        self.rollback_epoch = epoch
        telemetry.counter('guard_rollbacks_total').inc()
        _LOG.error('guard: non-finite training burst, rolled back to '
                   'checkpoint epoch %d (steps %d)', epoch, self.steps)

    def run(self):
        # the threaded replay trainer runs on a stream of its own beside the
        # generator's; the host trainer on the default stream
        stream = (torch.cuda.stream(torch.cuda.Stream(self.device))
                  if self.replay is not None and self.device.type == 'cuda'
                  else contextlib.nullcontext())
        with launches.path('training'), stream:
            try:
                self._run()
            finally:
                self.profile.stop()   # the window this thread opened

    def _run(self):
        _LOG.info('waiting training')
        minimum = self.args['minimum_episodes']
        while (len(self.episodes) < minimum
               and self.seen_episodes < minimum
               and not self.shutdown_flag):
            if self.windower is not None:
                # the generator blocks on the chunk queue (the histories
                # follow a contiguous ply stream), so the ring fills during
                # the warm-up too
                self._ingest_device_chunks()
            time.sleep(0.1)
        if not self.shutdown_flag:
            if self.replay is None:
                self.batcher.run()
            self.steps_at_start = self.steps
            self.train_started_at = time.time()
            _LOG.info('started training')
        while not self.shutdown_flag:
            try:
                if not self.failed:
                    params = self.train()
                    state_blob = self.state_bytes()
                else:
                    time.sleep(0.5)
                    params, state_blob = None, None
            except Exception as exc:
                # deliver (None, ...) instead of deadlocking the learner,
                # which blocks on update_queue at every epoch boundary
                traceback.print_exc()
                self.failed = True
                self.failed_reason = '%s: %s' % (type(exc).__name__,
                                                 str(exc)[:300])
                params, state_blob = None, None
            self.update_flag = False
            while not self.shutdown_flag:
                try:
                    self.update_queue.put((params, self.steps, state_blob),
                                          timeout=0.5)
                    break
                except queue.Full:
                    continue
        self.train_stopped_at = time.time()

    def shutdown(self):
        self.shutdown_flag = True
        self.batcher.stop()

    def release(self):
        """Drop the update step (its CUDA graphs and buffers) and the staged
        batches, once the thread has stopped."""
        for staged, _tids in self._staged:
            if isinstance(staged, SharedBatch):
                staged.release()
        self._staged.clear()
        self._stager = None
        self.update_step = None
        if self.replay is not None:
            self.replay.buffers = {}
            self._ring = self._wstate = self._chunk_in = None
            self._ingest_call = None
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)


def record_soft_faults(fleet: FleetController, peer_info: Dict[Any, Any],
                       host_of: Dict[Any, str], seen: Dict[Any, int]) -> None:
    """The JAX learner's soft-fault rule (handyrl_tpu/train.py:3116-3135)
    read from the port's beacons: each peer's engine restarts plus its
    workers' failovers, as a delta over what ``seen`` holds of that
    endpoint, become soft faults of its host. A count below the last one
    is a restarted process: nothing is recorded, the count starts over."""
    for ep, info in peer_info.items():
        if not isinstance(info, dict) or ep not in host_of:
            continue
        cur = beacon_soft_faults(info)
        prev = seen.get(ep, 0)
        if cur > prev:
            fleet.record_soft_fault(host_of[ep], cur - prev)
        seen[ep] = cur


class _EpochCadence:
    """An epoch is due every ``update_episodes`` returned episodes past the
    warmup minimum."""

    def __init__(self, args: Dict[str, Any]):
        self._next = args['minimum_episodes'] + args['update_episodes']
        self._step = args['update_episodes']

    def due(self, returned_episodes: int) -> bool:
        if returned_episodes >= self._next:
            self._next += self._step
            return True
        return False


class Learner:
    """The learner: model, generation and evaluation (or the worker plane's
    server) in this thread, the trainer thread, episode and result
    accounting, epoch cadence and checkpoints. ``net`` defaults to the
    env's net with weights drawn from ``seed``; ``device`` to the card
    (without one it raises). ``remote`` serves worker hosts over TCP
    instead of generating in this process."""

    def __init__(self, args: Dict[str, Any], net: Optional[torch.nn.Module]
                 = None, device: Any = 'cuda', remote: bool = False):
        train_args = dict(args['train_args'])
        train_args['env'] = dict(args['env_args'])
        args = train_args
        self.args = args
        self.device = resolve_device(device)
        random.seed(args['seed'])
        # telemetry (handyrl_tpu/train.py:1113-1145): one identity for
        # every record of the run (a restarted durable learner adopts its
        # run's from the resume token), the collection switch, tracing,
        # the flight recorder and the perf plane, all mirrored into the
        # environment for the processes this learner spawns
        tel = telemetry.config_block(args)
        if not tel['enabled']:
            telemetry.set_enabled(False)
        args.setdefault('run_id', telemetry.run_id())
        telemetry.set_run_id(args['run_id'])
        telemetry.set_process_label('learner')
        telemetry.configure_tracing(tel.get('trace_dir') or None,
                                    tel.get('trace_sample_rate'))
        telemetry.configure_recorder(tel.get('recorder_events'),
                                     tel.get('blackbox_dir'))
        if telemetry.enabled():
            telemetry.install_crash_dump()
        telemetry.configure_perf_plane(tel.get('perf_plane'),
                                       tel.get('retrace'))
        self._retrace_warmup = int(tel.get('retrace_warmup_epochs', 1))
        # epochs whose close found the trainer's steps advanced, and its
        # steps at the last close: warm-up counts epochs that trained
        self._trained_epochs = 0
        self._steps_at_last_row = 0
        # the built-in alert catalog with the block's overrides, evaluated
        # by the server loop, the metrics rows and /statusz through one
        # cadence-gated stream (None with alerting off)
        self._alerts = telemetry.AlertEngine.from_config(args)
        self._metrics_rotate_mb = float(tel.get('metrics_rotate_mb') or 0)
        self._last_fleet_telemetry: Optional[dict] = None
        self._exporter: Optional[telemetry.TelemetryExporter] = None
        # the lag histograms' (sum, count) at the last epoch's read
        self._lag_marks: Dict[str, tuple] = {}
        self._trace_file: Optional[str] = None   # the collated trace

        self.env = make_env(args['env'])
        eval_modify_rate = ((args['update_episodes'] ** 0.85)
                            / args['update_episodes'])
        self.eval_rate = max(args['eval_rate'], eval_modify_rate)
        self.shutdown_flag = False
        # the run plane (handyrl_tpu/train.py:1155-1166,1369-1379): the
        # preemption flag, the chaos drills, the one final flush, the
        # metrics rows and the wall-clock budget (absolute unix time)
        self.preempt = guard_mod.PreemptionGuard(
            enabled=bool(args['guard'].get('preempt_signals', True)))
        self._check_episodes = bool(args['guard'].get('check_episodes',
                                                      True))
        self._bad_episodes = 0
        self._chaos = guard_mod.parse_chaos()
        self._final_flushed = False
        self._last_ckpt_epoch = -1
        self._last_ckpt_steps = -1
        self._registry = None
        self._metrics_path = args.get('metrics_jsonl') or ''
        self._deadline = float(os.environ.get('HANDYRL_TPU_DEADLINE', 0)
                               or 0)
        self.model_dir = args.get('model_dir', 'models')

        if net is None:
            net = self.env.net()
            net.reset_parameters(torch.Generator().manual_seed(args['seed']))
        if args.get('compute_dtype'):
            # bf16 activations (flax's module.clone(dtype=...),
            # handyrl_tpu/train.py:1172-1175); the params stay float32, and
            # snapshots and checkpoints carry no dtype
            set_compute_dtype(net, args['compute_dtype'])
        self.module = net
        self.model_epoch = args['restart_epoch']
        resume = False
        if self.model_epoch < 0:
            # the newest checkpoint that passes verification, or a fresh
            # start when none does
            self.model_epoch, discarded = guard_mod.newest_valid_epoch(
                self.model_dir)
            args['restart_epoch'] = self.model_epoch
            if discarded:
                telemetry.counter('guard_ckpt_fallbacks_total').inc(
                    len(discarded))
            if self.model_epoch > 0:
                print('auto-resume: newest valid checkpoint is epoch %d'
                      % self.model_epoch)
        if self.model_epoch > 0:
            self._load_resume_params()
            resume = True
        elif args.get('init_params'):
            # warm start: params only; the epoch counter, the optimizer's
            # moments and the lr EMA start fresh
            with open(args['init_params'], 'rb') as f:
                load_params_bytes(self.module, f.read())
            print('warm-started params from %s' % args['init_params'])
        self.start_epoch = self.model_epoch
        # the learner's host copy of the params (and a 'batch' net's
        # running averages): checkpoints, the actor
        self.params = {k: v.detach().cpu().clone()
                       for k, v in net.state_dict().items()}
        # the actor runs its own copy of the net: the trainer swaps its
        # module's parameters while it runs the step
        self.actor = ModelWrapper(copy.deepcopy(net), self.device)

        self.generation_results: Dict[int, tuple] = {}
        self.num_episodes = 0
        self.num_returned_episodes = 0
        # episodes stamped record_version (the device actor's 'device'
        # records, which follow the card's draws, not the host byte
        # contract; handyrl_tpu/train.py:1966-1971)
        self.stamped_episodes = 0
        # counted episodes by how they arrived: whole uploads (and the
        # in-process generators' records) or reassembled streams
        self.episode_sources = {'whole': 0, 'streamed': 0}
        self.episode_steps = 0     # plies of the counted episodes
        self.results: Dict[int, tuple] = {}
        self.results_per_opponent: Dict[int, dict] = {}
        self.num_results = 0

        # the replay's windows per episode, resolved once from the env
        # twin's episode length before the trainer is built, so the ring's
        # capacity and the windower's cap per episode both read it
        if args['device_replay']:
            from .environment import make_device_env
            resolve_windows_per_episode(args, make_device_env(args['env']))

        # the worker plane (handyrl_tpu/train.py:1227-1234): a local
        # cluster, or the listeners of a training server
        self.remote = remote
        self.use_batched_generation = (not remote
                                       and args['batched_generation'])
        if not self.use_batched_generation:
            # the worker plane never reads device_generation (handyrl_tpu/
            # train.py:2551 reads it in the batched loop only): the
            # gathers' backend is generation.backend or a host's
            # worker_args.backend, and device_replay takes the host push
            args['device_generation'] = False
        self.ledger: Optional[TaskLedger] = None      # built by server()
        self.fleet: Optional[FleetController] = None  # built by server()
        self.worker = None
        self.fleet_failure: Optional[str] = None
        self._snapshot_cache: Optional[tuple] = None
        self._sample_keys: set = set()
        self.repeated_sample_keys = 0
        if not self.use_batched_generation:
            # the local cluster's workers run on the learner's device
            args['worker']['device'] = str(self.device)
            self.worker = WorkerServer(args) if remote else WorkerCluster(args)

        self.trainer = Trainer(args, net.to(self.device))
        self.trainer.rollback_source = self._rollback_source
        # the batchers stamp a window's policy lag against the current
        # epoch at selection
        self.trainer.batcher.epoch_fn = lambda: self.model_epoch
        # torch.profiler: a trace around each epoch profile_epochs names
        # (from the previous epoch's close to the named one's), written
        # under profile_dir or <trace_dir|model_dir>/profile; with
        # profile_dir alone, one window of PROFILE_STEPS update steps
        epochs = parse_epoch_set(args.get('profile_epochs'))
        self.profiler = Profiler(
            self.device, args.get('profile_dir') or (os.path.join(
                telemetry.trace_dir() or self.model_dir, 'profile')
                if epochs else ''), epochs)
        self.trainer.profile = self.profiler
        if resume:
            self._load_resume_state()
        self._steps_at_last_row = self.trainer.steps

        # the league (handyrl_tpu/train.py:1297-1325): the pool, the rating
        # book (reloaded from its journal) and the tally of opponents
        # seated. All None with league.enabled false, so the tasks, records
        # and metrics rows are those of a run without it
        lg = args['league']
        self._league: Optional[league_mod.LeaguePool] = None
        self._league_ratings: Optional[league_mod.RatingBook] = None
        self._league_journal = ''
        self._league_sampled: Dict[str, int] = {}
        self._league_rated: Dict[str, int] = {}     # rating matches booked
        # the newest epoch syncs' gates: the book as it stood, the
        # incumbent and the verdict
        self.league_decisions: deque = deque(maxlen=256)
        self._league_last_flush = time.monotonic()
        if lg['enabled']:
            line = str(lg['line'] or args['serving']['line'])
            self._league = league_mod.LeaguePool(lg, line)
            self._league_ratings = league_mod.make_rating_book(lg)
            self._league_journal = league_mod.journal_path(
                self._registry_root())
            if self._league_ratings.load(self._league_journal):
                print('league: reloaded ratings journal (%d entries, %d '
                      'promotions)' % (len(self._league_ratings.names()),
                                       self._league_ratings.promotions))
            try:
                self._league.refresh(self._ensure_registry())
            except Exception as exc:   # a fresh run: no manifest yet
                _LOG.debug('league: initial pool refresh skipped (%s)', exc)
            if self.use_batched_generation:
                _LOG.warning('league.enabled only drives the worker-fleet '
                             "server() task assignment; the in-process "
                             'batched generator keeps mirror self-play')

        # the durable training plane (handyrl_tpu/train.py:1327-1360), for
        # remote learners only: the episode spool, the ledger journal and
        # the resume token; the assembler of streamed chunks is built
        # always (inert while no chunk arrives), so recovery can replay
        # chunk records whatever the restarted config says
        dur = args['durability']
        self._spool: Optional[EpisodeSpool] = None
        self._ledger_journal: Optional[LedgerJournal] = None
        self._restored_ledger: Optional[dict] = None
        self._durable_restored = False
        self._spool_horizon = 0          # consumption horizon at last ckpt
        self._run_generation = 0         # restart generation (resume token)
        self._token_path = os.path.join(self.model_dir, 'run_token.json')
        self.durable = {'recovered_episodes': 0, 'recovered_chunks': 0,
                        'recovered_reassembled': 0, 'reattached': 0,
                        'rejected_tokens': 0}
        if remote and dur['spool']:
            self._spool = EpisodeSpool(
                self.model_dir, segment_mb=float(dur['segment_mb']),
                keep_segments=int(dur['keep_segments']))
        if remote and dur['ledger_snapshot']:
            self._ledger_journal = LedgerJournal(self.model_dir)
        self._assembler = ChunkAssembler(args,
                                         check_finite=self._check_episodes)
        self._recovered_closed_chunks: list = []
        self._load_durable_state()
        self._trainer_thread: Optional[threading.Thread] = None
        # the scrape endpoint binds once everything it reads exists
        export_port = int(args.get('telemetry_port') or 0)
        if export_port and telemetry.enabled():
            self._exporter = telemetry.TelemetryExporter(
                self._telemetry_snapshots, port=export_port,
                status=self._status_info).start()
        # the wall clock of generation, and of each epoch's close
        self._run_started_at: Optional[float] = None
        self._run_ended_at: Optional[float] = None
        self.epoch_closed_at: List[float] = []
        self.epoch_steps: List[int] = []
        self.epoch_losses: Dict[str, float] = {}   # of the last closed epoch
        # host seconds and plies of each stage of the main loop
        self.loop_seconds = {'generation': 0.0, 'evaluation': 0.0,
                             'ingest': 0.0, 'epoch_close': 0.0}
        self.plies = {'generation': 0, 'evaluation': 0}
        # the fused device loop's pipeline and evaluator, while it runs
        self._fused = None
        self._evaluator = None
        self._eval_dispatches = None
        # the split path's DeviceGenerator (or the host generator), while
        # it runs, and its dispatches after
        self._generator = None
        self._gen_dispatches = None

    # -- the durable training plane ----------------------------------------
    def _load_durable_state(self):
        """Restart recovery (handyrl_tpu/train.py:1382-1540): adopt the
        previous incarnation's resume token (same run_id, generation + 1),
        replay the journaled ledger book, restore the admission counters,
        cancel the tasks whose episodes reached the spool, and feed every
        spooled episode and chunk past the newest checkpoint's
        consumption horizon back into the buffer, all before the fleet is
        served a task. Then publish this incarnation's token."""
        if self._ledger_journal is None and self._spool is None:
            return
        try:
            with open(self._token_path) as f:
                token = json.load(f)
        except (OSError, ValueError):
            token = None
        if isinstance(token, dict) and token.get('run_id'):
            # keep the dead incarnation's run_id: surviving gathers prove
            # membership against it in the resume-token handshake
            self.args['run_id'] = str(token['run_id'])
            telemetry.set_run_id(self.args['run_id'])
            self._run_generation = int(token.get('generation') or 0) + 1

        state = (self._ledger_journal.load()
                 if self._ledger_journal is not None else None)
        if state is not None:
            extra = state.get('extra') or {}
            # the counters: at least the snapshot's, past every sample_key
            # of the restored book and past every key assigned since the
            # snapshot (``key_marks``), so a fresh task never reuses a key
            # (one key, one episode)
            marks = state.get('key_marks') or {}
            g_max = int(marks.get('g', 0)) - 1
            e_max = int(marks.get('e', 0)) - 1
            for base in (list((state.get('tasks') or {}).values())
                         + list(state.get('reissue') or ())):
                if not isinstance(base, dict) \
                        or base.get('sample_key') is None:
                    continue
                if base.get('role') == 'g':
                    g_max = max(g_max, int(base['sample_key']))
                elif base.get('role') == 'e':
                    e_max = max(e_max, int(base['sample_key']))
            self.num_episodes = max(int(extra.get('num_episodes') or 0),
                                    g_max + 1)
            self.num_results = max(int(extra.get('num_results') or 0),
                                   e_max + 1)
            self.num_returned_episodes = int(
                extra.get('num_returned_episodes') or 0)
            self._spool_horizon = int(extra.get('spool_horizon') or 0)
            self._durable_restored = True
            print('durable plane: restored ledger book (%d outstanding, '
                  '%d pending re-issue, counters g=%d e=%d returned=%d)'
                  % (len(state.get('tasks') or {}),
                     len(state.get('reissue') or ()), self.num_episodes,
                     self.num_results, self.num_returned_episodes))

        if self._spool is not None:
            recovered = self._spool.recover(self._spool_horizon, conn_unpack)
            if recovered:
                self._replay_spool(recovered, state)
        self._restored_ledger = state
        if self._durable_restored:
            # the trainer resumes mid-stream: no fresh minimum_episodes
            # warmup on top of the restored buffer
            self.trainer.seen_episodes = self.num_returned_episodes

        # this incarnation's token, before the entry listener opens: the
        # next restart adopts the run_id and bumps the generation
        os.makedirs(self.model_dir, exist_ok=True)
        token = {'run_id': str(self.args['run_id']),
                 'generation': self._run_generation}
        atomic_write_bytes(self._token_path,
                           (json.dumps(token) + '\n').encode('utf-8'))
        self.args['resume_token'] = token

    def _replay_spool(self, recovered: List[dict], state: Optional[dict]):
        """Feed the spooled records back: whole episodes past the restored
        returned-counter, and the chunks of assemblies still open in the
        restored book, closed after its snapshot, or spooled past the
        counter. An episode that reached the spool (or reassembled here)
        cancels its restored task, so it neither re-issues nor counts
        twice."""
        tasks = (state or {}).get('tasks')
        # records below the restored counter were counted by the dead
        # incarnation; they live on only because the GC horizon holds
        # back to the oldest open streamed assembly
        counted = self.num_returned_episodes
        episodes = []
        for rec in recovered:
            episode = rec.get('episode')
            if episode is None or int(rec.get('idx') or 0) < counted:
                continue
            episodes.append(episode)
            tid = (episode.get('args') or {}).get('task_id')
            if tasks is not None and tid is not None:
                tasks.pop(tid, None)
        self.feed_episodes(episodes, recovered=True)
        self.durable['recovered_episodes'] += len(episodes)
        live_keys = set()
        for pair in (state or {}).get('chunks') or ():
            try:
                live_keys.add((str(pair[0][0]), int(pair[0][1])))
            except Exception:
                continue
        for k in (state or {}).get('chunks_closed') or ():
            try:
                live_keys.add((str(k[0]), int(k[1])))
            except Exception:
                continue
        chunk_recs = [rec for rec in recovered
                      if rec.get('chunk') is not None
                      and (int(rec.get('idx') or 0) >= counted
                           or chunk_key(rec['chunk']) in live_keys)]
        if chunk_recs:
            done = self.feed_chunks(
                [rec['chunk'] for rec in chunk_recs], recovered=True,
                marks=[int(rec.get('idx') or 0) for rec in chunk_recs])
            for key, final_args in done:
                self._recovered_closed_chunks.append(key)
                if tasks is None:
                    continue
                tid = (final_args or {}).get('task_id')
                if tid is not None:
                    tasks.pop(tid, None)
                if key and key[0] == 'k':
                    for t, base in list(tasks.items()):
                        if isinstance(base, dict) \
                                and base.get('sample_key') == key[1] \
                                and base.get('role') == 'g':
                            tasks.pop(t, None)
            self.durable['recovered_chunks'] += len(chunk_recs)
            self.durable['recovered_reassembled'] += len(done)
            print('durable plane: replayed %d spooled chunk(s) (%d '
                  'episode(s) reassembled, %d assembly(ies) still open)'
                  % (len(chunk_recs), len(done),
                     self._assembler.open_count()))
        self._durable_restored = True
        print('durable plane: recovered %d spooled episode(s) past horizon '
              '%d (zero admitted episodes lost)'
              % (len(recovered), self._spool_horizon))

    def _sync_durable_state(self):
        """The epoch sync of the durable plane, with every checkpoint
        write: fold the journal into a fresh ledger snapshot and GC the
        spool behind the new consumption horizon, held back to the oldest
        open streamed assembly's first spool mark."""
        horizon = self.num_returned_episodes
        open_mark = self._assembler.min_open_mark()
        if open_mark is not None:
            horizon = min(horizon, int(open_mark))
        if self.ledger is not None and self._ledger_journal is not None:
            self.ledger.flush_journal()
            state = self.ledger.snapshot_state()
            state['extra'] = {
                'num_episodes': self.num_episodes,
                'num_results': self.num_results,
                'num_returned_episodes': self.num_returned_episodes,
                'spool_horizon': horizon,
            }
            self._ledger_journal.snapshot(state)
        if self._spool is not None:
            self._spool_horizon = horizon
            self._spool.gc(self._spool_horizon)

    # -- checkpoints -------------------------------------------------------
    def model_path(self, model_id: int) -> str:
        return os.path.join(self.model_dir, str(model_id) + '.ckpt')

    def latest_model_path(self) -> str:
        return os.path.join(self.model_dir, 'latest.ckpt')

    def trainer_state_path(self) -> str:
        return os.path.join(self.model_dir, 'trainer_state.ckpt')

    def update_model(self, params: Optional[Dict[str, Tensor]], steps: int,
                     state_blob: Optional[bytes] = None, bump: bool = True):
        """Advance the model epoch (unless ``bump`` is False: the final
        flush rewrites the current epoch's files) and write its checkpoint
        files (atomic, each with a CRC32 sidecar), publish them and run the
        retention GC; with ``params`` None (the fused loop's epochs between
        ``checkpoint_interval`` writes) only advance."""
        print('updated model(%d)' % steps)
        if bump:
            self.model_epoch += 1
            # chaos 'nanepoch': poison updates right after this epoch's
            # checkpoint lands, so a rollback target exists
            if self._chaos.get('nanepoch') == self.model_epoch:
                self.trainer.chaos_nan.arm(self.trainer.steps + 1)
        if params is None:
            return
        self._last_ckpt_epoch = self.model_epoch
        self._last_ckpt_steps = steps
        self.params = params
        os.makedirs(self.model_dir, exist_ok=True)
        raw = params_bytes(self.module, params)
        for path in (self.model_path(self.model_epoch),
                     self.latest_model_path()):
            checksummed_write_bytes(path, raw)
        if state_blob is not None:
            checksummed_write_bytes(self.trainer_state_path(), state_blob)
        # publish before the GC: a version the registry is about to pin
        # must be pinned by the time the GC reads the manifest
        self._publish_checkpoint(steps)
        self._gc_checkpoints()
        # the durable plane rides the checkpoint cadence: its snapshot and
        # horizon describe a state a restart can resume from
        self._sync_durable_state()

    def _registry_root(self) -> str:
        srv = self.args.get('serving') or {}
        return srv.get('registry_dir') or self.model_dir

    def _ensure_registry(self):
        if self._registry is None:
            from .serving.registry import ModelRegistry
            self._registry = ModelRegistry(self._registry_root())
        return self._registry

    def _publish_checkpoint(self, steps: int):
        """``serving.publish``: register the numbered checkpoint just
        written with the ModelRegistry as ``<line>@<epoch>`` (which pins it
        against the retention GC); ``serving.auto_promote`` also makes it
        the line's champion in the same manifest swap, unless the league
        owns promotion: then versions publish as candidates and the
        champion changes only through the rating gate
        (:meth:`_league_epoch_sync`). A registry failure is logged and
        training goes on."""
        srv = self.args.get('serving') or {}
        if not srv.get('publish'):
            return
        from . import models as model_zoo
        try:
            # the registry still makes the first version the champion: a
            # line is never headless
            promote = (bool(srv.get('auto_promote', True))
                       and self._league is None)
            self._ensure_registry().publish(
                str(srv.get('line', 'default')),
                path=self.model_path(self.model_epoch),
                architecture=model_zoo.architecture_name(self.module),
                config=self.module.config() or None, steps=int(steps),
                version=self.model_epoch, promote=promote)
        except Exception as exc:
            _LOG.error('registry publish of epoch %d failed (%s: %s); '
                       'training continues unpublished', self.model_epoch,
                       type(exc).__name__, str(exc)[:200])
            telemetry.counter('registry_publish_failures_total').inc()
        self._league_epoch_sync()

    def _league_epoch_sync(self):
        """The league's epoch close (after the publish, before the
        retention GC; handyrl_tpu/train.py:1679-1716): refresh the member
        window from the manifest, seed fresh members at the learner's
        rating, run the rating gate (promote, note it, refresh), set the
        rating gauges and write the journal. A failure is logged and
        training goes on."""
        if self._league is None:
            return
        book = self._league_ratings
        try:
            reg = self._ensure_registry()
            self._league.refresh(reg)
            # a fresh member is a snapshot of the learner: it starts at
            # the learner's rating, not at the cold initial_rating
            known = set(book.names())
            for m in self._league.members():
                if m not in known:
                    book.seed(m, book.rating(league_mod.LEARNER))
            incumbent = self._league.champion
            decision = {'epoch': self.model_epoch, 'champion': incumbent,
                        'state': book.to_state()}
            promote = self._league.should_promote(book)
            decision['promoted'] = promote
            self.league_decisions.append(decision)
            if promote:
                reg.promote(self._league.line, self.model_epoch)
                book.note_promotion()
                telemetry.counter('league_promotions_total').inc()
                self._league.refresh(reg)
                print('league: promoted %s@%d (learner %.1f vs incumbent '
                      '%s %.1f)' % (self._league.line, self.model_epoch,
                                    book.rating(league_mod.LEARNER),
                                    incumbent,
                                    book.rating(incumbent)
                                    if incumbent else float('nan')))
            for name in set(self._league.roster()) | set(book.names()):
                telemetry.gauge('league_rating', member=name).set(
                    round(book.rating(name), 2))
            book.save(self._league_journal)
        except Exception as exc:
            _LOG.error('league: epoch sync failed (%s: %s); training '
                       'continues', type(exc).__name__, str(exc)[:200])

    def _gc_checkpoints(self):
        """``keep_checkpoints: N``: drop the numbered checkpoints beyond
        the newest N, each with its CRC sidecar. Registry-pinned versions
        and checkpoint eval opponents are never deleted; the rollback
        target (the newest valid epoch) is inside the kept window. An
        unreadable registry manifest suspends the pass: with the pin set
        unknown, deleting anything could pull a champion from under a
        service."""
        keep = int(self.args.get('keep_checkpoints') or 0)
        if keep <= 0:
            return
        epochs = guard_mod.numbered_checkpoints(self.model_dir)
        if len(epochs) <= keep:
            return
        from .serving.registry import pinned_checkpoint_paths
        pinned = pinned_checkpoint_paths(self._registry_root())
        if pinned is None:
            return   # corrupt manifest: collect nothing
        if self._league is not None:
            # the pool's members outlive the retention window while PFSP
            # can seat them (the window can trail keep_checkpoints)
            pinned = pinned | {os.path.abspath(p)
                               for p in self._league.member_paths()}
        protected = {os.path.abspath(o)
                     for o in (self.args.get('eval', {}).get('opponent') or [])
                     if isinstance(o, str) and os.path.exists(o)}
        for epoch in epochs[:-keep]:
            path = self.model_path(epoch)
            apath = os.path.abspath(path)
            if apath in pinned:
                telemetry.counter('guard_ckpt_gc_pinned_total').inc()
                continue
            if apath in protected:
                continue
            for p in (path, sidecar_path(path)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            telemetry.counter('guard_ckpt_gc_total').inc()

    def final_flush(self):
        """One code path for the fused loop's tail flush and the
        preemption snapshot: write the current params and train state at
        most once, so a SIGTERM in the last epoch cannot write
        trainer_state.ckpt twice with different steps. The fused loop's
        state is read after the in-flight dispatch (its packed fetch was
        drained); the host loop's trainer hands it over at its next step
        boundary."""
        if self._final_flushed:
            return
        self._final_flushed = True
        tr = self.trainer
        params = steps = blob = None
        if self._fused is not None:
            if (self.model_epoch, tr.steps) == (self._last_ckpt_epoch,
                                                self._last_ckpt_steps):
                return   # the last epoch's files hold this state
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            params, steps, blob = tr.host_params(), tr.steps, tr.state_bytes()
        elif (tr.train_started_at is not None and not tr.failed
              and self._trainer_thread is not None
              and self._trainer_thread.is_alive()):
            try:
                params, steps, blob = tr.update(timeout=60)
            except queue.Empty:
                _LOG.warning('flush: the trainer did not reach a safe point '
                             'in time; keeping the last epoch checkpoint')
        if params is None:
            return
        if (self.model_epoch == self._last_ckpt_epoch
                and steps == self._last_ckpt_steps):
            return   # nothing advanced since the last write
        self.update_model(params, steps, blob, bump=False)

    def _write_preempt_record(self):
        """The ``preempted`` metrics row and the line a supervisor greps
        for. Its steps are the flushed count (what the resume restores),
        not the live counter, so the rows' steps stay monotonic across the
        restart. The rating journal is written first: the restart reloads
        it bit for bit."""
        telemetry.counter('guard_preemptions_total').inc()
        if self._league is not None:
            self._league_ratings.save(self._league_journal)
        steps = max(self._last_ckpt_steps, 0)
        self._write_metrics(steps, extra={
            'preempted': True, 'signal': int(self.preempt.signum or 0)})
        print('preempted: checkpoint flushed at epoch %d (steps %d); '
              'exiting %d for a supervisor restart'
              % (self.model_epoch, steps, guard_mod.PREEMPT_EXIT_CODE),
              flush=True)

    def _write_metrics(self, steps: int, extra: Optional[dict] = None):
        """One ``metrics_jsonl`` row (handyrl_tpu/train.py:2378-2496),
        appended in one write: the run's counts, results, the league, the
        replay, the learning dynamics, the policy-lag means, the guard, the
        device-memory sample (and the steady-state mark once warm-up is
        over), the fleet's counts, the registry summaries (the learner's
        and, on the worker plane, the fleet's merged beacons), the alert
        block; the file rotates past ``telemetry.metrics_rotate_mb``."""
        if not self._metrics_path:
            return
        tr = self.trainer
        rec = {'epoch': self.model_epoch, 'steps': steps,
               'episodes': self.num_returned_episodes, 'time': time.time(),
               'run_id': telemetry.run_id(),
               'sgd_steps_per_sec': round(tr.last_steps_per_sec, 3),
               'buffer': len(tr.episodes),
               'episode_steps': self.episode_steps}
        if extra:
            rec.update(extra)
        gen = self.generation_results.get(self.model_epoch - 1)
        if gen:
            n, r, _ = gen
            rec['generation_mean'] = r / (n + 1e-6)
        ev = self.results.get(self.model_epoch - 1)
        if ev:
            n, r, _ = ev
            rec['win_rate'] = (r / (n + 1e-6) + 1) / 2
        ev_opp = self.results_per_opponent.get(self.model_epoch - 1)
        if ev_opp:
            rec['eval_opponents'] = {
                name: {'games': n,
                       'win_rate': round((r / (n + 1e-6) + 1) / 2, 4)}
                for name, (n, r, _r2) in sorted(ev_opp.items())}
        if self._league is not None:
            book = self._league_ratings
            names = sorted(set(book.names()) | set(self._league.roster()))
            rec['league'] = {
                'champion': self._league.champion,
                'members': self._league.members(),
                'ratings': {n: round(book.rating(n), 2) for n in names},
                'games': {n: book.games(n) for n in names},
                'games_since_promote': book.games_since_promote,
                'promotions': book.promotions,
                'opponents_sampled': dict(sorted(
                    self._league_sampled.items())),
            }
        # a trailing window keeps the quality curve readable when an epoch
        # sees a handful of evaluation games
        recent = [self.results[e] for e in
                  range(max(0, self.model_epoch - 10), self.model_epoch)
                  if e in self.results]
        if recent:
            n = sum(t[0] for t in recent)
            r = sum(t[1] for t in recent)
            rec['win_rate_recent10'] = (r / (n + 1e-6) + 1) / 2
            rec['eval_games_recent10'] = n
        if tr.replay is not None:
            stats = tr.replay_stats
            fp = self._fused
            rec['replay_dropped_episodes'] = stats['dropped_episodes']
            rec['replay_ring_occupancy'] = round(
                fp.ring_size_host / fp.capacity if fp is not None
                else tr.ring_occupancy(), 4)
            rec['replay_sample_reuse'] = round(
                stats['samples_drawn'] / max(1, stats['windows_ingested']), 3)
            rec['replay_windows_ingested'] = stats['windows_ingested']
            rec['replay_samples_drawn'] = stats['samples_drawn']
        rec.update(tr.last_dynamics)
        rec.update(self._lag_snapshot())
        rec['guard_nonfinite'] = tr.guard.total_bad
        rec['guard_rollbacks'] = tr.guard.rollbacks
        rec['guard_bad_episodes'] = self._bad_episodes
        # the perf plane: the device-memory sample (only the learner
        # publishes the ratio gauge: a ratio must not sum across the
        # fleet's snapshots), and steady state once warm-up is over. The
        # warm-up counts epochs that trained, not epochs closed: the fused
        # loop can close its first epoch before its first update step, and
        # the K-step graph that step captures is warm-up
        if steps > self._steps_at_last_row:
            self._trained_epochs += 1
        self._steps_at_last_row = steps
        if telemetry.perf_plane_enabled():
            mem_rows = telemetry.sample_device_memory()
            telemetry.gauge('device_mem_utilization').set(
                round(telemetry.device_memory_utilization(mem_rows), 6))
            if (not telemetry.steady_state_active()
                    and self._trained_epochs >= self._retrace_warmup):
                telemetry.mark_steady_state(
                    'epoch %d, %d trained (retrace_warmup_epochs=%d)'
                    % (self.model_epoch, self._trained_epochs,
                       self._retrace_warmup))
        if self.ledger is not None:
            rec.update({'fleet_' + k: v
                        for k, v in self._fleet_snapshot().items()
                        if k != 'disconnects'})
        telemetry.gauge('learner_epoch').set(self.model_epoch)
        telemetry.gauge('learner_buffer_episodes').set(len(tr.episodes))
        rec['telemetry'] = telemetry.summarize(telemetry.snapshot())
        if self.worker is not None:
            rec['fleet_telemetry'] = telemetry.summarize(
                self._merge_fleet_telemetry())
        if self._alerts is not None:
            rec['alerts'] = self._alerts.maybe_evaluate(
                self._telemetry_snapshots)
        if self._metrics_rotate_mb > 0 and rotate_file(
                self._metrics_path, self._metrics_rotate_mb):
            telemetry.counter('metrics_rotations_total').inc()
        append_jsonl(self._metrics_path, rec)
        telemetry.trace_flush()   # the epoch's buffered events land

    # -- telemetry plumbing --------------------------------------------------
    def _telemetry_snapshots(self) -> List[dict]:
        """The exporter's and the alert engine's snapshots: the live local
        registry and the latest merged fleet snapshot, relabelled
        ``source="fleet"`` so the keys stay disjoint."""
        tr = self.trainer
        telemetry.gauge('learner_epoch').set(self.model_epoch)
        telemetry.gauge('learner_buffer_episodes').set(len(tr.episodes))
        telemetry.gauge('learner_sgd_steps_per_sec').set(
            tr.last_steps_per_sec)
        snaps = [telemetry.snapshot()]
        fleet = self._last_fleet_telemetry
        if fleet and fleet.get('peers'):
            snaps.append(telemetry.relabel(fleet, source='fleet'))
        return snaps

    def _status_info(self) -> Dict[str, Any]:
        """The /statusz payload: progress, the alert block (evaluated
        through the same cadence gate as the server loop), the fleet's
        host states and the perf plane."""
        info: Dict[str, Any] = {'progress': {
            'epoch': self.model_epoch,
            'steps': int(self.trainer.steps),
            'episodes': self.num_returned_episodes,
            'buffer': len(self.trainer.episodes)}}
        if self._alerts is not None:
            info['alerts'] = self._alerts.maybe_evaluate(
                self._telemetry_snapshots)
        if self.fleet is not None:
            info['fleet_hosts'] = self.fleet.snapshot()
        if telemetry.perf_plane_enabled():
            info['perf'] = telemetry.perf_status()
        return info

    def _merge_fleet_telemetry(self) -> dict:
        """The registry snapshots of the newest beacon of each peer (a
        gather's already merges its workers'), merged."""
        peers = self.worker.peer_info().values() if self.worker else ()
        merged = telemetry.merge_snapshots(
            [p.get('telemetry') for p in peers if isinstance(p, dict)])
        self._last_fleet_telemetry = merged
        return merged

    def _lag_snapshot(self) -> Dict[str, float]:
        """The epoch's means of the policy-lag and sample-age histograms
        (deltas since the last read), also set on ``policy_lag_mean`` and
        ``sample_age_seconds_mean`` gauges."""
        out: Dict[str, float] = {}
        batcher = self.trainer.batcher
        for hist, key in ((batcher._m_lag, 'policy_lag'),
                          (batcher._m_age, 'sample_age_seconds')):
            s, n = hist.sum, hist.count
            prev_s, prev_n = self._lag_marks.get(key, (0.0, 0))
            self._lag_marks[key] = (s, n)
            if n > prev_n:
                mean = (s - prev_s) / (n - prev_n)
                out[key] = round(mean, 4)
                telemetry.gauge(key + '_mean').set(mean)
        return out

    def _load_resume_params(self):
        """Load the params of ``model_epoch``, falling back to the newest
        earlier checkpoint that passes CRC verification and decodes."""
        candidates = [self.model_epoch] + [
            e for e in reversed(guard_mod.numbered_checkpoints(
                self.model_dir)) if e < self.model_epoch]
        for epoch in candidates:
            path = self.model_path(epoch)
            ok, reason = verify_checkpoint(path)
            if not ok:
                _LOG.error('discarding checkpoint %s: %s', path, reason)
                telemetry.counter('guard_ckpt_fallbacks_total').inc()
                continue
            try:
                with open(path, 'rb') as f:
                    load_params_bytes(self.module, f.read())
            except (OSError, ValueError, KeyError, RuntimeError) as exc:
                _LOG.error('discarding undecodable checkpoint %s (%s: %s)',
                           path, type(exc).__name__, str(exc)[:120])
                telemetry.counter('guard_ckpt_fallbacks_total').inc()
                continue
            if epoch != self.model_epoch:
                print('resume fell back to epoch %d (epoch %d checkpoint '
                      'invalid)' % (epoch, self.model_epoch))
                self.model_epoch = epoch
            return
        raise FileNotFoundError('no loadable checkpoint at or below epoch %d '
                                'in %s' % (self.model_epoch, self.model_dir))

    def _load_resume_state(self):
        """The optimizer state, steps and lr EMA from trainer_state.ckpt;
        a missing, corrupt or undecodable file leaves them fresh."""
        path = self.trainer_state_path()
        if not os.path.exists(path):
            return
        raw = read_verified_bytes(path)
        if raw is None:
            _LOG.error('discarding corrupt trainer_state.ckpt (checksum '
                       'mismatch or truncation); the optimizer restarts '
                       'fresh from the model checkpoint')
            telemetry.counter('guard_ckpt_fallbacks_total').inc()
            return
        try:
            self.trainer.load_state_bytes(raw)
        except (ValueError, KeyError, TypeError, RuntimeError) as exc:
            _LOG.error('discarding undecodable trainer_state.ckpt (%s: %s); '
                       'the optimizer restarts fresh', type(exc).__name__,
                       str(exc)[:120])
            telemetry.counter('guard_ckpt_fallbacks_total').inc()
            return
        print('resumed trainer state (steps %d)' % self.trainer.steps)

    def _rollback_source(self) -> Optional[Tuple[int, bytes]]:
        """(epoch, trainer_state bytes) of the newest valid checkpoint pair
        for the guard's rollback; None before the first checkpoint."""
        blob = read_verified_bytes(self.trainer_state_path())
        if blob is None:
            return None
        epoch, _ = guard_mod.newest_valid_epoch(self.model_dir)
        if epoch <= 0:
            return None
        return epoch, blob

    def _poll_rollback(self):
        """Rewind the model epoch and the actor's params to a rollback the
        trainer thread made since the last loop iteration."""
        epoch = self.trainer.rollback_epoch
        if epoch is None:
            return
        self.trainer.rollback_epoch = None
        _, from_flax = param_trees(self.module)
        try:
            with open(self.model_path(epoch), 'rb') as f:
                self.params = from_flax(flax_msgpack.from_bytes(f.read()))
        except (OSError, ValueError, KeyError, RuntimeError) as exc:
            _LOG.error('rollback: could not reload epoch %d params (%s: %s)',
                       epoch, type(exc).__name__, str(exc)[:120])
        prev = self.model_epoch
        self.model_epoch = min(self.model_epoch, epoch)
        print('guard: rolled back to epoch %d (from epoch %d)'
              % (self.model_epoch, prev))

    # -- accounting --------------------------------------------------------
    def feed_episodes(self, episodes: List[Optional[dict]],
                      recovered: bool = False):
        """Count and buffer uploaded episodes. On a durable learner each
        is appended to the episode spool before it is counted; a
        ``recovered`` episode (a restart's replay of the spool) skips that
        append and is treated as a fresh upload otherwise."""
        live = 0
        for episode in episodes:
            if episode is None:
                continue
            if (self._check_episodes
                    and not guard_mod.episode_is_finite(episode)):
                self._bad_episodes += 1
                telemetry.counter('guard_bad_episodes_total').inc()
                _LOG.warning('guard: dropped episode with non-finite data '
                             '(%d total)', self._bad_episodes)
                continue
            if self._spool is not None and not recovered:
                # written ahead of any accounting: a SIGKILL past this line
                # replays the episode at the restart; before it, the
                # episode never existed (its task re-issues)
                self._spool.append(
                    self.num_returned_episodes,
                    conn_pack({'idx': self.num_returned_episodes,
                               'episode': episode}))
            self._count_episode(episode)
            if not recovered:
                # a replayed episode's rating was journaled already
                self._league_observe_episode(episode)
            self.episode_sources['whole'] += 1
            episode.setdefault('recv_time', time.time())
            self.trainer.episodes.append(episode)
            self._push_replay(episode)
            live += 1
        telemetry.counter('learner_episodes_returned_total').inc(live)
        self._evict_episode_overflow()

    def _count_episode(self, episode: dict):
        """The accounting of a whole or reassembled episode: generation
        stats by model id, stamped records, repeated sample keys and the
        returned-episode counter."""
        for p in episode['args']['player']:
            model_id = (episode['args'].get('model_id') or {}).get(p, -1)
            if model_id is None or model_id < 0:
                model_id = self.model_epoch
            outcome = episode['outcome'][p]
            n, r, r2 = self.generation_results.get(model_id, (0, 0, 0))
            self.generation_results[model_id] = (n + 1, r + outcome,
                                                 r2 + outcome ** 2)
        if episode.get('record_version'):
            # device records follow the card's draws, not the host byte
            # contract: stamped, and counted fleet-wide
            self.stamped_episodes += 1
            telemetry.counter('device_actor_stamped_episodes_total').inc()
        skey = episode['args'].get('sample_key')
        if skey is not None:   # a worker-plane task: played once
            if skey in self._sample_keys:
                self.repeated_sample_keys += 1
            self._sample_keys.add(skey)
        self.num_returned_episodes += 1
        self.episode_steps += int(episode['steps'])

    def _push_replay(self, episode: dict):
        """The threaded replay trainer's host push: best effort under a
        backlog, every drop counted (handyrl_tpu/train.py:2001-2006)."""
        if self.trainer.replay is None:
            return
        try:
            self.trainer.ingest_queue.put_nowait(episode)
        except queue.Full:
            self.trainer.replay_stats['dropped_episodes'] += 1

    def _evict_episode_overflow(self):
        maximum = self.args['maximum_episodes']
        if self.trainer.replay is not None:
            # the training data lives in the device ring; the host deque
            # only gates the start
            maximum = min(maximum, 2 * self.args['minimum_episodes'])
        while len(self.trainer.episodes) > maximum:
            self.trainer.episodes.popleft()

    def feed_chunks(self, chunks: List[Optional[dict]],
                    recovered: bool = False,
                    marks: Optional[List[int]] = None) -> list:
        """The streamed twin of :meth:`feed_episodes` (handyrl_tpu/
        train.py:2032-2107): each chunk (screened by the ledger) is
        spooled, folded into its assembly and, as its contiguous prefix
        grows, trainable as a partial buffer entry. A completed assembly
        closes its ledger task and is counted as :meth:`feed_episodes`
        counts a whole episode. Returns the ``(key, final_args)`` of the
        episodes completed here (spool recovery cancels their restored
        tasks)."""
        completed = []
        for j, chunk in enumerate(chunks):
            if chunk is None:
                continue
            mark = marks[j] if marks is not None \
                else self.num_returned_episodes
            if self._spool is not None and not recovered:
                self._spool.append(
                    self.num_returned_episodes,
                    conn_pack({'idx': self.num_returned_episodes,
                               'chunk': chunk}))
            res = self._assembler.add(chunk, mark=mark)
            if res['status'] == 'dropped':
                continue
            entry = res.get('entry')
            if res.get('new') and entry is not None:
                entry.setdefault('recv_time', time.time())
                self.trainer.episodes.append(entry)
            if res['status'] != 'complete':
                continue
            key = chunk_key(chunk)
            final_args = res.get('final_args') or {}
            completed.append((key, final_args))
            if self.ledger is not None:
                self.ledger.complete_chunked(key, final_args.get('task_id'))
            record = res.get('record')
            if record is None:
                # a poisoned chunk froze the assembly: the task closed and
                # the record drops whole
                self._bad_episodes += 1
                telemetry.counter('guard_bad_episodes_total').inc()
                _LOG.warning('guard: dropped streamed episode with '
                             'non-finite data (%d total)', self._bad_episodes)
                continue
            self._count_episode(record)
            telemetry.counter('learner_episodes_returned_total').inc()
            if not recovered:
                self._league_observe_episode(record)
            self.episode_sources['streamed'] += 1
            if entry is not None:
                self._push_replay(entry)
        self._evict_episode_overflow()
        return completed

    def feed_results(self, results: List[Optional[dict]],
                     model_id: Optional[int] = None):
        if model_id is None:
            model_id = self.model_epoch
        for result in results:
            if result is None:
                continue
            for p in result['args']['player']:
                res = result['result'][p]
                n, r, r2 = self.results.get(model_id, (0, 0, 0))
                self.results[model_id] = (n + 1, r + res, r2 + res ** 2)
                opp_map = self.results_per_opponent.setdefault(model_id, {})
                opponent = result['opponent']
                n, r, r2 = opp_map.get(opponent, (0, 0, 0))
                opp_map[opponent] = (n + 1, r + res, r2 + res ** 2)
            self._league_observe_result(result)

    # -- epoch boundary ----------------------------------------------------
    def update(self):
        print()
        print('epoch %d' % self.model_epoch)
        self._print_eval_stats()
        self._print_generation_stats()
        self._print_league_stats()
        with telemetry.span('epoch_update'):
            params, steps, state_blob = self.trainer.update()
        if params is None and self.trainer.failed:
            _LOG.error('training failed (see traceback above); shutting '
                       'down')
            self.shutdown_flag = True
            return
        self.update_model(params, steps, state_blob)
        self._write_metrics(steps)
        self.profiler.epoch(self.model_epoch)
        self.epoch_closed_at.append(time.time())
        self.epoch_steps.append(steps)
        self.epoch_losses = dict(self.trainer.last_losses)

    def _deadline_passed(self) -> bool:
        return self._deadline > 0 and time.time() >= self._deadline

    def _past_epoch_budget(self) -> bool:
        """True when the epoch budget or the wall-clock deadline
        (``HANDYRL_TPU_DEADLINE``) is spent."""
        return (0 <= self.args['epochs'] <= self.model_epoch
                or self._deadline_passed())

    def _stop_requested(self) -> bool:
        """The loops' safe point at the top of an iteration: the
        wall-clock budget spent mid-epoch, or a preemption signal."""
        if self._deadline_passed():
            return True
        if self.preempt.requested():
            _LOG.warning('preemption signal received; snapshotting and '
                         'exiting')
            return True
        return False

    def _run_eval_share(self, evaluator, tracker: Optional[Dict] = None):
        """Advance online evaluation until its share of episodes reaches
        eval_rate: the host evaluator all its matches one ply a call, the
        device evaluator a chunk of plies a call, several calls a loop
        iteration, or it would never finish a match. ``tracker`` carries
        the previous dispatch's epoch for a pipelined evaluator, whose
        results arrive one dispatch late."""
        tracker = {} if tracker is None else tracker
        for _ in range(16):
            if self.num_results >= self.eval_rate * self.num_episodes:
                break
            cur = self.model_epoch
            results = evaluator.step()
            self.plies['evaluation'] += evaluator.chunk_steps
            self.num_results += len(results)
            self.feed_results(results, model_id=(tracker.get('prev', cur)
                                                 if evaluator.pipelined
                                                 else cur))
            tracker['prev'] = cur

    def _run_batched(self):
        """Self-play and interleaved evaluation in this thread, the JAX
        learner's non-fused branches (handyrl_tpu/train.py:2534-2774):
        batched self-play on the host (``BatchedGenerator``), or with
        ``device_generation`` rollout chunks on the card
        (``DeviceGenerator``) whose episodes are spliced on the host or,
        with the trainer's windower installed (device ingest), whose
        records go to the trainer thread's ``chunk_queue`` with a blocking
        hand-off. With ``device_generation`` the evaluator is the device
        one where its opponents allow. The device loop runs on a stream of
        its own; the actor's parameters are refreshed between its
        dispatches."""
        args = self.args
        actor = self.actor
        env_args = args['env']

        def make_env_fn(i):
            return make_env({**env_args, 'id': i})

        eval_envs = int(args.get('eval_envs')
                        or max(4, args['generation_envs'] // 8))
        chunk_steps = int(args['device_chunk_steps'])
        gen_stream = contextlib.nullcontext()
        if args['device_generation']:
            from .device_generation import DeviceGenerator
            from .environment import make_device_env
            env_mod = make_device_env(env_args)
            evaluator = self._device_evaluator(env_mod, eval_envs,
                                               chunk_steps)
            gen = DeviceGenerator(env_mod, actor.module, args,
                                  n_envs=args['generation_envs'],
                                  chunk_steps=chunk_steps, seed=args['seed'])
            if self.device.type == 'cuda':
                gen_stream = torch.cuda.stream(torch.cuda.Stream(self.device))
        else:
            evaluator = BatchedEvaluator(make_env_fn, actor, args,
                                         n_envs=eval_envs)
            gen = BatchedGenerator(make_env_fn, actor, args,
                                   n_envs=args['generation_envs'])
        self._evaluator = evaluator
        self._generator = gen
        device_ingest = self.trainer.windower is not None
        pipelined = getattr(gen, 'pipelined', False)
        cadence = _EpochCadence(args)
        actor_epoch = self.model_epoch
        # a pipelined generator returns the PREVIOUS dispatch's chunk: its
        # episodes are stamped with the epoch of that dispatch
        chunk_epoch = self.model_epoch
        eval_tracker: Dict[str, int] = {}

        def stamp_and_feed(episodes, epoch):
            for ep in episodes:
                self.num_episodes += 1
                # stamp the epoch whose params played the episode
                mid = ep['args'].setdefault('model_id', {})
                for p, v in list(mid.items()):
                    if v is None or v < 0:
                        mid[p] = epoch
            self.feed_episodes(episodes)

        self._run_started_at = time.time()
        with gen_stream:
            while not self.shutdown_flag:
                if self._stop_requested():
                    break
                self._poll_rollback()
                if actor_epoch != self.model_epoch:   # follow the latest
                    with launches.capture_lock:
                        actor.module.load_state_dict(self.params)
                    actor_epoch = self.model_epoch
                dispatch_epoch = self.model_epoch
                t0 = time.perf_counter()
                with launches.path('generation'):
                    if device_ingest:
                        chunk, done, outcome = gen.step_chunk_records()
                    else:
                        episodes = gen.step()
                t1 = time.perf_counter()
                if device_ingest:
                    self.feed_device_chunk(done, outcome, chunk_epoch)
                    self.trainer.seen_episodes = self.num_returned_episodes
                    self._hand_off(chunk)
                else:
                    stamp_and_feed(episodes, chunk_epoch if pipelined
                                   else dispatch_epoch)
                chunk_epoch = dispatch_epoch
                t2 = time.perf_counter()
                with launches.path('evaluation'):
                    self._run_eval_share(evaluator, eval_tracker)
                t3 = time.perf_counter()
                if cadence.due(self.num_returned_episodes):
                    self.update()
                    if self._past_epoch_budget():
                        self.shutdown_flag = True
                t4 = time.perf_counter()
                self.plies['generation'] += (gen.chunk_steps if pipelined
                                             else 1)
                for stage, dt in (('generation', t1 - t0),
                                  ('ingest', t2 - t1),
                                  ('evaluation', t3 - t2),
                                  ('epoch_close', t4 - t3)):
                    self.loop_seconds[stage] += dt
            # account the chunk still in the pipeline
            with launches.path('generation'):
                if device_ingest:
                    tail = gen.drain_records()
                    if tail is not None:
                        self.feed_device_chunk(tail[1], tail[2], chunk_epoch)
                elif pipelined:
                    stamp_and_feed(gen.drain_episodes(), chunk_epoch)
            if hasattr(evaluator, 'drain'):
                self.feed_results(evaluator.drain(),
                                  model_id=eval_tracker.get('prev'))
        self._run_ended_at = time.time()

    def _hand_off(self, chunk):
        """The BLOCKING hand-off of a rollout chunk to the trainer's device
        ingest: the windower's per-env histories follow a contiguous ply
        stream, so a dropped chunk would splice different episodes
        together; generation waits instead (the trainer drains chunks even
        while it waits for ``minimum_episodes``)."""
        tr = self.trainer
        while not (self.shutdown_flag or self.preempt.requested()
                   or tr.failed):
            try:
                tr.chunk_queue.put(chunk, timeout=1.0)
                return
            except queue.Full:
                continue

    # -- the worker plane: the 4-RPC server --------------------------------
    def server(self):
        """The 4-RPC conductor (handyrl_tpu/train.py:3034-3354 without the
        alert branches): 'args' hands out tasks, 'episode' and
        'result' take uploads, 'chunk' takes streamed windows, 'model'
        answers with a snapshot, and ``RESUME_KIND`` answers a redialing
        gather's resume token (ok for this run's id: it reattaches in
        place).

        Every assigned task is booked in a :class:`~.fault.TaskLedger`
        with a deadline; tasks stranded on a detached endpoint or past
        their deadline are re-issued ahead of fresh work without counting
        again, and duplicate uploads are dropped. Each peer maps to a host
        key (socket peers by address, pipe peers one by one) with a health
        state (:class:`~.fault.FleetController`): a flapping host gets
        'idle' placeholders instead of work while its booked tasks drain,
        sits out a quarantine and is re-admitted. A local cluster that
        loses its gathers stops the run (``fleet_failure``)."""
        _LOG.info('started server')
        cadence = _EpochCadence(self.args)
        ft = self.args['fault_tolerance']
        ledger = self.ledger = TaskLedger(deadline=float(ft['task_deadline']))
        if self._restored_ledger is not None:
            # the previous incarnation's book: its tasks re-issue with
            # their original sample_keys ahead of fresh work
            ledger.restore_state(self._restored_ledger)
            self._restored_ledger = None
        if self._recovered_closed_chunks:
            # assemblies the spool's replay completed: a reattached
            # gather's resends of them screen as duplicates
            ledger.seed_closed_chunks(self._recovered_closed_chunks)
            self._recovered_closed_chunks = []
        if self._ledger_journal is not None:
            ledger.journal = self._ledger_journal
        if self._durable_restored:
            # the dead incarnation consumed the epochs its counters crossed
            # (its checkpoints exist): they are not fired again as empty
            # epochs
            while cadence.due(self.num_returned_episodes):
                pass
        fleet = self.fleet = FleetController(
            degrade_after=int(ft['host_degrade_after']),
            quarantine_after=int(ft['host_quarantine_after']),
            health_window=float(ft['host_health_window']),
            quarantine_period=float(ft['host_quarantine_period']))
        host_of: Dict[Any, str] = {}       # endpoint -> host key
        # endpoints whose detach was handled: a request of theirs still in
        # the inbox (read before the peer's EOF) is booked no task, or the
        # task would sit on a dead endpoint past every re-issue
        gone = set()

        def host_key(ep) -> str:
            key = host_of.get(ep)
            if key is None:
                try:
                    sock = getattr(ep, 'sock', None)
                    if sock is None and hasattr(ep, 'sock'):
                        raise OSError('socket already closed')
                    key = ('host-%s' % sock.getpeername()[0]
                           if sock is not None
                           else 'local-%d' % ep.fileno())
                except (OSError, AttributeError):
                    key = 'host-unknown'
                host_of[ep] = key
                if fleet.observe(key):
                    telemetry.gauge('fleet_host_state', host=key).set(
                        telemetry.HOST_STATE_CODES[fleet.state(key)])
            return key

        fault_seen: Dict[Any, int] = {}    # endpoint -> soft faults seen
        m_withheld = telemetry.counter('fleet_tasks_withheld_total')

        def pump_fleet_health():
            """Feed the controller: strandings from the ledger, soft faults
            (engine restarts and worker failovers) from the deltas of the
            peers' beacons, then the time- and drain-driven transitions."""
            for ep, _reason, _t in ledger.drain_stranding_events():
                host = host_of.get(ep)
                if host is not None:
                    fleet.record_stranding(host)
            record_soft_faults(fleet, self.worker.peer_info(), host_of,
                               fault_seen)
            outstanding: Dict[str, int] = {}
            for ep, n in ledger.outstanding_by_endpoint().items():
                host = host_of.get(ep)
                if host is not None:
                    outstanding[host] = outstanding.get(host, 0) + n
            fleet.tick(outstanding)
            for host, prev, state, _t in fleet.drain_transitions():
                _LOG.warning('fleet: host %s %s -> %s', host, prev, state)
                telemetry.gauge('fleet_host_state', host=host).set(
                    telemetry.HOST_STATE_CODES[state])
                telemetry.counter('fleet_host_transitions_total',
                                  **{'from': prev, 'to': state}).inc()
            if self._alerts is not None:
                # the cadence gate spaces the evaluations by the engine's
                # interval though the loop spins every receive timeout
                self._alerts.maybe_evaluate(self._telemetry_snapshots)

        self._run_started_at = time.time()
        while self.worker.connection_count() > 0 or not self.shutdown_flag:
            if self.preempt.requested():
                # the flush happens in run(); the fleet is not waited for
                _LOG.warning('preemption signal received; snapshotting '
                             'and exiting')
                self.shutdown_flag = True
                break
            if self._deadline_passed():
                self.shutdown_flag = True   # wind the fleet down
            lost = self.worker.lost(self.shutdown_flag)
            if lost:
                self.fleet_failure = lost
                _LOG.error('worker cluster failed: %s', lost)
                self.shutdown_flag = True
                break
            self._poll_rollback()
            # supervision runs even when no RPC arrives: stranded tasks
            # must re-enter the queue or the epoch cadence starves
            detached = []
            for ep, reason, _t in self.worker.drain_detach_events():
                n = ledger.fail_endpoint(ep)
                detached.append(ep)
                gone.add(ep)
                if n:
                    _LOG.warning('re-issuing %d task(s) from detached '
                                 'peer (%s)', n, reason)
            ledger.reap()
            pump_fleet_health()
            for ep in detached:       # after the stranding drain mapped them
                host_of.pop(ep, None)
                fault_seen.pop(ep, None)
            try:
                conn, (req, data) = self.worker.recv(timeout=0.3)
            except queue.Empty:
                continue

            multi_req = isinstance(data, list)
            if not multi_req:
                data = [data]
            send_data: List[Any] = []
            if req == 'args' and conn in gone:
                continue            # no reply can reach the peer either
            if req == 'args':
                if self.shutdown_flag:
                    send_data = [None] * len(data)
                elif not fleet.admits(host_key(conn)):
                    # drain before detach: placeholders, unbooked and
                    # uncounted, keep the host's workers warm
                    fleet.stats['withheld'] += len(data)
                    m_withheld.inc(len(data))
                    send_data = [{'role': 'idle', 'wait': 1.0}
                                 for _ in data]
                else:
                    for _ in data:
                        role_args = ledger.next_reissue()
                        if role_args is None:
                            role_args = self._fresh_task()
                        ledger.assign(conn, role_args)
                        send_data.append(role_args)
            elif req == 'episode':
                self.feed_episodes(ledger.admit(data))
                # completions journal after the spool's append: a kill in
                # between recovers the episode from the spool, whose
                # task_id cancels the restored book entry
                ledger.flush_journal()
                send_data = [None] * len(data)
            elif req == 'chunk':
                # streamed windows: screened per (assembly, chunk index),
                # spooled and merged, journaled in the same order
                self.feed_chunks(ledger.admit_chunks(data))
                ledger.flush_journal()
                send_data = [None] * len(data)
            elif req == 'result':
                self.feed_results(ledger.admit(data))
                ledger.flush_journal()
                send_data = [None] * len(data)
            elif req == RESUME_KIND:
                # a surviving gather redialed: the same run_id reattaches
                # it in place (its resend buffer replays as ordinary
                # screened uploads); another run's id sends it down the
                # cold-respawn path
                for tok in data:
                    tok = tok if isinstance(tok, dict) else {}
                    ok = str(tok.get('run_id')) == str(self.args['run_id'])
                    if not ok:
                        self.durable['rejected_tokens'] += 1
                    elif int(tok.get('generation', -1)) \
                            != self._run_generation:
                        self.durable['reattached'] += 1
                        telemetry.counter('gather_reattach_total').inc()
                        _LOG.info('gather %s reattached across a learner '
                                  'restart (generation %s -> %d)',
                                  tok.get('gather'), tok.get('generation'),
                                  self._run_generation)
                    send_data.append({'ok': ok,
                                      'run_id': str(self.args['run_id']),
                                      'generation': self._run_generation})
            elif req == 'model':
                send_data = [self._model_snapshot(mid) for mid in data]
            else:
                _LOG.warning('unknown request %r from %s', req,
                             host_key(conn))
                send_data = [None] * len(data)
            if not multi_req and len(send_data) == 1:
                send_data = send_data[0]
            self.worker.send(conn, send_data)

            if cadence.due(self.num_returned_episodes):
                t0 = time.perf_counter()
                # abandon the streamed assemblies no attempt can finish (a
                # dead device stream), so they stop pinning the spool's GC
                # horizon
                for key in self._assembler.reap(2 * ledger.deadline):
                    ledger.abandon_chunks(key)
                self.update()
                self._print_fleet_stats()
                self.loop_seconds['epoch_close'] += time.perf_counter() - t0
                if self._past_epoch_budget():
                    self.shutdown_flag = True
        self._run_ended_at = time.time()
        _LOG.info('finished server')

    def _fresh_task(self) -> Dict[str, Any]:
        """A new task: evaluation ('e') while the results lag ``eval_rate``
        of the episodes, else generation ('g'); both stamped with their
        ``sample_key``, so the task (or its re-issue) plays the same
        episode on any worker. With the league (handyrl_tpu/train.py:
        3205-3262) a 'g' task's PFSP share seats a pool member on every
        seat but the learner's, which rotates with the key, and a stride
        of 'e' tasks become rating matches against the roster in round
        robin; the stamps ride the ledger's booked args, so a re-issue
        keeps them."""
        players = self.env.players()
        role_args: Dict[str, Any] = {'model_id': {}}
        if self.num_results < self.eval_rate * self.num_episodes:
            role_args['role'] = 'e'
            role_args['player'] = [players[self.num_results % len(players)]]
            for p in players:
                role_args['model_id'][p] = (
                    self.model_epoch if p in role_args['player'] else -1)
            member = self._league_rating_opponent(self.num_results)
            if member is not None:
                # registry members ride as model_id seats; the anchors
                # resolve on the worker by name
                role_args['opponent'] = member
                role_args['league_rating_match'] = True
                mid = self._league.member_model_id(member)
                if mid is not None and mid > 0:
                    for p in players:
                        if p not in role_args['player']:
                            role_args['model_id'][p] = mid
            role_args['sample_key'] = self.num_results
            self.num_results += 1
        else:
            role_args['role'] = 'g'
            role_args['player'] = players
            for p in players:
                role_args['model_id'][p] = self.model_epoch
            drawn = self._league_gen_opponent(self.num_episodes)
            if drawn is not None:
                member, mid = drawn
                seat = players[self.num_episodes % len(players)]
                for p in players:
                    if p != seat:
                        role_args['model_id'][p] = mid
                role_args['league_opponent'] = member
                role_args['league_seat'] = seat
            role_args['sample_key'] = self.num_episodes
            self.num_episodes += 1
        return role_args

    def _model_snapshot(self, model_id: int) -> Dict[str, Any]:
        """The 'model' reply: the current params for the current epoch (or
        id 0 and below), a numbered checkpoint's bytes for an older one;
        when its file is gone, a league member's version from the registry
        (handyrl_tpu/train.py:3331-3337), else the current params."""
        from . import models as model_zoo
        raw = None
        if 0 < model_id != self.model_epoch:
            try:
                with open(self.model_path(model_id), 'rb') as f:
                    raw = f.read()
            except OSError:
                snap = self._league_model_snapshot(model_id)
                if snap is not None:
                    return snap
        if raw is None:
            key = (self.model_epoch, id(self.params))
            if self._snapshot_cache is None or self._snapshot_cache[0] != key:
                self._snapshot_cache = (key, params_bytes(self.module,
                                                          self.params))
            raw = self._snapshot_cache[1]
        snap = {'architecture': model_zoo.architecture_name(self.module),
                'params': raw}
        config = self.module.config()
        if config:
            snap['config'] = config
        return snap

    # -- the league (handyrl_tpu/train.py:2153-2270) -----------------------
    def _league_gen_opponent(self, sample_key: int
                             ) -> Optional[Tuple[str, int]]:
        """The PFSP draw for the 'g' task stamped ``sample_key``: the
        ``(member, model_id)`` its other seats carry, or None for the
        self-play share and an empty pool."""
        if self._league is None:
            return None
        member = self._league.sample_opponent(
            int(self.args.get('seed') or 0), sample_key, self._league_ratings)
        if member is None:
            return None
        mid = self._league.member_model_id(member)
        if mid is None:
            return None
        return member, mid

    def _league_rating_opponent(self, counter: int) -> Optional[str]:
        """The rating match's opponent for the 'e' task ``counter``, or
        None when the task stays an eval.opponent match: every
        round(1 / rating_match_rate)-th task, in round robin."""
        if self._league is None:
            return None
        rate = float(self._league.args.get('rating_match_rate', 0.25))
        if rate <= 0.0:
            return None
        stride = max(1, int(round(1.0 / rate)))
        if counter % stride != 0:
            return None
        return self._league.rating_opponent(counter // stride)

    def _league_model_snapshot(self, model_id: int
                               ) -> Optional[Dict[str, Any]]:
        """A league member's version through the registry (its bytes
        verified against the CRC sidecar) when the numbered checkpoint is
        gone; None when the league is off or the registry fails too."""
        if self._league is None:
            return None
        try:
            snap = self._ensure_registry().load_snapshot(
                self._league.line, str(model_id))
            return {k: snap[k] for k in ('architecture', 'params', 'config')
                    if k in snap}
        except Exception as exc:
            _LOG.warning('league: registry could not resolve model %s '
                         '(%s: %s)', model_id, type(exc).__name__,
                         str(exc)[:120])
            return None

    def _league_observe_episode(self, episode: dict):
        """Book a league 'g' outcome: the learner's score against the
        member seated by the stamp (``league_opponent``,
        ``league_seat``)."""
        if self._league is None:
            return
        args = episode.get('args') or {}
        member = args.get('league_opponent')
        if not member:
            return
        outcome = episode['outcome'].get(args.get('league_seat'))
        if outcome is None:
            return
        self._league_ratings.record(member, (float(outcome) + 1.0) / 2.0)
        self._league_sampled[member] = self._league_sampled.get(member, 0) + 1
        telemetry.counter('league_games_total').inc()
        self._league_flush_maybe()

    def _league_observe_result(self, result: dict):
        """Book a rating match ('e' slice): the evaluated seat's result
        against the member the task's opponent stamp names."""
        if self._league is None:
            return
        args = result.get('args') or {}
        if not args.get('league_rating_match'):
            return
        member = result.get('opponent')
        seats = args.get('player') or []
        if not member or not seats:
            return
        res = result['result'].get(seats[0])
        if res is None:
            return
        self._league_ratings.record(member, (float(res) + 1.0) / 2.0)
        self._league_rated[member] = self._league_rated.get(member, 0) + 1
        telemetry.counter('league_games_total').inc()
        self._league_flush_maybe()

    def _league_flush_maybe(self):
        """Write the journal shortly after an outcome lands, at most every
        ``league.rating_flush_seconds``: a SIGKILLed learner loses at most
        that window of ratings. The write is atomic, so a kill mid-write
        leaves the previous journal."""
        if self._league is None:
            return
        interval = float(self.args['league']['rating_flush_seconds'])
        if interval <= 0:
            return
        now = time.monotonic()
        if now - self._league_last_flush < interval:
            return
        self._league_last_flush = now
        self._league_ratings.save(self._league_journal)

    def _print_league_stats(self):
        if self._league is None:
            return
        book = self._league_ratings
        print('league: learner=%.1f games=%d members=%d champion=%s '
              'promotions=%d'
              % (book.rating(league_mod.LEARNER), book.games_since_promote,
                 len(self._league.members()), self._league.champion,
                 book.promotions))

    def _league_summary(self) -> Dict[str, Any]:
        """The league in the JSON line (nothing with it off): the pool,
        the book, the opponents seated in 'g' episodes, the rating matches
        booked, and each epoch sync's gate."""
        if self._league is None:
            return {}
        book = self._league_ratings
        return {'league': {
            'line': self._league.line, 'champion': self._league.champion,
            'members': self._league.members(),
            'roster': self._league.roster(),
            'journal': self._league_journal,
            'ratings': {n: book.rating(n) for n in book.names()},
            'games': {n: book.games(n) for n in book.names()},
            'games_since_promote': book.games_since_promote,
            'promotions': book.promotions,
            'opponents_sampled': dict(sorted(self._league_sampled.items())),
            'rating_matches': dict(sorted(self._league_rated.items())),
            'decisions': list(self.league_decisions),
        }}

    def _fleet_snapshot(self) -> Dict[str, Any]:
        """Fleet health: the ledger's and the hub's counts and the gathers'
        stats from their beacons."""
        led = self.ledger.stats
        hub = self.worker.hub_stats()
        gathers = self.worker.fleet_beacons()['gathers'].values()
        snap = {
            'live': self.worker.connection_count(),
            'outstanding': self.ledger.outstanding(),
            'pending_reissue': self.ledger.pending_reissue(),
            'reissued': led['reissued'],
            'expired': led['expired'],
            'duplicates_dropped': led['duplicates'],
            'detached': hub.get('detached', 0),
            'reconnects': sum(int(g.get('reconnects', 0)) for g in gathers),
            'dropped_uploads': sum(int(g.get('dropped_uploads', 0))
                                   for g in gathers),
            'reattaches': sum(int(g.get('reattaches', 0)) for g in gathers),
        }
        reasons = {k[len('disconnect_'):]: v for k, v in hub.items()
                   if k.startswith('disconnect_')}
        if reasons:
            snap['disconnects'] = reasons
        counts = self.fleet.counts()
        snap['hosts'] = sum(counts.values())
        snap['hosts_degraded'] = counts['degraded']
        snap['hosts_draining'] = counts['draining']
        snap['hosts_quarantined'] = counts['quarantined']
        snap['withheld'] = self.fleet.stats['withheld']
        snap['readmitted'] = self.fleet.stats['readmitted']
        return snap

    def _print_fleet_stats(self):
        snap = self._fleet_snapshot()
        snap['guard_nonfinite'] = self.trainer.guard.total_bad
        snap['guard_rollbacks'] = self.trainer.guard.rollbacks
        snap['guard_bad_episodes'] = self._bad_episodes
        reasons = snap.pop('disconnects', {})
        line = ' '.join('%s=%s' % kv for kv in snap.items())
        if reasons:
            line += ' (%s)' % ', '.join(
                '%s=%d' % kv for kv in sorted(reasons.items()))
        print('fleet: ' + line)

    def _worker_summary(self) -> Dict[str, Any]:
        """The worker plane's fields of the JSON line: the fleet snapshot,
        the kernel launches of the worker processes (summed over each
        process's newest beacon) and each worker's play stats with its
        seconds a generated ply."""
        if self.worker is None or self.ledger is None:
            return {}
        workers = self.worker.fleet_beacons()['workers']
        total = {k: 0 for k in launches.KERNELS}
        stats = {}
        for (wid, pid), b in sorted(workers.items(),
                                    key=lambda kv: (kv[0][0], kv[0][1] or 0)):
            for k, n in (b.get('launches') or {}).items():
                total[k] = total.get(k, 0) + int(n)
            st = dict(b.get('stats') or {})
            st['ply_seconds'] = (st['generation_seconds'] / st['plies']
                                 if st.get('plies') else None)
            st['device'] = b.get('device')
            if b.get('engine_client'):
                # engine mode: whether this worker failed over, and what
                # it launched (nothing until it did)
                st['engine_client'] = b['engine_client']
                st['launches'] = b.get('launches')
            stats['%s/%s' % (wid, pid)] = st
        gathers = self.worker.fleet_beacons()['gathers'].values()
        device_actor = [dict(g['device_actor'], gather=g.get('gather'),
                             pid=g.get('pid'))
                        for g in gathers if g.get('device_actor')]
        # the hosts' inference engines and their workers' clients
        engines = [dict(g['engine'], gather=g.get('gather'), pid=g.get('pid'))
                   for g in gathers if g.get('engine')]
        clients: Dict[str, int] = {}
        for b in workers.values():
            for k, n in (b.get('engine_client') or {}).items():
                if not isinstance(n, bool):
                    clients[k] = clients.get(k, 0) + int(n)
        return {'generation': 'server' if self.remote else 'workers',
                'stamped_episodes': self.stamped_episodes,
                'device_actor': device_actor,
                'engines': engines,
                'engine_clients': clients,
                'fleet': self._fleet_snapshot(),
                'fleet_failure': self.fleet_failure,
                'distinct_sample_keys': len(self._sample_keys),
                'streaming': dict(self._assembler.counts(),
                                  episodes=self.episode_sources),
                'durable': dict(self.durable,
                                run_id=str(self.args['run_id']),
                                generation=self._run_generation,
                                spool=self._spool is not None,
                                journal=self._ledger_journal is not None),
                'repeated_sample_keys': self.repeated_sample_keys,
                'worker_processes': len(workers),
                'worker_kernel_launches': total,
                'worker_stats': stats}

    def _print_eval_stats(self):
        if self.model_epoch not in self.results:
            print('win rate = Nan (0)')
            return

        def output_wp(name, results):
            n, r, r2 = results
            mean = r / (n + 1e-6)
            name_tag = ' (%s)' % name if name != '' else ''
            print('win rate%s = %.3f (%.1f / %d)'
                  % (name_tag, (mean + 1) / 2, (r + n) / 2, n))

        keys = self.results_per_opponent[self.model_epoch]
        if (len(self.args.get('eval', {}).get('opponent', [])) <= 1
                and len(keys) <= 1):
            output_wp('', self.results[self.model_epoch])
        else:
            output_wp('total', self.results[self.model_epoch])
            for key in sorted(keys):
                output_wp(key, keys[key])

    def _print_generation_stats(self):
        if self.model_epoch not in self.generation_results:
            print('generation stats = Nan (0)')
            return
        n, r, r2 = self.generation_results[self.model_epoch]
        mean = r / (n + 1e-6)
        std = (r2 / (n + 1e-6) - mean ** 2) ** 0.5
        print('generation stats = %.3f +- %.3f' % (mean, std))

    # -- lifecycle ---------------------------------------------------------
    # -- the fused device loop ---------------------------------------------
    def feed_device_chunk(self, done: np.ndarray, outcome: np.ndarray,
                          model_id: Optional[int] = None) -> int:
        """Episode accounting of a device chunk: only (done (K, N), outcome
        (K, N, P)) reach the host, the trajectories stay in the ring. Every
        player's outcome counts in the generation stats of ``model_id``,
        the epoch whose params played the chunk."""
        if model_id is None:
            model_id = self.model_epoch
        ks, envs = np.nonzero(done)
        for k, i in zip(ks, envs):
            for oc in outcome[k, i]:
                n, r, r2 = self.generation_results.get(model_id, (0, 0, 0))
                self.generation_results[model_id] = (n + 1, r + float(oc),
                                                     r2 + float(oc) ** 2)
            self.num_episodes += 1
            self.num_returned_episodes += 1
        telemetry.counter('learner_episodes_returned_total').inc(len(ks))
        return len(ks)

    def _device_evaluator(self, env_mod, eval_envs: int, chunk_steps: int):
        """The device evaluator when ``device_eval`` is on and every
        opponent is 'random', a checkpoint file or, where the env twin
        vectorizes its GreedyAgent (``greedy_action``), 'rulebase' (the JAX
        learner's ``device_eval_ok``); the host evaluator otherwise
        (TicTacToe's rulebase)."""
        from .device_generation import DeviceEvaluator, is_checkpoint_opponent
        args = self.args
        opponents = args.get('eval', {}).get('opponent', []) or ['random']
        rulebase = hasattr(env_mod, 'greedy_action')
        if (args['device_eval'] and len(opponents) <= eval_envs
                and all(o == 'random' or (o == 'rulebase' and rulebase)
                        or is_checkpoint_opponent(o) for o in opponents)):
            return DeviceEvaluator(env_mod, self.actor.module, args,
                                   n_envs=eval_envs, chunk_steps=chunk_steps,
                                   seed=args['seed'] + 77,
                                   opponents=opponents)
        env_args = args['env']
        return BatchedEvaluator(lambda i: make_env({**env_args, 'id': i}),
                                self.actor, args, n_envs=eval_envs)

    def _windower(self, mode: str):
        """The device ingest's windower for layout ``mode``, sized by the
        ring's budget."""
        from .environment import make_device_env
        from .ops.device_windows import DeviceWindower
        from .ops.replay import windows_per_episode
        args = self.args
        env_mod = make_device_env(args['env'])
        return DeviceWindower(
            mode=mode, fs=args['forward_steps'], bi=args['burn_in_steps'],
            max_steps=int(getattr(env_mod, 'MAX_STEPS',
                                  getattr(env_mod, 'MAX_PLIES', 256))),
            windows_cap=windows_per_episode(args),
            capacity=ring_capacity(args), num_players=env_mod.NUM_PLAYERS,
            gamma=args['gamma'], has_reward=hasattr(env_mod, 'rewards'))

    def _run_fused(self, mode: str):
        """One thread: each loop iteration enqueues one dispatch (a rollout
        chunk, its ingest and, past ``minimum_episodes``,
        ``sgd_steps_per_chunk`` update steps), then reads the previous
        dispatch's packed accounting, advances evaluation and closes the
        epoch when due. Sample reuse is pinned by the steps a chunk. The
        ingest layout is the JAX learner's (:func:`ingest_layout`)."""
        from .environment import make_device_env
        from .ops.fused_pipeline import FusedPipeline
        from .ops.replay import sgd_steps_per_chunk
        args = self.args
        tr = self.trainer
        env_mod = make_device_env(args['env'])
        chunk_steps = int(args['device_chunk_steps'])
        eval_envs = int(args.get('eval_envs')
                        or max(4, args['generation_envs'] // 8))
        evaluator = self._device_evaluator(env_mod, eval_envs, chunk_steps)
        windower = self._windower(mode)
        print('fused device pipeline: rollout+ingest+train in one dispatch '
              '(%s mode)' % mode)
        fp = FusedPipeline(
            env_mod, self.actor.module, tr.update_step, windower,
            n_envs=args['generation_envs'],
            chunk_steps=int(args['device_chunk_steps']),
            sgd_steps=sgd_steps_per_chunk(args),
            batch_size=args['batch_size'], seed=args['seed'])
        self._fused = fp
        self._evaluator = evaluator
        cadence = _EpochCadence(args)
        actor_epoch = self.model_epoch
        pending_metrics: List[Dict[str, float]] = []
        epoch_steps = 0
        epoch_t0 = time.time()
        eval_tracker: Dict[str, int] = {}
        # the accounting arrives one dispatch late: the epoch of each
        # dispatch is kept until its chunk is read
        epoch_of_dispatch: deque = deque()
        times = self.loop_seconds
        # a dispatch's launch and the host's wait for the previous one's
        # packed fetch join the trainer's 'dispatch' / 'host_block' stage
        # histograms; an epoch's deltas feed the utilization proxy
        m_dispatch = telemetry.histogram('stage_seconds', stage='dispatch')
        m_block = telemetry.histogram('stage_seconds', stage='host_block')
        tacc = {'dispatch': 0.0, 'fetch': 0.0}
        tlast = dict(tacc)

        def account(prev):
            if prev is None:
                return
            self.feed_device_chunk(prev['done'], prev['outcome'],
                                   epoch_of_dispatch.popleft())
            if prev['metrics'] is not None:
                pending_metrics.append(prev['metrics'])
                self._fused_guard_observe(prev['metrics'], fp)

        self._run_started_at = time.time()
        while not self.shutdown_flag:
            if self._stop_requested():
                break
            if actor_epoch != self.model_epoch:
                fp.refresh_actor(tr.update_step.state.params)
                actor_epoch = self.model_epoch
            epoch_of_dispatch.append(self.model_epoch)
            warm = self.num_returned_episodes < args['minimum_episodes']
            t0 = time.perf_counter()
            fetch0 = fp.fetch_seconds
            if warm:
                prev = fp.warm_step()
                self.plies['generation'] += fp.chunk_steps
            else:
                if tr.train_started_at is None:
                    tr.train_started_at = time.time()
                    tr.steps_at_start = tr.steps
                ema = tr.data_cnt_ema
                if tr.chaos_nan.due(tr.steps, fp.sgd_steps):
                    _LOG.warning('chaos: injecting non-finite update at '
                                 'step %d', tr.steps)
                    ema = float('nan')   # a NaN lr on the graphed steps
                prev = fp.train_step(ema)
                tr.steps += fp.sgd_steps
                epoch_steps += fp.sgd_steps
                self.plies['generation'] += fp.chunk_steps
            t1 = time.perf_counter()
            dt_fetch = fp.fetch_seconds - fetch0
            m_dispatch.observe(t1 - t0 - dt_fetch)
            m_block.observe(dt_fetch)
            tacc['dispatch'] += t1 - t0 - dt_fetch
            tacc['fetch'] += dt_fetch
            account(prev)
            t2 = time.perf_counter()
            with launches.path('evaluation'):
                self._run_eval_share(evaluator, eval_tracker)
            t3 = time.perf_counter()
            if cadence.due(self.num_returned_episodes):
                self._fused_epoch(pending_metrics, epoch_steps,
                                  time.time() - epoch_t0, evaluator)
                util = telemetry.utilization_from_stages(
                    {'dispatch': tacc['dispatch'] - tlast['dispatch'],
                     'host_block': tacc['fetch'] - tlast['fetch']})
                telemetry.set_utilization_proxy(util)
                tlast.update(tacc)
                pending_metrics.clear()
                epoch_steps = 0
                epoch_t0 = time.time()
                if self._past_epoch_budget():
                    self.shutdown_flag = True
            t4 = time.perf_counter()
            for stage, dt in (('dispatch', t1 - t0), ('fetch', t2 - t1),
                              ('evaluation', t3 - t2),
                              ('epoch_close', t4 - t3)):
                times[stage] = times.get(stage, 0.0) + dt
        account(fp.drain())
        if hasattr(evaluator, 'drain'):
            self.feed_results(evaluator.drain(),
                              model_id=eval_tracker.get('prev'))
        tr.train_stopped_at = time.time()
        self._run_ended_at = time.time()
        # checkpoint_interval may have skipped the last epoch's files, and
        # a deadline or a preemption lands mid-epoch: the one idempotent
        # flush covers both, between dispatches, after the packed fetch
        self.final_flush()

    def _fused_epoch(self, pending_metrics: List[Dict[str, float]],
                     epoch_steps: int, epoch_wall: float, evaluator):
        """The fused loop's epoch close: the JAX learner's lines, the lr
        EMA, the checkpoint files every ``checkpoint_interval`` epochs and
        always at the last epoch (the actor's params refresh on the device
        every epoch either way), and the metrics row."""
        tr = self.trainer
        print()
        print('epoch %d' % self.model_epoch)
        self._print_eval_stats()
        self._print_generation_stats()
        data_cnt = 0
        loss_sum: Dict[str, float] = {}
        diag_sum: Dict[str, float] = {}
        for metrics in pending_metrics:
            for k, v in metrics.items():
                if k == 'data_count':
                    data_cnt += int(v)
                elif k == 'nonfinite':
                    continue   # the guard's count, observed a dispatch
                elif k.startswith('diag_'):
                    diag_sum[k] = diag_sum.get(k, 0.0) + float(v)
                else:
                    loss_sum[k] = loss_sum.get(k, 0.0) + float(v)
        if epoch_steps > 0:
            tr.last_losses = {k: v / max(data_cnt, 1)
                              for k, v in sorted(loss_sum.items())}
            print('loss = %s' % ' '.join(
                k + ':' + '%.3f' % v for k, v in tr.last_losses.items()))
            tr.data_cnt_ema = (tr.data_cnt_ema * 0.8
                               + data_cnt / (1e-2 + epoch_steps) * 0.2)
            tr.last_steps_per_sec = epoch_steps / max(epoch_wall, 1e-9)
            tr._diag_sum = diag_sum
            tr.last_dynamics = tr._epoch_dynamics(loss_sum, data_cnt,
                                                  epoch_steps)
        stats = tr.replay_stats
        stats['samples_drawn'] += epoch_steps * self.args['batch_size']
        stats['windows_ingested'] = self._fused.windows_ingested_host
        interval = int(self.args['checkpoint_interval'])
        final = 0 <= self.args['epochs'] <= self.model_epoch + 1
        if (self.model_epoch + 1) % interval == 0 or final:
            # the wait for the in-flight dispatch and the checkpoint's
            # copies and files, timed apart
            t0 = time.perf_counter()
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            self.update_model(tr.host_params(), tr.steps, tr.state_bytes())
            times = self.loop_seconds
            times['checkpoint_wait'] = (times.get('checkpoint_wait', 0.0)
                                        + t1 - t0)
            times['checkpoint_write'] = (times.get('checkpoint_write', 0.0)
                                         + time.perf_counter() - t1)
        else:
            self.update_model(None, tr.steps)
        self._write_metrics(tr.steps, {
            'dispatches_gen': self._fused.dispatches,
            'dispatches_eval': getattr(evaluator, 'dispatches', 0)})
        self.profiler.epoch(self.model_epoch)
        self.epoch_closed_at.append(time.time())
        self.epoch_steps.append(tr.steps)
        self.epoch_losses = dict(tr.last_losses)

    def _fused_guard_observe(self, metrics: Dict[str, float], fp):
        """The guard in the fused loop: the 'nonfinite' count rides the
        packed fetch; a rollback restores the last good checkpoint's train
        state in place and rewinds the model epoch and the actor."""
        tr = self.trainer
        bad = int(metrics.get('nonfinite') or 0)
        if bad:
            telemetry.counter('guard_nonfinite_total').inc(bad)
        cnt = int(metrics.get('data_count') or 0)
        loss_mean = (float(metrics['total']) / cnt
                     if cnt and 'total' in metrics else None)
        action = tr.guard.observe(bad, max(0, fp.sgd_steps - bad), loss_mean)
        if action == 'abort':
            raise RuntimeError('guard: %d non-finite update(s) under '
                               'nonfinite_policy=abort' % bad)
        if action == 'skip':
            _LOG.warning('guard: skipped %d non-finite update(s) '
                         '(%d consecutive)', bad, tr.guard.consecutive)
        if action != 'rollback':
            return
        tr._do_rollback()
        if tr.rollback_epoch is not None:
            self._poll_rollback()
            fp.refresh_actor(tr.update_step.state.params)

    def run(self):
        # SIGTERM/SIGINT -> a flush at the next safe point and exit 75;
        # chaos 'preempt=<s>' arms a self-SIGTERM for the drills
        self.preempt.install()
        guard_mod.arm_chaos_preempt(self._chaos)
        # profile_epochs may name the first epoch
        self.profiler.epoch(self.model_epoch)
        try:
            layout = ingest_layout(self.args)
            if layout is not None and self.args['fused_pipeline']:
                self._run_fused(layout)
            else:
                if layout is not None:
                    self.trainer.windower = self._windower(layout)
                    print('device ingest: windows assembled on device '
                          '(%s mode)' % layout)
                self._trainer_thread = threading.Thread(
                    target=self.trainer.run, name='trainer', daemon=True)
                self._trainer_thread.start()
                if self.use_batched_generation:
                    self._run_batched()
                else:
                    self.worker.run()
                    self.server()
        finally:
            if self.preempt.fired:
                # the full checkpoint before the threads are torn down: the
                # restart finds the train state as of the last safe point
                try:
                    self.final_flush()
                    self._write_preempt_record()
                except Exception:
                    traceback.print_exc()
            self.shutdown()

    def shutdown(self):
        """Stop and join the trainer and batcher threads, then drop the
        update step's graphs, so no thread is left on the device at exit."""
        self.shutdown_flag = True
        self.preempt.uninstall()
        # the steady-state flag is process-global: an in-process learner
        # must not leave the sentinel armed for what captures next
        telemetry.clear_steady_state()
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        if self.worker is not None:
            # a failed or preempted run does not wait for its gathers
            self.worker.close(timeout=0.0 if self.fleet_failure
                              or self.preempt.fired else 30.0)
        if self._spool is not None:
            self._spool.close()
        if self._ledger_journal is not None:
            self._ledger_journal.close()
        self.trainer.shutdown()
        if self._trainer_thread is not None:
            self._trainer_thread.join(timeout=300)
            if self._trainer_thread.is_alive():
                _LOG.warning('trainer thread still running at shutdown')
                return
        self.profiler.stop()
        # this run's trace JSONL collated into Chrome JSON (a no-op with
        # tracing off); the JSONL stays the source of truth
        try:
            out = telemetry.finalize_trace()
            if out:
                self._trace_file = out
                _LOG.info('episode trace collated to %s', out)
        except Exception as exc:
            _LOG.warning('trace finalize failed (%s: %s)',
                         type(exc).__name__, str(exc)[:120])
        if self._fused is not None:
            self._fused.release()
        if self._evaluator is not None:
            self._eval_dispatches = getattr(self._evaluator, 'dispatches',
                                            None)
            self._evaluator = None
        if self._generator is not None:
            self._gen_dispatches = getattr(self._generator, 'dispatches',
                                           None)
            self._generator = None
        self.trainer.release()

    def summary(self) -> Dict[str, Any]:
        """The run as one JSON-able dict: counts, evaluation tallies by
        epoch, rates (host clock), epoch wall times, peak device memory, the
        last epoch's losses and the kernel launches by path."""
        tr = self.trainer
        # the rates cover training up to the last epoch's close
        steps = (self.epoch_steps[-1] - tr.steps_at_start
                 if self.epoch_steps else 0)
        train_s = ((self.epoch_closed_at[-1] - tr.train_started_at)
                   if self.epoch_closed_at and tr.train_started_at else None)
        gen_s = ((self._run_ended_at or time.time())
                 - self._run_started_at) if self._run_started_at else None
        marks = ([self._run_started_at] if self._run_started_at else []) \
            + self.epoch_closed_at
        on_card = self.device.type == 'cuda'
        return {
            'device': (torch.cuda.get_device_name(self.device) if on_card
                       else 'cpu'),
            'epochs': self.model_epoch - self.start_epoch,
            'model_epoch': self.model_epoch,
            'steps': steps, 'steps_at_exit': tr.steps,
            'steps_at_start': tr.steps_at_start,
            'first_step_at': tr.first_step_at,
            'episodes': self.num_returned_episodes,
            'eval_results': self.num_results,
            # (n, r) of each epoch's online evaluation, as the JAX learner's
            # win-rate lines print them: n results, r their summed outcomes
            'eval_by_epoch': {str(e): [n, r] for e, (n, r, _)
                              in sorted(self.results.items())},
            'batch_size': self.args['batch_size'],
            'forward_steps': self.args['forward_steps'],
            'generation_seconds': gen_s,
            'train_seconds': train_s,
            'episodes_per_s': (self.num_returned_episodes / gen_s
                               if gen_s else None),
            'update_steps_per_s': steps / train_s if train_s else None,
            'trajectories_per_s': (steps * self.args['batch_size'] / train_s
                                   if train_s else None),
            'epoch_seconds': [b - a for a, b in zip(marks, marks[1:])],
            'epoch_steps': self.epoch_steps,
            'loop_seconds': self.loop_seconds, 'plies': self.plies,
            'trainer_batch_wait_seconds': tr.batch_wait_seconds,
            'trainer_seconds': (tr.train_stopped_at - tr.train_started_at
                                if tr.train_stopped_at and tr.train_started_at
                                else None),
            'peak_memory_mib': (torch.cuda.max_memory_allocated(self.device)
                                / 2 ** 20 if on_card else None),
            'losses': self.epoch_losses,
            'kernel_launches': launches.by_path(),
            'failed': tr.failed, 'failed_reason': tr.failed_reason,
            # the host learner's batchers: threads, processes or
            # shared_memory (none on the fused loop)
            'batcher_mode': None if self._fused else tr.batcher.mode,
            'shm': (tr.batcher.shm_summary() if not self._fused
                    and tr.batcher.mode == 'shared_memory' else None),
            **self._fused_summary(steps, train_s),
            **self._replay_summary(),
            **self._worker_summary(),
            **self._league_summary(),
            # the sentinel's retraces, the collated episode trace and the
            # profiler's traces of this run
            'telemetry': {'retraces': telemetry.steady_retrace_count(),
                          'trace': self._trace_file,
                          'profiles': list(self.profiler.paths)},
        }

    def _replay_summary(self) -> Dict[str, Any]:
        """The device paths other than the fused loop (none on the host
        learner and the fused loop): which one ran, the generator's and
        the evaluator's dispatches and, for the threaded replay trainer,
        its dispatch size, reuse cap, windows ingested, samples drawn,
        sample reuse, dropped episodes and ring."""
        args, tr = self.args, self.trainer
        if self._fused is not None or not (args['device_generation']
                                           or args['device_replay']):
            return {}
        out: Dict[str, Any] = {
            'device_path': ('ingest' if tr.windower is not None else
                            'split' if args['device_generation'] else
                            'host_push'),
            'generator_dispatches': self._gen_dispatches,
            'eval_dispatches': self._eval_dispatches,
        }
        if tr.replay is not None:
            stats = tr.replay_stats
            out['replay'] = {
                'fused_steps': tr.fused_steps,
                'max_sample_reuse': args['max_sample_reuse'],
                'windows_ingested': stats['windows_ingested'],
                'samples_drawn': stats['samples_drawn'],
                'sample_reuse': (stats['samples_drawn']
                                 / stats['windows_ingested']
                                 if stats['windows_ingested'] else None),
                'dropped_episodes': stats['dropped_episodes'],
                'ring_occupancy': tr.ring_occupancy(),
                'ring_capacity': (tr.windower.capacity if tr.windower
                                  is not None else tr.replay.capacity)}
        return out

    def _fused_summary(self, steps: int, train_s: Optional[float]
                       ) -> Dict[str, Any]:
        """The fused loop's fields of the JSON line (none on the host
        learner): dispatches (warm-up and fused), SGD steps/s, sample reuse
        (samples drawn, steps x B, over the windows ingested), windows
        ingested, ring size,
        the host seconds spent enqueuing dispatches and waiting on the packed
        fetch, and the evaluator's dispatches."""
        fp = self._fused
        if fp is None:
            return {}
        ingested = fp.windows_ingested_host
        drawn = self.trainer.replay_stats['samples_drawn']
        return {
            'fused': True,
            'dispatches': fp.dispatches,
            'fused_dispatches': fp.fused_dispatches,
            'warm_dispatches': fp.dispatches - fp.fused_dispatches,
            'sgd_steps_per_chunk': fp.sgd_steps,
            'sgd_steps_per_s': steps / train_s if train_s else None,
            'sample_reuse': drawn / ingested if ingested else None,
            'windows_ingested': ingested,
            'samples_drawn': drawn,
            'ring_size': fp.ring_size_host,
            'ring_capacity': fp.capacity,
            'dispatch_seconds': self.loop_seconds.get('dispatch', 0.0),
            'fetch_seconds': self.loop_seconds.get('fetch', 0.0),
            'eval_dispatches': self._eval_dispatches,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m handyrl_tpu_torch.train',
        description='train a model by self-play (the learner of '
        'handyrl_tpu_torch): batched in this process, from a local worker '
        'cluster (batched_generation: false), or from worker hosts '
        '(--server)')
    ap.add_argument('--config', required=True,
                    help='JSON file with env_args and train_args blocks')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument('--server', action='store_true',
                    help='serve worker hosts (python -m '
                    'handyrl_tpu_torch.worker) on the entry and data ports '
                    '(HANDYRL_TPU_ENTRY_PORT, HANDYRL_TPU_DATA_PORT)')
    a = ap.parse_args(argv)
    with open(a.config) as f:
        args = apply_defaults(json.load(f))
    return train_main(args, a.device, server=a.server)


def train_main(args: Dict[str, Any], device: Any = 'cuda',
               server: bool = False) -> int:
    """Train on ``device`` from ``args`` (as :func:`apply_defaults` gives
    them): the exit code, 75 after a preemption flush, 1 when training
    failed. ``server`` serves worker hosts (the JAX package's
    ``train_server_main``)."""
    device = resolve_device(device)
    fp32_on_card(device)
    reset_kernel_launches()
    learner = Learner(args, device=device, remote=server)
    learner.run()
    print(json.dumps(learner.summary()), flush=True)
    if learner.preempt.fired:
        # the supervisor contract: restart into restart_epoch -1
        return guard_mod.PREEMPT_EXIT_CODE
    failed = (learner.trainer.failed_reason if learner.trainer.failed
              else learner.fleet_failure)
    if failed:
        print('training failed: %s' % failed, file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
