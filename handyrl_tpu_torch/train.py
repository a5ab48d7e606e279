"""The local learner: ``python -m handyrl_tpu_torch.train --config FILE.json
[--device cuda|cpu]``.

The port of the JAX package's ``python main.py --train`` in its default
local form (``batched_generation: True``, handyrl_tpu/train.py): one
process generates episodes by batched self-play, evaluates the model
online and trains it.

* :class:`Batcher`: threads that sample windows from the episode buffer
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
``_run_fused``, solo layout only) the learner runs the fused device loop
in one thread instead (``ops/fused_pipeline.py``): each dispatch is a
rollout chunk on the env's tensor twin, its window ingest into a ring on
the device and ``sgd_steps_per_chunk`` recency-sampled update steps
(``ReplayUpdateStep``), as CUDA graphs on the card; evaluation plays whole
matches on the device (``DeviceEvaluator``); the host reads one packed
tensor a dispatch, one dispatch late (``feed_device_chunk``), and writes
the checkpoints every ``checkpoint_interval`` epochs and at the last.

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
fused loop, all three in the main thread). The CLI prints the log lines
of the JAX package's learner and, at exit, one JSON line of rates, epoch
times, peak device memory, the last epoch's losses and the launches by
path (and the fused loop's dispatches, sample reuse, ring and host
seconds). It exits 75 after a preemption flush and 1 when the trainer
failed.
"""

from __future__ import annotations

import argparse
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
from . import telemetry
from .config import apply_defaults
from .environment import make_env
from .generation import BatchedEvaluator, BatchedGenerator
from .model import (ModelWrapper, fp32_on_card, load_params_bytes,
                    params_bytes, param_trees, resolve_device)
from .ops import launches, reset_kernel_launches
from .ops.batch import make_batch, make_block_cache, select_episode
from .ops.losses import LossConfig
from .ops.train_step import (GraphedUpdateStep, ReplayUpdateStep,
                              StaticUpdateStep, TrainState, init_train_state,
                              opt_state_from_flax, opt_state_to_flax)
from .utils import flax_msgpack
from .utils.fs import (append_jsonl, checksummed_write_bytes,
                       read_verified_bytes, sidecar_path, verify_checkpoint)

_LOG = telemetry.get_logger('train')

Tensor = torch.Tensor
METRICS_PER_DRAIN = 8   # update steps whose metrics come back in one copy


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
            args['entropy_regularization_decay']))


class Batcher:
    """Batch prefetch threads over the shared episode deque: each selects
    ``batch_size`` windows and builds them into one numpy batch (bz2 and
    numpy release the interpreter lock for their heavy parts). One decoded
    block cache serves every thread."""

    def __init__(self, args: Dict[str, Any], episodes: deque):
        self.args = args
        self.episodes = episodes
        self.cache = make_block_cache(args)
        self.output_queue: queue.Queue = queue.Queue(maxsize=8)
        self.stop_flag = False
        self._threads: List[threading.Thread] = []

    def run(self):
        if self._threads:
            return
        for i in range(self.args['num_batchers']):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name='batcher-%d' % i, daemon=True)
            t.start()
            self._threads.append(t)

    def _worker(self, bid: int):
        _LOG.info('started batcher %d', bid)
        while not self.stop_flag:
            try:
                selected = [select_episode(self.episodes, self.args)
                            for _ in range(self.args['batch_size'])]
                batch = make_batch(selected, self.args, cache=self.cache)
            except (IndexError, ValueError):   # buffer transiently empty
                time.sleep(0.1)
                continue
            while not self.stop_flag:
                try:
                    self.output_queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def batch(self, timeout: Optional[float] = None) -> Dict[str, np.ndarray]:
        return self.output_queue.get(timeout=timeout)

    def stop(self):
        self.stop_flag = True
        for t in self._threads:
            t.join(timeout=5)


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
        if args.get('device_replay'):
            # the fused device loop's K-step update on the ring; the
            # pipeline binds it (ops/fused_pipeline.py)
            self.update_step = ReplayUpdateStep(
                module, self.cfg, init_train_state(module), self.default_lr)
            # the ring's accounting, read from the packed fetch at epochs
            self.replay_stats = {'windows_ingested': 0, 'samples_drawn': 0}
        else:
            step_cls = (GraphedUpdateStep if self.device.type == 'cuda'
                        else StaticUpdateStep)
            self.update_step = step_cls(module, self.cfg,
                                        init_train_state(module))
        self.data_cnt_ema = args['batch_size'] * args['forward_steps']
        self.steps = 0
        self.batcher = Batcher(args, self.episodes)
        self.prefetch_depth = max(1, int(args.get('prefetch_depth') or 1))
        self._stager = (_DeviceStager(self.device, self.prefetch_depth)
                        if self.device.type == 'cuda' else None)
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

    def update(self, timeout: Optional[float] = None):
        """Called by the learner at each epoch boundary; blocks until the
        trainer hands over (params on the host, steps, the state's bytes),
        made on its thread after the epoch's last step."""
        self.update_flag = True
        return self.update_queue.get(timeout=timeout)

    # -- the loop ----------------------------------------------------------
    def _stage(self, batch: Dict[str, np.ndarray]):
        if self._stager is None:
            return batch
        return self._stager.stage(batch)

    def _step(self, staged) -> Dict[str, Tensor]:
        lr_val = self._lr()
        if self.chaos_nan.due(self.steps):
            _LOG.warning('chaos: injecting non-finite update at step %d',
                         self.steps)
            lr_val = float('nan')
        lr = torch.full((), lr_val, dtype=torch.float32, device=self.device)
        if self._stager is None:
            return self.update_step({k: torch.from_numpy(v)
                                     for k, v in staged.items()}, lr)
        metrics = self.update_step(self._stager.take(staged), lr)
        self._stager.release(staged)
        return metrics

    def train(self) -> Dict[str, Tensor]:
        """One epoch: steps until the learner asks for the update (and at
        least one batch's metrics are in). Returns the host params."""
        batch_cnt, data_cnt = 0, 0
        pending: List[Dict[str, Tensor]] = []
        staged = self._staged
        epoch_t0 = time.time()

        def top_up():
            while len(staged) < self.prefetch_depth:
                t0 = time.perf_counter()
                try:
                    nxt = self.batcher.batch(timeout=1.0)
                except queue.Empty:
                    break
                finally:
                    self.batch_wait_seconds += time.perf_counter() - t0
                staged.append(self._stage(nxt))

        while ((data_cnt == 0 or not self.update_flag)
               and not self.shutdown_flag):
            if not staged:
                top_up()
                if not staged:
                    continue
            metrics = self._step(staged.popleft())
            # the next uploads are staged while the step runs on the device
            top_up()
            pending.append(metrics)
            batch_cnt += 1
            if len(pending) >= METRICS_PER_DRAIN:
                data_cnt += self._drain_metrics(pending)
                pending = []
            self.steps += 1
        if pending:
            data_cnt += self._drain_metrics(pending)

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
            self.last_dynamics = self._epoch_dynamics(loss_sum, data_cnt,
                                                      batch_cnt)
        return self.host_params()

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
        if 'diag_grad_norm' in d:
            out['grad_norm'] = d['diag_grad_norm'] / nu
        return {k: round(float(v), 6) for k, v in out.items()}

    def _drain_metrics(self, pending: List[Dict[str, Tensor]]) -> int:
        """Bring the queued metric dicts to the host in one copy and fold
        them into the epoch's loss sums; returns the summed data count.
        The 'nonfinite' flags go to the guard."""
        names = list(pending[0])
        rows = torch.stack([torch.stack([m[k] for k in names])
                            for m in pending]).cpu().numpy()
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
        self._guard_observe(bad, len(pending) - bad,
                            total_sum / data_cnt if data_cnt else None)
        return data_cnt

    def _guard_observe(self, bad: int, good: int,
                       loss_mean: Optional[float] = None):
        """Skip is counted, rollback restores the last good checkpoint in
        place, abort raises (run() turns that into the failed path)."""
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
        _LOG.error('guard: non-finite training burst, rolled back to '
                   'checkpoint epoch %d (steps %d)', epoch, self.steps)

    def run(self):
        with launches.path('training'):
            self._run()

    def _run(self):
        _LOG.info('waiting training')
        while (len(self.episodes) < self.args['minimum_episodes']
               and not self.shutdown_flag):
            time.sleep(0.1)
        if not self.shutdown_flag:
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
        self._staged.clear()
        self._stager = None
        self.update_step = None
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)


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
    """The local learner: model, generation and evaluation in this thread,
    the trainer thread, episode and result accounting, epoch cadence and
    checkpoints. ``net`` defaults to the env's net with weights drawn from
    ``seed``; ``device`` to the card (without one it raises)."""

    def __init__(self, args: Dict[str, Any], net: Optional[torch.nn.Module]
                 = None, device: Any = 'cuda'):
        train_args = dict(args['train_args'])
        train_args['env'] = dict(args['env_args'])
        args = train_args
        self.args = args
        self.device = resolve_device(device)
        random.seed(args['seed'])

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
        self.module = net
        self.model_epoch = args['restart_epoch']
        resume = False
        if self.model_epoch < 0:
            # the newest checkpoint that passes verification, or a fresh
            # start when none does
            self.model_epoch, _ = guard_mod.newest_valid_epoch(
                self.model_dir)
            args['restart_epoch'] = self.model_epoch
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
        # the learner's host copy of the params: checkpoints, the actor
        self.params = {k: v.detach().cpu().clone()
                       for k, v in net.named_parameters()}
        # the actor runs its own copy of the net: the trainer swaps its
        # module's parameters while it runs the step
        self.actor = ModelWrapper(copy.deepcopy(net), self.device)

        self.generation_results: Dict[int, tuple] = {}
        self.num_episodes = 0
        self.num_returned_episodes = 0
        self.results: Dict[int, tuple] = {}
        self.results_per_opponent: Dict[int, dict] = {}
        self.num_results = 0

        self.trainer = Trainer(args, net.to(self.device))
        self.trainer.rollback_source = self._rollback_source
        if resume:
            self._load_resume_state()
        self._trainer_thread: Optional[threading.Thread] = None
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

    def _registry_root(self) -> str:
        srv = self.args.get('serving') or {}
        return srv.get('registry_dir') or self.model_dir

    def _publish_checkpoint(self, steps: int):
        """``serving.publish``: register the numbered checkpoint just
        written with the ModelRegistry as ``<line>@<epoch>`` (which pins it
        against the retention GC); ``serving.auto_promote`` also makes it
        the line's champion in the same manifest swap. A registry failure
        is logged and training goes on."""
        srv = self.args.get('serving') or {}
        if not srv.get('publish'):
            return
        from . import models as model_zoo
        from .serving.registry import ModelRegistry
        if self._registry is None:
            self._registry = ModelRegistry(self._registry_root())
        try:
            self._registry.publish(
                str(srv.get('line', 'default')),
                path=self.model_path(self.model_epoch),
                architecture=model_zoo.architecture_name(self.module),
                config=self.module.config() or None, steps=int(steps),
                version=self.model_epoch,
                promote=bool(srv.get('auto_promote', True)))
        except Exception as exc:
            _LOG.error('registry publish of epoch %d failed (%s: %s); '
                       'training continues unpublished', self.model_epoch,
                       type(exc).__name__, str(exc)[:200])

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
        protected = {os.path.abspath(o)
                     for o in (self.args.get('eval', {}).get('opponent') or [])
                     if isinstance(o, str) and os.path.exists(o)}
        for epoch in epochs[:-keep]:
            path = self.model_path(epoch)
            if os.path.abspath(path) in pinned | protected:
                continue
            for p in (path, sidecar_path(path)):
                try:
                    os.unlink(p)
                except OSError:
                    pass

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
        restart."""
        steps = max(self._last_ckpt_steps, 0)
        self._write_metrics(steps, extra={
            'preempted': True, 'signal': int(self.preempt.signum or 0)})
        print('preempted: checkpoint flushed at epoch %d (steps %d); '
              'exiting %d for a supervisor restart'
              % (self.model_epoch, steps, guard_mod.PREEMPT_EXIT_CODE),
              flush=True)

    def _write_metrics(self, steps: int, extra: Optional[dict] = None):
        """One ``metrics_jsonl`` row (handyrl_tpu/train.py:2378-2496 without
        the planes the port lacks: league, fleet, alerts, the lag
        histograms, the perf plane, rotation), appended in one write."""
        if not self._metrics_path:
            return
        tr = self.trainer
        rec = {'epoch': self.model_epoch, 'steps': steps,
               'episodes': self.num_returned_episodes, 'time': time.time(),
               'run_id': telemetry.run_id(),
               'sgd_steps_per_sec': round(tr.last_steps_per_sec, 3),
               'buffer': len(tr.episodes)}
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
        if self.args.get('device_replay'):
            stats = tr.replay_stats
            fp = self._fused
            rec['replay_dropped_episodes'] = 0   # the fused ingest drops none
            rec['replay_ring_occupancy'] = round(
                fp.ring_size_host / fp.capacity if fp is not None else 0.0, 4)
            rec['replay_sample_reuse'] = round(
                stats['samples_drawn'] / max(1, stats['windows_ingested']), 3)
        rec.update(tr.last_dynamics)
        rec['guard_nonfinite'] = tr.guard.total_bad
        rec['guard_rollbacks'] = tr.guard.rollbacks
        rec['guard_bad_episodes'] = self._bad_episodes
        telemetry.gauge('learner_epoch').set(self.model_epoch)
        telemetry.gauge('learner_buffer_episodes').set(len(tr.episodes))
        rec['telemetry'] = telemetry.summarize(telemetry.snapshot())
        append_jsonl(self._metrics_path, rec)

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
                continue
            try:
                with open(path, 'rb') as f:
                    load_params_bytes(self.module, f.read())
            except (OSError, ValueError, KeyError, RuntimeError) as exc:
                _LOG.error('discarding undecodable checkpoint %s (%s: %s)',
                           path, type(exc).__name__, str(exc)[:120])
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
            return
        try:
            self.trainer.load_state_bytes(raw)
        except (ValueError, KeyError, TypeError, RuntimeError) as exc:
            _LOG.error('discarding undecodable trainer_state.ckpt (%s: %s); '
                       'the optimizer restarts fresh', type(exc).__name__,
                       str(exc)[:120])
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
    def feed_episodes(self, episodes: List[Optional[dict]]):
        for episode in episodes:
            if episode is None:
                continue
            if (self._check_episodes
                    and not guard_mod.episode_is_finite(episode)):
                self._bad_episodes += 1
                _LOG.warning('guard: dropped episode with non-finite data '
                             '(%d total)', self._bad_episodes)
                continue
            for p in episode['args']['player']:
                model_id = (episode['args'].get('model_id') or {}).get(p, -1)
                if model_id is None or model_id < 0:
                    model_id = self.model_epoch
                outcome = episode['outcome'][p]
                n, r, r2 = self.generation_results.get(model_id, (0, 0, 0))
                self.generation_results[model_id] = (n + 1, r + outcome,
                                                     r2 + outcome ** 2)
            self.num_returned_episodes += 1
            self.trainer.episodes.append(episode)
        while len(self.trainer.episodes) > self.args['maximum_episodes']:
            self.trainer.episodes.popleft()

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

    # -- epoch boundary ----------------------------------------------------
    def update(self):
        print()
        print('epoch %d' % self.model_epoch)
        self._print_eval_stats()
        self._print_generation_stats()
        params, steps, state_blob = self.trainer.update()
        if params is None and self.trainer.failed:
            _LOG.error('training failed (see traceback above); shutting '
                       'down')
            self.shutdown_flag = True
            return
        self.update_model(params, steps, state_blob)
        self._write_metrics(steps)
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
        """Batched self-play and interleaved evaluation in this thread."""
        args = self.args
        actor = self.actor
        env_args = args['env']

        def make_env_fn(i):
            return make_env({**env_args, 'id': i})

        eval_envs = int(args.get('eval_envs')
                        or max(4, args['generation_envs'] // 8))
        evaluator = BatchedEvaluator(make_env_fn, actor, args,
                                     n_envs=eval_envs)
        gen = BatchedGenerator(make_env_fn, actor, args,
                               n_envs=args['generation_envs'])
        cadence = _EpochCadence(args)
        actor_epoch = self.model_epoch
        self._run_started_at = time.time()
        while not self.shutdown_flag:
            if self._stop_requested():
                break
            self._poll_rollback()
            if actor_epoch != self.model_epoch:   # follow the latest epoch
                with launches.capture_lock:
                    actor.module.load_state_dict(self.params)
                actor_epoch = self.model_epoch
            t0 = time.perf_counter()
            with launches.path('generation'):
                episodes = gen.step()
            t1 = time.perf_counter()
            for ep in episodes:
                self.num_episodes += 1
                # stamp the epoch whose params played the episode
                mid = ep['args'].setdefault('model_id', {})
                for p, v in list(mid.items()):
                    if v is None or v < 0:
                        mid[p] = self.model_epoch
            self.feed_episodes(episodes)
            t2 = time.perf_counter()
            with launches.path('evaluation'):
                self._run_eval_share(evaluator)
            t3 = time.perf_counter()
            if cadence.due(self.num_returned_episodes):
                self.update()
                if self._past_epoch_budget():
                    self.shutdown_flag = True
            t4 = time.perf_counter()
            self.plies['generation'] += 1
            for stage, dt in (('generation', t1 - t0), ('ingest', t2 - t1),
                              ('evaluation', t3 - t2),
                              ('epoch_close', t4 - t3)):
                self.loop_seconds[stage] += dt
        self._run_ended_at = time.time()

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
        return len(ks)

    def _device_evaluator(self, env_mod, eval_envs: int, chunk_steps: int):
        """The device evaluator when every opponent is 'random' or
        'rulebase' (the env twin's vectorized GreedyAgent) and
        ``device_eval`` is on; the host evaluator otherwise (checkpoint
        opponents)."""
        args = self.args
        opponents = args.get('eval', {}).get('opponent', []) or ['random']
        if (args['device_eval'] and len(opponents) <= eval_envs
                and all(o in ('random', 'rulebase') for o in opponents)):
            from .device_generation import DeviceEvaluator
            return DeviceEvaluator(env_mod, self.actor.module, args,
                                   n_envs=eval_envs, chunk_steps=chunk_steps,
                                   seed=args['seed'] + 77,
                                   opponents=opponents)
        env_args = args['env']
        return BatchedEvaluator(lambda i: make_env({**env_args, 'id': i}),
                                self.actor, args, n_envs=eval_envs)

    def _run_device(self):
        """The device path (``device_generation`` and ``device_replay``):
        the env twin, the evaluator, the windower in solo layout and the
        fused loop."""
        from .environment import make_device_env
        from .ops.device_windows import DeviceWindower
        from .ops.replay import ring_capacity, windows_per_episode
        args = self.args
        env_mod = make_device_env(args['env'])
        chunk_steps = int(args['device_chunk_steps'])
        eval_envs = int(args.get('eval_envs')
                        or max(4, args['generation_envs'] // 8))
        evaluator = self._device_evaluator(env_mod, eval_envs, chunk_steps)
        windower = DeviceWindower(
            mode='solo', fs=args['forward_steps'], bi=args['burn_in_steps'],
            max_steps=env_mod.MAX_STEPS,
            windows_cap=windows_per_episode(args),
            capacity=ring_capacity(args), num_players=env_mod.NUM_PLAYERS,
            gamma=args['gamma'], has_reward=hasattr(env_mod, 'rewards'))
        self._run_fused(env_mod, evaluator, windower, 'solo')

    def _run_fused(self, env_mod, evaluator, windower, mode: str):
        """One thread: each loop iteration enqueues one dispatch (a rollout
        chunk, its ingest and, past ``minimum_episodes``,
        ``sgd_steps_per_chunk`` update steps), then reads the previous
        dispatch's packed accounting, advances evaluation and closes the
        epoch when due. Sample reuse is pinned by the steps a chunk."""
        from .ops.fused_pipeline import FusedPipeline
        from .ops.replay import sgd_steps_per_chunk
        args = self.args
        tr = self.trainer
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
            account(prev)
            t2 = time.perf_counter()
            with launches.path('evaluation'):
                self._run_eval_share(evaluator, eval_tracker)
            t3 = time.perf_counter()
            if cadence.due(self.num_returned_episodes):
                self._fused_epoch(pending_metrics, epoch_steps,
                                  time.time() - epoch_t0, evaluator)
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
        self.epoch_closed_at.append(time.time())
        self.epoch_steps.append(tr.steps)
        self.epoch_losses = dict(tr.last_losses)

    def _fused_guard_observe(self, metrics: Dict[str, float], fp):
        """The guard in the fused loop: the 'nonfinite' count rides the
        packed fetch; a rollback restores the last good checkpoint's train
        state in place and rewinds the model epoch and the actor."""
        tr = self.trainer
        bad = int(metrics.get('nonfinite') or 0)
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
        try:
            if self.args['device_generation']:
                self._run_device()
            else:
                self._trainer_thread = threading.Thread(
                    target=self.trainer.run, name='trainer', daemon=True)
                self._trainer_thread.start()
                self._run_batched()
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
        self.trainer.shutdown()
        if self._trainer_thread is not None:
            self._trainer_thread.join(timeout=300)
            if self._trainer_thread.is_alive():
                _LOG.warning('trainer thread still running at shutdown')
                return
        if self._fused is not None:
            self._fused.release()
        if self._evaluator is not None:
            self._eval_dispatches = getattr(self._evaluator, 'dispatches',
                                            None)
            self._evaluator = None
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
            **self._fused_summary(steps, train_s),
        }

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
        description='train a model by batched self-play (the local learner '
        'of handyrl_tpu_torch)')
    ap.add_argument('--config', required=True,
                    help='JSON file with env_args and train_args blocks')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default) or 'cpu'")
    a = ap.parse_args(argv)
    with open(a.config) as f:
        args = apply_defaults(json.load(f))
    device = resolve_device(a.device)
    fp32_on_card(device)
    reset_kernel_launches()
    learner = Learner(args, device=device)
    learner.run()
    print(json.dumps(learner.summary()), flush=True)
    if learner.preempt.fired:
        # the supervisor contract: restart into restart_epoch -1
        return guard_mod.PREEMPT_EXIT_CODE
    if learner.trainer.failed:
        print('training failed: %s' % learner.trainer.failed_reason,
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
