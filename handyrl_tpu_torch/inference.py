"""Batched inference engine: coalesce requests into one forward per tick.

The subset of ``handyrl_tpu/inference.py`` the serving path uses:

* :class:`InferenceEngine` groups outstanding ``(model_id, obs, hidden,
  legal)`` requests from any number of submitters, per model id, under a
  ``batch_wait_ms`` deadline and a ``max_batch`` cap, pads each group to a
  power-of-two row bucket, runs ONE ``batch_inference`` per group on its
  device, samples actions engine-side with the shared seeded routine (so a
  reply equals a local :func:`~.generation.model_act` bit for bit), and
  fans the replies back through ``reply_fn``. The intake queue is bounded
  (``queue_max``): past it a request is shed with an immediate error reply.
  A failure while serving a group answers that group with errors; a fatal
  engine error answers everything in flight. No reply is dropped.
* :class:`ModelVault` is the LRU of materialized snapshots the engine reads.

The engine supervisor, the chaos injectors and the worker-side client are
not ported yet.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import telemetry
from .generation import masked_sample_batch, pad_to_bucket
from .model import ModelWrapper, RandomModel, resolve_device
from .utils.tree import map_structure

_LOG = telemetry.get_logger('inference')


def _canon(x):
    """Rebind an unpickled ndarray's dtype to the interned descriptor, so a
    record mixing local and wire arrays serializes like an all-local one
    (O(1): a descriptor swap, no data copy)."""
    if isinstance(x, np.ndarray):
        x.dtype = np.dtype(x.dtype.str)
    return x


class ModelVault:
    """Small LRU of materialized models keyed by model id.

    ``fetch(model_id)`` returns a snapshot on a miss. Id 0 denotes the
    untrained epoch-0 net and is served as a :class:`RandomModel` (uniform
    play after masking), as in the JAX package."""

    def __init__(self, fetch: Callable, example_obs, capacity: int = 3,
                 device: Any = 'cuda'):
        self._fetch = fetch
        self._example_obs = example_obs
        self._capacity = max(1, int(capacity))
        self._device = resolve_device(device)
        self._slots: OrderedDict = OrderedDict()
        self.fetches = 0                       # snapshot pulls (cache misses)

    def model(self, mid: int):
        """The materialized model for one id (admitting it on miss)."""
        if mid not in self._slots:
            self._admit(mid)
        self._slots.move_to_end(mid)
        return self._slots[mid]

    def _admit(self, mid: int):
        snap = self._fetch(mid)
        self.fetches += 1
        wrapper = ModelWrapper.from_snapshot(snap, self._device)
        model = (RandomModel(wrapper, self._example_obs) if mid == 0
                 else wrapper)
        while len(self._slots) >= self._capacity:
            self._slots.popitem(last=False)
        self._slots[mid] = model


class InferenceEngine:
    """Coalescing batched-inference server on one device.

    ``submit(endpoint, request)`` may be called from any thread; one engine
    thread drains the queue in ticks. A tick dispatches when ``max_batch``
    requests are pending, when ``batch_wait_ms`` has passed since the
    oldest arrival, or when the queue has gone quiet with at least
    ``clients`` requests waiting (see :meth:`_collect`)."""

    def __init__(self, args: Dict[str, Any], fetch_snapshot: Callable,
                 reply_fn: Callable, example_obs, clients: Optional[int] = None,
                 device: Any = 'cuda'):
        inf = dict(args.get('inference') or {})
        self.batch_wait = max(0.0, float(inf.get('batch_wait_ms', 2.0))) / 1e3
        self.max_batch = max(1, int(inf.get('max_batch', 64)))
        self.queue_max = max(0, int(inf.get('queue_max', 1024)))
        self.clients = clients
        self.device = resolve_device(device)
        self.vault = ModelVault(fetch_snapshot, example_obs,
                                capacity=int(inf.get('vault_size', 3)),
                                device=self.device)
        self._reply = reply_fn
        self._cv = threading.Condition()
        # intake entries are (endpoint, request, t_arrival)
        self._queue: deque = deque()              # guarded-by: _cv
        self._stop = False                        # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None
        self._current: List[tuple] = []
        self.crashed: Optional[BaseException] = None
        self.requests_served = 0
        self.batches_run = 0
        self.sheds = 0
        self._m_requests = telemetry.counter('engine_requests_total')
        self._m_batches = telemetry.counter('engine_batches_total')
        self._m_rows = telemetry.histogram(
            'engine_batch_rows', buckets=telemetry.BATCH_ROW_BUCKETS)
        self._m_wait = telemetry.histogram('engine_coalesce_seconds')
        self._m_depth = telemetry.gauge('engine_queue_depth')
        self._m_shed = telemetry.counter('engine_shed_total')
        self._m_errors = telemetry.counter('engine_error_replies_total')

    # -- lifecycle --------------------------------------------------------

    def start(self) -> 'InferenceEngine':
        self._thread = threading.Thread(target=self._run,
                                        name='inference-engine', daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                _LOG.warning('engine: loop thread still running %.0fs after '
                             'stop(); leaking it', timeout)

    # -- request intake (any thread) --------------------------------------

    def submit(self, endpoint, request: Dict[str, Any]):
        with self._cv:
            shed = bool(self.queue_max) and len(self._queue) >= self.queue_max
            if shed:
                self.sheds += 1
            else:
                self._queue.append((endpoint, request, time.monotonic()))
                self._m_depth.set(len(self._queue))
                self._cv.notify()
        if shed:
            self._m_shed.inc()
            self._safe_reply(endpoint, {
                'rid': (request or {}).get('rid'), 'engine_fault': True,
                'error': 'engine overloaded: request shed '
                         '(queue >= %d)' % self.queue_max})

    # -- engine thread ----------------------------------------------------

    def _safe_reply(self, endpoint, msg):
        try:
            self._reply(endpoint, msg)
        except Exception as exc:   # a dead endpoint's reply is a no-op
            _LOG.debug('engine: reply to a gone endpoint dropped (%s)', exc)

    def fail_pending(self, reason: str) -> int:
        """Error-answer every queued and in-flight request."""
        with self._cv:
            items = list(self._current) + list(self._queue)
            self._queue.clear()
            self._current = []
            self._m_depth.set(0)
        for ep, req, _t in items:
            self._m_errors.inc()
            self._safe_reply(ep, {'rid': (req or {}).get('rid'),
                                  'error': reason, 'engine_fault': True})
        return len(items)

    def _collect(self) -> Optional[List[tuple]]:
        """Block until a tick's worth of requests is due; None on stop.

        Quiescence is the early-dispatch rule: submitters push a turn's
        burst back to back, so a queue silent for a fraction of the
        deadline with at least ``clients`` requests means the batch is
        complete, and holding out the deadline would only add latency."""
        gap = max(2e-4, self.batch_wait / 8)
        floor = min(self.max_batch, max(1, self.clients or 1))
        with self._cv:
            while not self._queue:
                if self._stop:
                    return None
                self._cv.wait(1.0)
            deadline = self._queue[0][2] + self.batch_wait
            while len(self._queue) < self.max_batch and not self._stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                before = len(self._queue)
                self._cv.wait(min(remaining, gap))
                if len(self._queue) == before and before >= floor:
                    break
            n = min(len(self._queue), self.max_batch)
            items = [self._queue.popleft() for _ in range(n)]
            self._current = items
            self._m_depth.set(len(self._queue))
        self._m_wait.observe(time.monotonic() - items[0][2])
        return items

    def _run(self):
        """Thread body: the tick loop plus the fatal-error fan-out."""
        try:
            self._loop()
        except BaseException as exc:   # noqa: BLE001 — crash containment
            self.crashed = exc
            _LOG.error('engine: fatal %s: %s\n%s', type(exc).__name__,
                       str(exc)[:200], traceback.format_exc())
            self.fail_pending('inference engine crashed (%s: %s)'
                              % (type(exc).__name__, str(exc)[:200]))

    def _loop(self):
        while True:
            items = self._collect()
            if items is None:
                return
            groups: Dict[int, List[tuple]] = {}
            for item in items:
                groups.setdefault(int(item[1]['mid']), []).append(item)
            for mid, group in groups.items():
                try:
                    self._serve_group(mid, group)
                except Exception as exc:
                    _LOG.warning('engine: serving model %d failed (%s: %s)',
                                 mid, type(exc).__name__, str(exc)[:200])
                    _LOG.debug('%s', traceback.format_exc())
                    for ep, req, _t in group:
                        self._m_errors.inc()
                        self._safe_reply(ep, {'rid': req.get('rid'),
                                              'error': '%s: %s'
                                              % (type(exc).__name__,
                                                 str(exc)[:200])})
            with self._cv:
                self._current = []

    def _serve_group(self, mid: int, group: List[tuple]):
        model = self.vault.model(mid)
        reqs = [req for _ep, req, _t in group]
        rows = len(reqs)
        self.requests_served += rows
        self.batches_run += 1
        self._m_requests.inc(rows)
        self._m_batches.inc()
        self._m_rows.observe(rows)

        if isinstance(model, RandomModel):
            # id 0: zero outputs, no forward pass
            out = model.inference(None)
            policies = np.broadcast_to(out['policy'],
                                       (rows,) + out['policy'].shape)
            values = (np.broadcast_to(out['value'],
                                      (rows,) + out['value'].shape)
                      if 'value' in out else None)
            next_hidden = None
        else:
            obs_batch, _ = pad_to_bucket(
                [map_structure(_canon, r['obs']) for r in reqs])
            init = model.init_hidden()
            hidden_batch = None
            if init is not None:
                hidden_batch, _ = pad_to_bucket(
                    [r.get('hidden') if r.get('hidden') is not None else init
                     for r in reqs])
            outputs = model.batch_inference(obs_batch, hidden_batch)
            policies = outputs['policy']
            values = outputs.get('value')
            next_hidden = outputs.get('hidden')

        act_rows = [n for n, r in enumerate(reqs) if r.get('legal') is not None]
        if act_rows:
            actions, probs, masks = masked_sample_batch(
                policies[act_rows],
                [reqs[n]['legal'] for n in act_rows],
                [reqs[n].get('seed') or [0] for n in act_rows])
        act_index = {n: k for k, n in enumerate(act_rows)}

        for n, (ep, req, _t) in enumerate(group):
            hidden_row = None
            if next_hidden is not None:
                hidden_row = map_structure(lambda a: np.asarray(a)[n],
                                           next_hidden)
            if n in act_index:
                k = act_index[n]
                reply = {'rid': req.get('rid'),
                         'action': int(actions[k]), 'prob': probs[k],
                         'action_mask': masks[k],
                         'value': values[n] if values is not None else None,
                         'hidden': hidden_row}
            else:
                row_out = {'policy': policies[n]}
                if values is not None:
                    row_out['value'] = values[n]
                if hidden_row is not None:
                    row_out['hidden'] = hidden_row
                reply = {'rid': req.get('rid'), 'outputs': row_out}
            self._safe_reply(ep, reply)
