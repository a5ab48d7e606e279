"""The per-host inference engine and the serving path's batched engine.

The port of ``handyrl_tpu/inference.py``. Workers in engine mode hold no
params: their plies go up the worker pipe to their gather (or over TCP to
an :class:`~.serving.service.InferenceService`), one engine coalesces a
tick of requests from every worker into one batched forward on its device
(kernel K1's serving form at the tick's row bucket with ``torus_impl
'pallas'``), samples engine-side and answers each request. The engine is
supervised, requests carry deadlines, and a worker whose engine goes
silent degrades to its own forward and comes back, losing no episode
byte: a record is a pure function of ``(seed, sample_key, params)`` on
either path.

* :class:`InferenceEngine` groups outstanding ``(model_id, obs, hidden,
  legal)`` requests from any number of submitters, per model id, under a
  ``batch_wait_ms`` deadline and a ``max_batch`` cap, pads each group to a
  power-of-two row bucket, runs ONE ``batch_inference`` per group on its
  device, samples actions engine-side with the shared seeded routine (so a
  reply equals a local :func:`~.generation.model_act` bit for bit), and
  fans the replies back through ``reply_fn``. The intake queue is bounded
  (``queue_max``): past it a request is shed with an immediate error reply.
  A failure while serving a group answers that group with errors; a fatal
  engine error answers everything in flight. No reply is dropped. Its tick
  progress (``progress_age``, ``busy``) is what the supervisor watches.
* :class:`EngineSupervisor` is what a gather owns: a watchdog thread that
  restarts a crashed or stalled engine with :class:`~.fault.Backoff`,
  error-answers what the dead engine held, drops a zombie engine's late
  replies by a generation tag, and hosts the ``enginekill=`` and
  ``enginestall=`` chaos.
* :class:`EngineClient`, :class:`RemoteModel` and
  :class:`RemoteModelCache` are the worker's side: request ids, deadlines
  with bounded resends, and a circuit breaker that degrades to the
  per-worker path (a :class:`ModelVault` on the worker's device, fed by the
  'model' RPC) and re-promotes through a half-open probe. With
  ``serving.endpoint`` the requests dial a service's replicas instead of
  the gather pipe, rotating past dead ones.
* :class:`ModelVault` is the LRU of materialized snapshots the engine, the
  per-worker path and the degraded path read.

With ``serving.fleet.resolver`` the client follows the serving fleet's
replica table (``_refresh_endpoints``). The engine writes a
``queue_wait`` trace event per sampled request and an ``engine_batch``
span per coalesced forward; the supervisor records each restart in the
flight recorder and dumps a blackbox (``engine-crash``,
``engine-stall``).
"""

from __future__ import annotations

import random
import threading
import time
import traceback
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import telemetry
from .connection import INFER_KIND, is_infer
from .fault import Backoff, parse_chaos
from .generation import (bucket_rows, bucketed_inference,
                         masked_sample_batch, model_act, pad_to_bucket)
from .model import ModelWrapper, RandomModel, resolve_device
from .utils.tree import map_structure

_LOG = telemetry.get_logger('inference')

_UNSET = object()   # the per-wrapper init_hidden cache's sentinel


def _canon(x):
    """Rebind an unpickled ndarray's dtype to the interned descriptor, so a
    record mixing local and wire arrays serializes like an all-local one
    (O(1): a descriptor swap, no data copy)."""
    if isinstance(x, np.ndarray):
        x.dtype = np.dtype(x.dtype.str)
    return x


def example_observation(env_args: Dict[str, Any]):
    """The first player's observation of a fresh env (what a vault probes
    a RandomModel's output shapes with)."""
    from .environment import make_env
    env = make_env(dict(env_args))
    env.reset()
    return env.observation(env.players()[0])


def warm_up(device) -> None:
    """Bring up the CUDA context and load every kernel of the port, so that
    no request pays for either (a no-op on the CPU)."""
    if device.type != 'cuda':
        return
    import torch
    from .ops import cuda_build
    torch.zeros((), device=device)
    for name in cuda_build.SOURCES:
        cuda_build.load(name)


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

    def obtain(self, wanted: Dict[Any, Optional[int]]) -> Dict[Any, Any]:
        """player -> model for every requested id (None or negative: no
        model, the seat goes to a built-in opponent)."""
        return {player: (None if mid is None or mid < 0
                         else self.model(mid))
                for player, mid in wanted.items()}

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


# ---------------------------------------------------------------------------
# worker side: deadline-bounded transport and circuit-breaker failover

# the client's tallies (a worker's beacon carries them) and their counters
_CLIENT_COUNTERS = {
    'timeouts': 'worker_engine_timeouts_total',
    'errors': 'worker_engine_errors_total',
    'failovers': 'worker_engine_failovers_total',
    'repromotions': 'worker_engine_repromotions_total',
    'local_inferences': 'worker_local_inference_total',
    'stale_replies': 'worker_stale_replies_total',
    'remote_dials': 'worker_engine_remote_dials_total',
    'endpoint_rotations': 'worker_engine_endpoint_rotations_total',
}


class EngineClient:
    """A worker's engine transport: deadlines, bounded resends, and a
    circuit breaker that degrades to the per-worker inference path.

    One client per worker process owns the worker's half of the engine
    protocol on its pipe: request ids, the book of pending requests (kept
    so a timed-out request can be replayed locally from its own inputs,
    which is lossless since both paths give the same bits), early and
    stale reply routing, and the breaker:

    * **closed** (``engine_ok``): requests go to the engine, each with a
      ``request_timeout`` deadline and up to ``request_retries`` resends.
    * **open**: once a request exhausts its deadlines or gets an engine
      error reply, the client serves every in-flight and later request
      locally (a :class:`ModelVault` on ``worker.device``, fed by the same
      'model' RPC) and schedules a half-open probe.
    * **half-open**: once the :class:`~.fault.Backoff` delay has passed,
      ONE request goes to the engine as a probe; its answer closes the
      breaker (re-promotion), its failure re-opens it with a longer delay.

    :meth:`rpc` is the worker's call-response for its other RPCs: a late
    reply to an abandoned inference request may arrive at any time after a
    failover, and is absorbed instead of being taken for the RPC's reply.

    With ``serving.endpoint`` (one ``host:port`` or a comma-separated list
    of replicas) the requests dial an InferenceService over TCP and name
    their model ``'<serving.line>@<mid>'``: a dead replica is down-marked
    and rotates to the next, and only with every one down does the worker
    degrade. With ``serving.fleet.resolver`` the rotation is the fleet's
    routable replicas, fetched from the resolver every
    ``serving.fleet.refresh_interval`` (a stale list outlives a resolver
    outage). The device of the degraded path is ``worker.device`` (default
    'cuda'); until it degrades, a worker never touches the card.
    """

    def __init__(self, conn, args: Dict[str, Any], namespace: int = 0):
        inf = dict(args.get('inference') or {})
        srv = dict(args.get('serving') or {})
        self.conn = conn
        self._args = args
        self.namespace = int(namespace)
        self.device = (args.get('worker') or {}).get('device', 'cuda')
        flt = dict(srv.get('fleet') or {})
        self.endpoint = str(srv.get('endpoint') or '')
        self._endpoints = [e.strip() for e in self.endpoint.split(',')
                           if e.strip()]
        self._resolver = str(flt.get('resolver') or '')
        self._resolver_refresh = max(0.5, float(flt.get('refresh_interval',
                                                        2.0)))
        self._resolver_next = 0.0      # the next fleet-table fetch
        self._remote_mode = bool(self._endpoints or self._resolver)
        self._line = str(srv.get('line', 'default'))
        self._remote = None            # the lazy link to a service replica
        self._remote_ep = ''           # the endpoint self._remote targets
        self._ep_idx = 0               # rotation cursor over _endpoints
        self._ep_down: Dict[str, float] = {}     # endpoint -> retry at
        self._ep_backoff: Dict[str, Backoff] = {}
        self.timeout = max(0.05, float(inf.get('request_timeout', 10.0)))
        self.retries = max(0, int(inf.get('request_retries', 1)))
        self.failover = bool(inf.get('failover', True))
        self.vault_size = int(inf.get('vault_size', 3))
        self._backoff = Backoff(
            float(inf.get('reprobe_initial_delay', 2.0)),
            float(inf.get('reprobe_max_delay', 30.0)))
        self.engine_ok = True          # breaker closed: the engine path
        self._probe_at = 0.0           # breaker open: the next probe
        self._probing_rid: Optional[int] = None
        self._rid = 0
        self._pending: Dict[int, Dict[str, Any]] = {}   # rid -> request
        self._box: Dict[int, Dict[str, Any]] = {}       # rid -> early reply
        self._local_box: Dict[int, Dict[str, Any]] = {}  # rid -> local reply
        self._vault: Optional[ModelVault] = None
        self.stats = {key: 0 for key in _CLIENT_COUNTERS}
        self._m = {key: telemetry.counter(name)
                   for key, name in _CLIENT_COUNTERS.items()}
        self._m_path = telemetry.gauge('worker_inference_path')
        self._m_path.set(1.0)

    def _count(self, key: str):
        self.stats[key] += 1
        self._m[key].inc()

    # -- the worker's other RPCs (args / episode / result / model / chunk) --

    def rpc(self, msg):
        """send_recv that absorbs inference frames: a stale engine reply
        (the late answer to a request already failed over) is never taken
        for this RPC's reply."""
        self.conn.send(msg)
        while True:
            reply = self.conn.recv()
            if is_infer(reply):
                self._absorb(reply[1] if isinstance(reply[1], dict) else {})
                continue
            return reply

    # -- request submission ------------------------------------------------

    def send(self, mid: int, body: Dict[str, Any]) -> int:
        """Submit one inference request; returns its request id. Routed to
        the engine while the breaker is closed (or as the half-open probe),
        served locally otherwise."""
        self._rid += 1
        rid = self._rid
        rec = dict(body)
        rec['mid'] = int(mid)
        engine_path = self.engine_ok
        if (not engine_path and self.failover and self._probing_rid is None
                and time.monotonic() >= self._probe_at):
            engine_path = True          # half-open: one probe in flight
            self._probing_rid = rid
            _LOG.info('worker %d: probing the inference engine (rid %d)',
                      self.namespace, rid)
        if engine_path:
            self._pending[rid] = rec
            if not self._send_engine(rid, rec):
                # every service replica refused the frame: fail over now
                # instead of waiting out the deadline on dead sockets
                self._local_box[rid] = self._fail(
                    rid, rec, 'service endpoint(s) %s unreachable'
                    % (self.endpoint or self._resolver))
        else:
            self._local_box[rid] = self._local_reply(rec)
        return rid

    def recv(self, rid: int) -> Dict[str, Any]:
        """The reply to ``rid``: deadline-bounded with bounded resends on
        the engine path, at once on the degraded local path."""
        if rid in self._local_box:
            return self._local_box.pop(rid)
        rec = self._pending.get(rid)
        if rec is None:
            raise RuntimeError('unknown inference request id %r' % rid)
        err = 'no reply within %.1fs' % self.timeout
        # a probe gets one deadline and no resends: it tests the engine
        # cheaply instead of waiting retries x timeout on a dead one
        attempts = 1 + (0 if self._probing_rid == rid else self.retries)
        for attempt in range(attempts):
            reply = self._box.pop(rid, None)
            if reply is None:
                reply = self._await(rid, self.timeout)
            if reply is None:                     # the deadline passed
                self._count('timeouts')
                if attempt + 1 < attempts:
                    # a silent replica is down-marked before the resend so
                    # that the redial rotates (a no-op on the gather pipe);
                    # the resend keeps the rid, so a second reply to it is
                    # absorbed as stale
                    self._drop_remote()
                    if not self._send_engine(rid, rec):
                        break                     # a dead service: fail now
                continue
            if reply.get('error'):
                self._count('errors')
                err = str(reply['error'])
                break
            self._settle_ok(rid)
            out = map_structure(_canon, reply)
            if isinstance(out.get('prob'), float):
                # the socket codec hands numpy scalars over as Python
                # floats; a record keeps the dtype or it pickles to other
                # bytes than the local path's
                out['prob'] = np.float32(out['prob'])
            return out
        return self._fail(rid, rec, err)

    # -- internals ---------------------------------------------------------

    def _refresh_endpoints(self):
        """Replace the rotation with the fleet resolver's routable replicas
        (when one is configured); a resolver failure keeps the stale list,
        so that the data plane outlives it."""
        now = time.monotonic()
        if not self._resolver or now < self._resolver_next:
            return
        self._resolver_next = now + self._resolver_refresh
        from .serving.client import ServiceClient, parse_endpoint
        try:
            host, port = parse_endpoint(self._resolver)
            probe = ServiceClient(host, port, timeout=2.0, dial_retries=0)
            try:
                table = probe.fleet(timeout=2.0).get('replicas') or []
            finally:
                probe.close()
        except (OSError, ConnectionError, EOFError, ValueError,
                TimeoutError, RuntimeError):
            return
        fresh = [str(r.get('endpoint')) for r in table
                 if r.get('state') in ('healthy', 'degraded')
                 and not r.get('draining') and r.get('endpoint')]
        if fresh and sorted(fresh) != sorted(self._endpoints):
            _LOG.info('worker %d: fleet resolver lists %d routable '
                      'replica(s): %s', self.namespace, len(fresh),
                      ', '.join(fresh))
            self._endpoints = fresh

    def _pick_endpoint(self) -> str:
        """The next endpoint in rotation whose down-mark has expired; with
        every one down, the soonest retryable (so that a fleet-wide blip
        still probes)."""
        self._refresh_endpoints()
        if not self._endpoints:
            raise OSError('no service endpoints known (resolver %s has no '
                          'routable replicas)' % (self._resolver or '-'))
        now = time.monotonic()
        n = len(self._endpoints)
        for off in range(n):
            ep = self._endpoints[(self._ep_idx + off) % n]
            if self._ep_down.get(ep, 0.0) <= now:
                self._ep_idx = (self._ep_idx + off) % n
                return ep
        return min(self._endpoints, key=lambda e: self._ep_down.get(e, 0.0))

    def _infer_conn(self):
        """The connection engine frames ride: the gather pipe, or with
        ``serving.endpoint`` a lazily dialed TCP link to a replica."""
        if not self._remote_mode:
            return self.conn
        if self._remote is None:
            from .connection import connect_socket_connection
            ep = self._pick_endpoint()
            host, _, port = ep.rpartition(':')
            self._remote_ep = ep       # a failed dial down-marks it too
            self._remote = connect_socket_connection(host or 'localhost',
                                                     int(port))
            self._count('remote_dials')
            _LOG.info('worker %d: dialed inference service %s',
                      self.namespace, ep)
        return self._remote

    def _drop_remote(self):
        if self._remote is not None:
            try:
                self._remote.close()
            except OSError:
                pass
            self._remote = None
        ep = self._remote_ep
        if ep:
            # the down-mark expires on a per-endpoint backoff; the next
            # dial rotates to another replica meanwhile
            self._remote_ep = ''
            backoff = self._ep_backoff.setdefault(
                ep, Backoff(initial=0.5, maximum=15.0))
            self._ep_down[ep] = time.monotonic() + backoff.next_delay()
            if len(self._endpoints) > 1:
                self._count('endpoint_rotations')
                _LOG.warning('worker %d: service replica %s dropped; '
                             'rotating to the next endpoint',
                             self.namespace, ep)

    def _send_engine(self, rid: int, rec: Dict[str, Any]) -> bool:
        """Post one request on the engine path. False when no service
        replica took the frame (the caller fails the request over); on the
        gather pipe it never fails here (a dead pipe is fatal to the
        worker)."""
        body = {'rid': rid, **rec}
        if not self._remote_mode:
            self.conn.send((INFER_KIND, body))
            return True
        # the service resolves models by name against its registry; the
        # learner's publish hook registers epoch E as '<line>@<E>'
        body['model'] = '%s@%d' % (self._line, int(rec['mid']))
        # one attempt a known replica (one to fetch the resolver's table
        # when none is known yet): False only when the whole fleet refused
        for _attempt in range(max(1, len(self._endpoints))):
            try:
                self._infer_conn().send((INFER_KIND, body))
                return True
            except (OSError, ConnectionError, EOFError, ValueError):
                self._drop_remote()
        return False

    def _await(self, rid: int, timeout: float) -> Optional[Dict[str, Any]]:
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                conn = self._infer_conn()
                if not conn.poll(remaining):
                    return None
                msg = conn.recv()
            except (OSError, ConnectionError, EOFError):
                if not self._remote_mode:
                    raise          # a dead gather pipe is fatal
                self._drop_remote()
                return None        # a timeout: resend or fail over
            if not is_infer(msg):
                raise ConnectionError(
                    'unexpected %s frame while awaiting an inference reply'
                    % type(msg).__name__)
            body = msg[1] if isinstance(msg[1], dict) else {}
            if body.get('rid') == rid:
                return body
            self._absorb(body)

    def _absorb(self, body: Dict[str, Any]):
        rid = body.get('rid')
        if rid in self._pending:
            self._box[rid] = body      # an early reply for a later recv()
        else:
            self._count('stale_replies')   # to an abandoned request

    def _settle_ok(self, rid: int):
        self._pending.pop(rid, None)
        if self._remote_ep:
            # the replica answered: clear its down-mark and backoff
            self._ep_down.pop(self._remote_ep, None)
            self._ep_backoff.pop(self._remote_ep, None)
        if self._probing_rid == rid:
            self._probing_rid = None
        if not self.engine_ok:
            self.engine_ok = True      # re-promotion: the breaker closes
            self._backoff.reset()
            self._count('repromotions')
            self._m_path.set(1.0)
            _LOG.warning('worker %d: the engine answered the probe; '
                         're-promoted to engine inference', self.namespace)

    def _fail(self, rid: int, rec: Dict[str, Any], err: str
              ) -> Dict[str, Any]:
        self._pending.pop(rid, None)
        probing = self._probing_rid == rid
        if probing:
            self._probing_rid = None
        if not self.failover:
            raise RuntimeError('inference engine: %s' % err)
        now = time.monotonic()
        self._probe_at = now + self._backoff.next_delay()
        if self.engine_ok:
            self.engine_ok = False     # the breaker opens
            self._count('failovers')
            self._m_path.set(0.0)
            _LOG.warning('worker %d: engine unreachable (%s); degrading to '
                         'per-worker inference', self.namespace, err)
            # the rest of the in-flight burst goes local too: waiting out
            # each one's deadline would stall the episode (their late
            # replies are absorbed as stale)
            for orid in [r for r in self._pending if r not in self._box]:
                self._local_box[orid] = self._local_reply(
                    self._pending.pop(orid))
        elif probing:
            _LOG.info('worker %d: engine probe failed (%s); next probe in '
                      '%.1fs', self.namespace, err, self._probe_at - now)
        return self._local_reply(rec)

    # -- the degraded path: per-worker inference, replayed from the request

    def _local_model(self, mid: int):
        if self._vault is None:
            self._vault = ModelVault(
                lambda m: self.rpc(('model', m)),
                example_observation(self._args['env']),
                capacity=self.vault_size, device=self.device)
            _LOG.info('worker %d: materialized a local model vault on %s '
                      'for the degraded inference path', self.namespace,
                      self._vault._device)
        return self._vault.model(mid)

    def _local_reply(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        """Serve one request on the per-worker path with exactly the inputs
        the engine would have seen: the reply equals the engine's bit for
        bit, so records do not fork."""
        self._count('local_inferences')
        model = self._local_model(rec['mid'])
        hidden = rec.get('hidden')
        if hidden is None:
            hidden = model.init_hidden()   # the engine's substitution
        if rec.get('legal') is None:
            return {'outputs': bucketed_inference(model, rec['obs'], hidden)}
        return model_act(model, rec['obs'], hidden, rec['legal'], rec['seed'])


class RemoteModel:
    """A worker's model handle in engine mode: calls become engine request
    frames through the shared :class:`EngineClient`; it holds no params.

    ``init_hidden`` returns None: both serving paths substitute a fresh
    initial state for a None hidden, so the worker needs no knowledge of
    the recurrent state's structure."""

    def __init__(self, client: EngineClient, model_id: int):
        self.client = client
        self.model_id = int(model_id)

    def init_hidden(self, batch_shape=None):
        return None

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        """The full-output forward (observer plies, evaluation agents)."""
        rid = self.client.send(self.model_id, {'obs': obs, 'hidden': hidden})
        return self.client.recv(rid)['outputs']

    def act(self, obs, hidden, legal_actions, seed_seq) -> Dict[str, Any]:
        """Masked sampling in one round trip: the sampled action, its
        probability, the action mask, value and the next hidden state."""
        return self.act_recv(self.act_send(obs, hidden, legal_actions,
                                           seed_seq))

    # the split act: a generator submits every simultaneous-turn request
    # before it collects any reply, so one worker's ply lands in one tick
    def act_send(self, obs, hidden, legal_actions, seed_seq) -> int:
        return self.client.send(self.model_id, {
            'obs': obs, 'hidden': hidden,
            'legal': [int(a) for a in legal_actions],
            'seed': [int(s) for s in seed_seq]})

    def act_recv(self, rid: int) -> Dict[str, Any]:
        return self.client.recv(rid)


class RemoteModelCache:
    """The engine-mode stand-in for a worker's :class:`ModelVault`: the
    same ``obtain``, its entries weightless :class:`RemoteModel` handles
    sharing one :class:`EngineClient`."""

    def __init__(self, client, capacity: int = 8):
        self.client = client
        self._capacity = max(1, int(capacity))
        self._slots: OrderedDict = OrderedDict()

    def obtain(self, wanted: Dict[Any, Optional[int]]) -> Dict[Any, Any]:
        out = {}
        for player, mid in wanted.items():
            if mid is None or mid < 0:
                out[player] = None
                continue
            if mid not in self._slots:
                while len(self._slots) >= self._capacity:
                    self._slots.popitem(last=False)
                self._slots[mid] = RemoteModel(self.client, mid)
            self._slots.move_to_end(mid)
            out[player] = self._slots[mid]
        return out


# ---------------------------------------------------------------------------
# host side: the engine and its supervisor


class _ChaosEngineKill(RuntimeError):
    """An injected engine crash (HANDYRL_TPU_CHAOS enginekill=)."""


class InferenceEngine:
    """Coalescing batched-inference server on one device.

    ``submit(endpoint, request)`` may be called from any thread; one engine
    thread drains the queue in ticks. A tick dispatches when ``max_batch``
    requests are pending, when ``batch_wait_ms`` has passed since the
    oldest arrival, or when the queue has gone quiet with at least
    ``clients`` requests waiting (see :meth:`_collect`). Without
    ``example_obs`` the vault's example observation comes from a fresh
    env of ``args['env']``, built on the engine thread at its first
    request. ``buckets`` counts the forwards by their padded row count
    (the N that K1's serving form ran at)."""

    def __init__(self, args: Dict[str, Any], fetch_snapshot: Callable,
                 reply_fn: Callable, example_obs=None,
                 clients: Optional[int] = None, device: Any = 'cuda'):
        inf = dict(args.get('inference') or {})
        self.batch_wait = max(0.0, float(inf.get('batch_wait_ms', 2.0))) / 1e3
        self.max_batch = max(1, int(inf.get('max_batch', 64)))
        self.vault_size = int(inf.get('vault_size', 3))
        self.queue_max = max(0, int(inf.get('queue_max', 1024)))
        self.clients = clients
        self.device = resolve_device(device)
        self._args = args
        self._fetch = fetch_snapshot
        self._example_obs = example_obs
        self.vault: Optional[ModelVault] = None   # built on the engine thread
        self._reply = reply_fn
        self._cv = threading.Condition()
        # intake entries are (endpoint, request, t_arrival)
        self._queue: deque = deque()              # guarded-by: _cv
        self._stop = False                        # guarded-by: _cv
        self._current: List[tuple] = []           # guarded-by: _cv
        self._thread: Optional[threading.Thread] = None
        # the watchdog's surface: tick progress, the tick in flight
        self.started_at = time.monotonic()
        self.last_progress = time.monotonic()
        self.crashed: Optional[BaseException] = None
        self._fault: Optional[tuple] = None       # (kind, due_at, stall_s)
        self.requests_served = 0
        self.batches_run = 0
        self.sheds = 0
        self.buckets: Dict[int, int] = {}         # padded rows -> forwards
        self._m_requests = telemetry.counter('engine_requests_total')
        self._m_batches = telemetry.counter('engine_batches_total')
        self._m_rows = telemetry.histogram(
            'engine_batch_rows', buckets=telemetry.BATCH_ROW_BUCKETS)
        self._m_wait = telemetry.histogram('engine_coalesce_seconds')
        self._m_depth = telemetry.gauge('engine_queue_depth')
        self._m_fill = telemetry.gauge('engine_batch_fill_ratio')
        self._m_shed = telemetry.counter('engine_shed_total')
        self._m_errors = telemetry.counter('engine_error_replies_total')
        self._m_leaked = telemetry.counter('engine_stop_leaked_total')

    # -- lifecycle --------------------------------------------------------

    def start(self) -> 'InferenceEngine':
        self.started_at = self.last_progress = time.monotonic()
        self._thread = threading.Thread(target=self._run,
                                        name='inference-engine', daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0):
        with self._cv:
            self._stop = True
            queued = len(self._queue)
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                # a wedged loop (a stuck forward, a hung snapshot fetch)
                # outlives the join: the leak is counted and logged
                self._m_leaked.inc()
                _LOG.warning('engine: loop thread still running %.1fs after '
                             'stop() (last progress %.1fs ago, %d queued); '
                             'leaking it', timeout, self.progress_age(),
                             queued)

    def abandon(self):
        """Mark the engine stopped without joining (the supervisor's restart
        of a wedged engine: the zombie exits at its next loop boundary, if
        any, and the generation tag drops its replies)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def thread_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the watchdog's surface ------------------------------------------

    def progress_age(self) -> float:
        """Seconds since the engine thread last showed progress."""
        return time.monotonic() - self.last_progress

    def busy(self) -> bool:
        """True while the engine holds work a stalled thread would strand."""
        with self._cv:
            return bool(self._queue) or bool(self._current)

    def batch_fill_ratio(self) -> float:
        """Mean requests a dispatched forward (1.0: no coalescing gain over
        per-worker forwards)."""
        return self.requests_served / max(1, self.batches_run)

    def drain_pending(self) -> List[tuple]:
        """Remove and return every queued and in-flight item (the
        supervisor's restart: the caller answers them)."""
        with self._cv:
            items = list(self._current) + list(self._queue)
            self._queue.clear()
            self._current = []
            self._m_depth.set(0)
            self._cv.notify_all()
        return items

    # -- chaos (HANDYRL_TPU_CHAOS enginekill= / enginestall=) -------------

    def arm_fault(self, kind: str, delay: float, stall_secs: float = 3600.0):
        """Schedule one injected fault: 'kill' raises out of the tick loop
        (a crashed engine), 'stall' sleeps inside it holding the tick's
        requests (a wedged forward or snapshot fetch)."""
        self._fault = (kind, time.monotonic() + max(0.0, delay),
                       float(stall_secs))

    def _maybe_chaos(self):
        if self._fault is None or time.monotonic() < self._fault[1]:
            return
        kind, _due, stall_secs = self._fault
        self._fault = None
        if kind == 'kill':
            raise _ChaosEngineKill('chaos: engine kill injected')
        _LOG.warning('chaos: engine stall injected (%.0fs)', stall_secs)
        time.sleep(stall_secs)

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
        """Error-answer every queued and in-flight request (the crash
        fan-out): no submitter waits on a reply the engine will never
        send."""
        items = self.drain_pending()
        for ep, req, _t in items:
            self._m_errors.inc()
            self._safe_reply(ep, {'rid': (req or {}).get('rid'),
                                  'error': reason, 'engine_fault': True})
        return len(items)

    def _ensure_vault(self):
        if self.vault is None:
            example_obs = self._example_obs
            if example_obs is None:
                example_obs = example_observation(self._args['env'])
            self.vault = ModelVault(self._fetch, example_obs,
                                    capacity=self.vault_size,
                                    device=self.device)

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
                self.last_progress = time.monotonic()   # idle, not stalled
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
        self.last_progress = time.monotonic()
        return items

    def _run(self):
        """Thread body: the tick loop plus the fatal-error fan-out. A
        group's failure is answered inline and the engine goes on; what
        escapes the loop error-answers everything still in flight and
        marks the engine crashed, for the supervisor to restart."""
        try:
            self._loop()
        except BaseException as exc:   # noqa: BLE001 — crash containment
            self.crashed = exc
            _LOG.error('engine: fatal %s: %s', type(exc).__name__,
                       str(exc)[:200])
            if not isinstance(exc, _ChaosEngineKill):
                _LOG.error('%s', traceback.format_exc())
            failed = self.fail_pending('inference engine crashed (%s: %s)'
                                       % (type(exc).__name__, str(exc)[:200]))
            if failed:
                _LOG.warning('engine: error-answered %d in-flight '
                             'request(s) after the crash', failed)

    def _loop(self):
        while True:
            items = self._collect()
            if items is None:
                return
            self._maybe_chaos()
            groups: Dict[int, List[tuple]] = {}
            for item in items:
                groups.setdefault(int(item[1]['mid']), []).append(item)
            for mid, group in groups.items():
                try:
                    self._serve(mid, group)
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
                self.last_progress = time.monotonic()
            with self._cv:
                self._current = []

    def _serve(self, mid: int, group: List[tuple]):
        """One coalesced forward inside an ``engine_batch`` span (a
        rate-sampled trace event and the stage_seconds histogram), after a
        ``queue_wait`` event (intake to batch start) for each request with
        a sampled trace id; the batch span then carries their ids."""
        extra: Dict[str, Any] = {}
        if telemetry.trace_enabled():
            now_mono, now_wall = time.monotonic(), time.time()
            tids = []
            for _ep, req, t_arr in group:
                tid = req.get('trace')
                if not (tid and telemetry.trace_sampled(tid)):
                    continue
                tids.append(tid)
                wait = max(0.0, now_mono - t_arr)
                telemetry.trace_event('queue_wait', ts=now_wall - wait,
                                      dur=wait, trace_id=tid, mid=mid)
            if tids:
                extra = {'trace_ids': tids, 'always': True}
        with telemetry.trace_span('engine_batch', rows=len(group), mid=mid,
                                  **extra):
            self._serve_group(mid, group)

    def _serve_group(self, mid: int, group: List[tuple]):
        self._ensure_vault()
        model = self.vault.model(mid)
        reqs = [req for _ep, req, _t in group]
        rows = len(reqs)
        self.requests_served += rows
        self.batches_run += 1
        self._m_requests.inc(rows)
        self._m_batches.inc()
        self._m_rows.observe(rows)
        self._m_fill.set(self.batch_fill_ratio())

        if isinstance(model, RandomModel):
            # id 0: zero outputs, no forward: masked sampling over a zero
            # policy is the uniform play RandomModel stands for
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
            init = getattr(model, '_engine_h0', _UNSET)
            if init is _UNSET:
                init = model.init_hidden()
                model._engine_h0 = init
            hidden_batch = None
            if init is not None:
                hidden_batch, _ = pad_to_bucket(
                    [r.get('hidden') if r.get('hidden') is not None else init
                     for r in reqs])
            bucket = bucket_rows(rows)
            self.buckets[bucket] = self.buckets.get(bucket, 0) + 1
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


class EngineSupervisor:
    """The watchdog and restart policy around :class:`InferenceEngine`:
    what a gather owns. A monitor thread checks the engine's tick progress
    on a short cadence:

    * **crash**: the engine thread died (its own fan-out answered what it
      held); the engine restarts after a :class:`~.fault.Backoff` delay
      (reset once an engine lives ``RESET_AFTER`` seconds).
    * **stall**: the engine is ``busy()`` with no tick progress for
      ``inference.stall_timeout`` seconds (a wedged forward, a hung
      snapshot fetch). A thread cannot be killed, so it is abandoned: the
      generation counter advances (a zombie's late reply is dropped, so no
      request is answered twice), every queued and in-flight request is
      error-answered, and a fresh engine starts.

    While the engine is down (the backoff window) ``submit`` answers at
    once with an error, so workers fail over at once instead of waiting
    out a deadline. Its counts sum over every engine it ran.

    Chaos: ``HANDYRL_TPU_CHAOS=enginekill=<mean s>`` and ``enginestall=<mean
    s>`` arm one fault an engine incarnation (the kinds alternate when
    both are set) on an exponential clock, at most ``engine_max_faults=<n>``
    in all; ``enginestall_secs=<s>`` is the stall's length (default 3600).

    Each restart is recorded in the flight recorder (``record_event``)
    and dumped as a blackbox (``engine-<reason>``) once the new engine
    is up, where the JAX supervisor dumps before its backoff.
    """

    RESET_AFTER = 60.0   # an engine alive this long resets the backoff

    def __init__(self, args: Dict[str, Any], fetch_snapshot: Callable,
                 reply_fn: Callable, clients: Optional[int] = None,
                 example_obs=None, chaos: Optional[Dict[str, float]] = None,
                 device: Any = 'cuda'):
        inf = dict(args.get('inference') or {})
        self.stall_timeout = max(0.2, float(inf.get('stall_timeout', 30.0)))
        self.device = resolve_device(device)
        self._args = args
        self._fetch = fetch_snapshot
        self._reply_raw = reply_fn
        self._clients = clients
        self._example_obs = example_obs
        self._chaos = parse_chaos() if chaos is None else dict(chaos)
        self._faults_left = int(self._chaos.get('engine_max_faults', 1 << 30))
        self._fault_cycle = 0
        self._chaos_rng = random.Random(
            int(self._chaos.get('seed', 0)) * 104729 + 13)
        self._backoff = Backoff(0.5, float(inf.get('restart_max_delay', 10.0)))
        self._lock = threading.RLock()
        self._gen = 0
        self._stopping = False
        self._served_total = 0
        self._batches_total = 0
        self._sheds_total = 0
        self._buckets_total: Dict[int, int] = {}
        self.restarts = 0
        self.restarts_by_reason = {'crash': 0, 'stall': 0}
        self.stale_replies = 0
        self._m_restarts = {
            reason: telemetry.counter('engine_restarts_total', reason=reason)
            for reason in ('crash', 'stall')}
        self._m_stale = telemetry.counter('engine_stale_replies_total')
        self._spawned_at = time.monotonic()
        self.engine: Optional[InferenceEngine] = self._spawn()
        self._thread = threading.Thread(target=self._watch,
                                        name='engine-supervisor', daemon=True)
        self._thread.start()

    # -- counts over every engine ----------------------------------------

    @property
    def requests_served(self) -> int:
        engine = self.engine
        return self._served_total + (engine.requests_served if engine else 0)

    @property
    def batches_run(self) -> int:
        engine = self.engine
        return self._batches_total + (engine.batches_run if engine else 0)

    @property
    def sheds(self) -> int:
        engine = self.engine
        return self._sheds_total + (engine.sheds if engine else 0)

    def batch_fill_ratio(self) -> float:
        return self.requests_served / max(1, self.batches_run)

    def buckets(self) -> Dict[int, int]:
        out = dict(self._buckets_total)
        engine = self.engine
        for n, k in (dict(engine.buckets) if engine else {}).items():
            out[n] = out.get(n, 0) + k
        return out

    def stats(self) -> Dict[str, Any]:
        """The counts a gather's beacon carries."""
        return {'requests': self.requests_served,
                'batches': self.batches_run,
                'fill_ratio': self.batch_fill_ratio(),
                'sheds': self.sheds, 'restarts': self.restarts,
                'restarts_by_reason': dict(self.restarts_by_reason),
                'stale_replies': self.stale_replies,
                'buckets': {str(n): k
                            for n, k in sorted(self.buckets().items())},
                'device': str(self.device)}

    # -- lifecycle ---------------------------------------------------------

    def _tagged(self, gen: int) -> Callable:
        """A reply function bound to one engine incarnation: a reply of an
        abandoned engine (an older generation) is dropped, since the
        restart's fan-out already answered its request."""
        def reply(ep, msg):
            if gen == self._gen:
                self._reply_raw(ep, msg)
            else:
                self.stale_replies += 1
                self._m_stale.inc()
        return reply

    def _spawn(self) -> InferenceEngine:
        self._gen += 1
        engine = InferenceEngine(
            self._args, fetch_snapshot=self._fetch,
            reply_fn=self._tagged(self._gen), example_obs=self._example_obs,
            clients=self._clients, device=self.device)
        self._arm_chaos(engine)
        self._spawned_at = time.monotonic()
        return engine.start()

    def _arm_chaos(self, engine: InferenceEngine):
        kinds = [k for k in ('enginekill', 'enginestall')
                 if self._chaos.get(k)]
        if not kinds or self._faults_left <= 0:
            return
        kind = kinds[self._fault_cycle % len(kinds)]
        self._fault_cycle += 1
        self._faults_left -= 1
        delay = self._chaos_rng.expovariate(1.0 / float(self._chaos[kind]))
        engine.arm_fault('kill' if kind == 'enginekill' else 'stall', delay,
                         stall_secs=float(self._chaos.get('enginestall_secs',
                                                          3600.0)))
        _LOG.warning('chaos: armed engine %s in ~%.1fs (%d fault(s) left)',
                     kind, delay, self._faults_left)

    def submit(self, endpoint, request: Dict[str, Any]):
        with self._lock:
            engine = self.engine
        if engine is None:    # the restart's backoff window: fail fast
            self._reply_raw(endpoint, {
                'rid': (request or {}).get('rid'), 'engine_fault': True,
                'error': 'inference engine restarting'})
            return
        engine.submit(endpoint, request)

    def stop(self):
        self._stopping = True
        with self._lock:
            engine = self.engine
        if engine is not None:
            engine.stop()
        self._thread.join(timeout=5.0)

    # -- the watchdog ------------------------------------------------------

    def _watch(self):
        interval = max(0.1, min(1.0, self.stall_timeout / 4))
        while not self._stopping:
            time.sleep(interval)
            with self._lock:
                engine = self.engine
            if engine is None or self._stopping:
                continue
            reason = None
            if engine.crashed is not None or not engine.thread_alive():
                reason = 'crash'
            elif (engine.busy()
                    and engine.progress_age() > self.stall_timeout):
                reason = 'stall'
            if reason is None:
                if time.monotonic() - self._spawned_at > self.RESET_AFTER:
                    self._backoff.reset()
                continue
            self._restart(engine, reason)

    def _restart(self, engine: InferenceEngine, reason: str):
        with self._lock:
            if self.engine is not engine:
                return
            self.engine = None
            self._gen += 1            # a zombie's replies are dropped now
        engine.abandon()
        self._served_total += engine.requests_served
        self._batches_total += engine.batches_run
        self._sheds_total += engine.sheds
        for n, k in dict(engine.buckets).items():
            self._buckets_total[n] = self._buckets_total.get(n, 0) + k
        # the fan-out goes through the raw reply path: the engine's own
        # (tagged) reply function is already muted by the generation bump
        stranded = engine.drain_pending()
        for ep, req, _t in stranded:
            try:
                self._reply_raw(ep, {'rid': (req or {}).get('rid'),
                                     'engine_fault': True,
                                     'error': 'inference engine %s; '
                                              'restarting' % reason})
            except Exception as exc:   # a gone endpoint: nothing to answer
                _LOG.debug('engine restart: reply dropped (%s)', exc)
        self.restarts += 1
        self.restarts_by_reason[reason] += 1
        self._m_restarts[reason].inc()
        telemetry.record_event('supervisor', 'engine %s declared' % reason,
                               restarts=self.restarts,
                               stranded=len(stranded))
        delay = self._backoff.next_delay()
        _LOG.warning('engine %s detected (progress %.1fs ago, %d request(s) '
                     'error-answered); restarting in %.1fs',
                     reason, engine.progress_age(), len(stranded), delay)
        time.sleep(delay)
        with self._lock:
            if not self._stopping:
                self.engine = self._spawn()
        # the dump (a synchronous, fsync'd file) once the new engine
        # serves, off the restart's path
        telemetry.dump_blackbox('engine-' + reason, restarts=self.restarts,
                                stranded=len(stranded))
