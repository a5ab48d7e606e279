"""The match gateway: game sessions over the stateless replica fleet, the
port of ``handyrl_tpu/serving/gateway.py`` on its wire.

The fleet (:mod:`.fleet`) serves pure per-ply inference; a product runs
*matches*. A client opens a session naming an env and a
``line@selector``; the :class:`MatchGateway` builds the env on the host,
steps every opponent seat through the fleet (:class:`~.fleet.RoutedClient`)
and caches the seats' recurrent hidden state by session, so a client ply
is one round trip and a session's plies meet in one engine's batch (the
affinity of :class:`~..fault.SessionLedger`).

Every session keeps a **journal**: the env and the audited seed that
built it, the model spec *pinned* to a concrete ``line@version`` at open
(a champion flip mid-match never forks the opponent), every step's
actions, and a digest of the cached hidden state. Inference is pure in
``(model@version, obs, hidden, legal, seed)``, so the journal alone
rebuilds a match:

* **drain -> handoff.** A draining replica's sessions are re-pinned to a
  survivor with no ply replayed: the hidden cache is the gateway's and
  rides the next request.
* **SIGKILL -> reconstruct.** The monitor rebuilds each stranded session
  from its journal: a fresh env from ``(env, seed)`` and every journaled
  opponent ply replayed through a survivor with its audited seed. The
  replayed actions must equal the journal's and the rebuilt hidden
  digest its digest, byte for byte; the rebuilt state is then adopted
  and play goes on from it. A divergence counts a mismatch and drops the
  session, loudly.

Finished matches are booked into the league's
:class:`~..league.RatingBook` (external players as provisional
``gateway:<client>`` members, the served model as its ``line@version``
entry) and its journal. Admission control sheds opens, never plies. The
opponents' seeds are :func:`~..generation.sample_seed` draws under
``GATEWAY_SEED_NAMESPACE``, so a replay is a pure function of the
journal. A reply's hidden state is numpy from the engine (it turns the
device's tensors into numpy at the reply), so digests are of the same
bytes on every path.

Telemetry: the gateway's counters and gauges, an alert engine
(``session_drop``, ``gateway_ply_slo``) and, with
``serving.gateway.metrics_port``, a Prometheus exporter whose
``/statusz`` carries the session table. A session's trace id (the
client's, else minted at open) links its ``gateway_open``,
``gateway_reconstruct`` and ``gateway_handoff`` spans; each ply's own id
runs through ``gateway_ply`` and ``gateway_seat`` into the router and the
replica. A trace id rides only the request bodies: never the journal,
the digest or a reply. A dropped session leaves a ``session_drop`` event
in the flight recorder.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import socket
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from .. import telemetry
from ..connection import (FramedConnection, Hub, TRACE_KEY,
                          open_socket_connection)
from ..environment import make_env
from ..fault import HOST_DEGRADED, HOST_HEALTHY, SessionLedger
from ..generation import sample_seed
from ..guard import PREEMPT_EXIT_CODE, PreemptionGuard
from ..league import journal_path, make_rating_book
from .client import (SERVE_KIND, ServiceClient, ServiceError,
                     ServiceUnavailable, is_serve, parse_endpoint)
from .fleet import RoutedClient
from .service import ring_percentile_ms

_LOG = telemetry.get_logger('serving')

# The episode-key namespace of the gateway's draws (0 = generation, 1 =
# worker-local, 2 = evaluator, 3 = league). Draw 0 makes a session's env
# seed; the opponents' plies take draws 1, 2, ... in session order, so a
# journal replay takes the same sequence.
GATEWAY_SEED_NAMESPACE = 4

_ROUTABLE = (HOST_HEALTHY, HOST_DEGRADED)

# the gateway's tallies (its status reply) and their counters
_COUNTERS = {
    'opened': 'gateway_sessions_opened_total',
    'closed': 'gateway_sessions_closed_total',
    'dropped': 'gateway_session_drops_total',
    'shed': 'gateway_shed_total',
    'plies': 'gateway_plies_total',
    'outcomes': 'gateway_outcomes_total',
    'handoffs': 'gateway_handoffs_total',
    'reconstructs': 'gateway_reconstructs_total',
    'replayed_plies': 'gateway_replayed_plies_total',
    'mismatches': 'gateway_reconstruct_mismatch_total',
}


def _feed(h, node) -> None:
    if node is None:
        h.update(b'N')
    elif isinstance(node, dict):
        h.update(b'D')
        for k in sorted(node, key=str):
            h.update(str(k).encode('utf-8'))
            _feed(h, node[k])
    elif isinstance(node, (list, tuple)):
        h.update(b'L%d' % len(node))
        for v in node:
            _feed(h, v)
    elif isinstance(node, np.ndarray):
        h.update(b'A')
        h.update(str(node.dtype).encode('ascii'))
        h.update(str(node.shape).encode('ascii'))
        h.update(np.ascontiguousarray(node).tobytes())
    elif isinstance(node, (bytes, bytearray)):
        h.update(b'B')
        h.update(bytes(node))
    else:
        h.update(b'S')
        h.update(repr(node).encode('utf-8'))


def state_digest(state) -> str:
    """sha1 of a (nested) hidden state: the byte-identity witness the
    session journal carries."""
    h = hashlib.sha1()
    _feed(h, state)
    return h.hexdigest()


def session_env_seed(base_seed: int, counter: int) -> int:
    """A session's env seed: draw 0 of its audited sequence folded to one
    int (Hungry Geese seeds its ``random.Random(args['id'])`` from it)."""
    seq = sample_seed(int(base_seed),
                      (GATEWAY_SEED_NAMESPACE, int(counter)), 0)
    return int(np.random.default_rng(seq).integers(0, 2 ** 31 - 1))


class MatchSession:
    """One open match: the host-side env, the hidden cache of its
    opponent seats, and the journal that rebuilds both."""

    def __init__(self, sid: str, counter: int, env_name: str,
                 env_args: Dict[str, Any], env, model: str, seat: int,
                 base_seed: int, client: str, clock=time.time, trace=None):
        self.sid = sid
        self.counter = int(counter)
        self.env = env
        self.model = str(model)          # pinned line@version (or raw spec)
        self.seat = int(seat)
        self.client = str(client)
        self.base_seed = int(base_seed)
        self.opened_at = clock()
        self.last_active = self.opened_at
        self.lock = threading.Lock()
        self.hiddens: Dict[int, Any] = {}   # opponent seat -> cached hidden
        self.draws = 1                       # draw 0 made the env seed
        # the session's trace context: the id minted (or adopted) at open;
        # the reconstruct and handoff link spans carry it, so a failover
        # reads as one causal chain from the original open
        self.trace = trace
        self.lat_ring: deque = deque(maxlen=64)   # this session's plies (s)
        self.done = False
        self.outcome: Optional[Dict[int, float]] = None
        self.journal: Dict[str, Any] = {
            'sid': sid, 'counter': self.counter, 'env': str(env_name),
            'env_args': dict(env_args), 'model': self.model,
            'seat': self.seat, 'client': self.client,
            'base_seed': self.base_seed,
            'actions': [],                   # one {player: action} a step
            'hidden_digest': state_digest({}),
        }

    def plies(self) -> int:
        return len(self.journal['actions'])

    def summary(self, replica=None, clock=time.time) -> Dict[str, Any]:
        return {'sid': self.sid, 'env': self.journal['env'],
                'model': self.model, 'seat': self.seat,
                'client': self.client, 'plies': self.plies(),
                'version': self.model.rpartition('@')[2] or None,
                'ply_p99_ms': (ring_percentile_ms(list(self.lat_ring), 0.99)
                               if self.lat_ring else None),
                'age_s': round(clock() - self.opened_at, 3),
                'replica': replica, 'done': self.done}


class MatchGateway:
    """The session tier: a listener, a Hub and a worker pool over the
    fleet.

    ``args`` holds the service's blocks (``config.serving_args``) plus the
    base ``seed`` and the ``league`` block; the knobs ride
    ``serving.gateway``. ``status`` and ``sessions`` answer on the dispatch
    thread; ``open``, ``play`` and ``close`` run on the worker pool, each
    worker with a :class:`RoutedClient` of its own (one submitter an
    instance). A monitor thread watches the fleet table: a draining
    replica's sessions are handed off, a vanished one's rebuilt from their
    journals."""

    def __init__(self, args: Dict[str, Any]):
        srv = dict(args.get('serving') or {})
        gw = dict(srv.get('gateway') or {})
        flt = dict(srv.get('fleet') or {})
        self.port = int(gw.get('port', 0) or 0)
        self.host = str(srv.get('host') or '')
        self.workers_n = max(1, int(gw.get('workers', 4)))
        self.max_sessions = max(1, int(gw.get('max_sessions', 64)))
        self.ply_timeout = max(0.1, float(gw.get('ply_timeout', 15.0)))
        self.monitor_interval = max(0.05, float(gw.get('monitor_interval',
                                                       0.5)))
        self.session_timeout = max(1.0, float(gw.get('session_timeout',
                                                     600.0)))
        self.default_model = str(gw.get('model') or 'default@champion')
        self.resolver_endpoint = str(gw.get('resolver')
                                     or flt.get('resolver') or '')
        if not self.resolver_endpoint:
            raise ValueError('the match gateway needs a fleet resolver '
                             '(serving.gateway.resolver)')
        self.base_seed = int(args.get('seed', 0) or 0)
        root = srv.get('registry_dir') or args.get('model_dir', 'models')
        self.ratings = make_rating_book(args.get('league') or {})
        self._ratings_path = journal_path(str(root))
        self.ratings.load(self._ratings_path)
        self._ratings_lock = threading.Lock()

        self.ledger = SessionLedger()
        self._sessions: Dict[str, MatchSession] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self._counter = 0                              # guarded-by: _lock
        self._queue: queue.Queue = queue.Queue()
        self._tl = threading.local()
        self._routers: List[RoutedClient] = []         # guarded-by: _lock
        self._lat_ring: deque = deque(maxlen=512)      # guarded-by: _lock
        self._stop = False
        self._sock: Optional[socket.socket] = None
        self.hub: Optional[Hub] = None
        self._threads: List[threading.Thread] = []
        self.metrics_port = int(gw.get('metrics_port') or 0)
        self._exporter = None

        # this gateway's tallies, mirrored onto the process's counters
        self.counts = {key: 0 for key in _COUNTERS}     # guarded-by: _lock
        self._m = {key: telemetry.counter(name)
                   for key, name in _COUNTERS.items()}
        self._m_open_g = telemetry.gauge('gateway_sessions_open')
        self._m_age_g = telemetry.gauge('gateway_session_age_seconds')
        self._m_p99_g = telemetry.gauge('gateway_ply_p99_ms')
        self._m_ply_h = telemetry.histogram('gateway_ply_seconds')
        self._alerts = telemetry.AlertEngine.from_config(args)

    def _count(self, key: str, n: int = 1):
        with self._lock:
            self.counts[key] += n
        self._m[key].inc(n)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> 'MatchGateway':
        self._sock = open_socket_connection(self.port, self.host)
        self._sock.listen(self.max_sessions + 8)
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        self.hub = Hub()
        self._exporter, self.metrics_port = telemetry.start_exporter(
            self.metrics_port, self._status_info)
        loops = [(self._accept_loop, 'gateway-accept'),
                 (self._dispatch_loop, 'gateway-dispatch'),
                 (self._monitor_loop, 'gateway-monitor')]
        loops += [(self._worker_loop, 'gateway-worker-%d' % i)
                  for i in range(self.workers_n)]
        for target, name in loops:
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        _LOG.info('match gateway listening on port %d (resolver %s, '
                  '%d worker(s), max %d sessions)', self.port,
                  self.resolver_endpoint, self.workers_n,
                  self.max_sessions)
        return self

    def stop(self, drain: bool = True):
        """Stop admitting; with ``drain`` let the queued ops finish first
        (in worker time, bounded by the ply timeout). The sessions
        themselves live on in their journals."""
        if drain:
            deadline = time.monotonic() + min(self.ply_timeout, 30.0)
            while not self._queue.empty() and time.monotonic() < deadline:
                time.sleep(0.02)
        self._stop = True
        if self._sock is not None:
            self._sock.close()
        for t in self._threads:
            t.join(timeout=self.ply_timeout + 5.0)
        with self._lock:
            routers, self._routers = self._routers, []
        for r in routers:
            r.close()
        if self.hub is not None:
            self.hub.close()     # flushes the final replies first
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None

    # -- the per-thread fleet router ---------------------------------------

    def _new_router(self, name: str) -> RoutedClient:
        host, port = parse_endpoint(self.resolver_endpoint)
        r = RoutedClient(host, port, timeout=self.ply_timeout, name=name,
                         refresh_interval=self.monitor_interval)
        with self._lock:
            self._routers.append(r)
        return r

    def _router(self) -> RoutedClient:
        r = getattr(self._tl, 'router', None)
        if r is None:
            r = self._tl.router = self._new_router('gateway')
        return r

    # -- accept / dispatch -------------------------------------------------

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self.hub.attach(FramedConnection(conn), liveness=0)

    def _dispatch_loop(self):
        while not self._stop:
            try:
                ep, msg = self.hub.recv(timeout=0.3)
            except queue.Empty:
                continue
            try:
                if not is_serve(msg) or not isinstance(msg[1], dict):
                    self.hub.send(ep, (SERVE_KIND,
                                       {'error': 'unknown frame kind'}))
                    continue
                body = msg[1]
                op = body.get('op')
                if op == 'status':
                    self.hub.send(ep, (SERVE_KIND, self.stats()))
                elif op == 'sessions':
                    self.hub.send(ep, (SERVE_KIND,
                                       {'sessions': self.session_table()}))
                elif op == 'trace':
                    # runtime tracing switch: an A/B run flips the same
                    # warm gateway on and off between its legs
                    telemetry.configure_tracing(
                        str(body.get('dir') or ''), body.get('rate'),
                        force=True)
                    self.hub.send(ep, (SERVE_KIND,
                                       {'ok': True,
                                        'dir': telemetry.trace_dir(),
                                        'rate':
                                            telemetry.trace_sample_rate()}))
                elif op in ('open', 'play', 'close'):
                    self._queue.put((ep, body))
                else:
                    self.hub.send(ep, (SERVE_KIND,
                                       {'error': 'unknown gateway op %r'
                                                 % (op,)}))
            except Exception as exc:   # noqa: BLE001 — the loop must live
                _LOG.exception('gateway: dispatch error (%s: %s)',
                               type(exc).__name__, str(exc)[:200])

    def _worker_loop(self):
        while not self._stop:
            try:
                ep, body = self._queue.get(timeout=0.3)
            except queue.Empty:
                continue
            op = body.get('op')
            try:
                if op == 'open':
                    reply = self._op_open(body)
                elif op == 'play':
                    reply = self._op_play(body)
                else:
                    reply = self._op_close(body)
            except (ServiceError, ServiceUnavailable, TimeoutError) as exc:
                reply = {'error': '%s: %s' % (type(exc).__name__, exc)}
            except Exception as exc:   # noqa: BLE001 — answer, never drop
                _LOG.exception('gateway: %s failed (%s: %s)', op,
                               type(exc).__name__, str(exc)[:200])
                reply = {'error': '%s: %s' % (type(exc).__name__, exc)}
            self.hub.send(ep, (SERVE_KIND, reply))

    # -- session ops -------------------------------------------------------

    def _op_open(self, body: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                shed = True
            else:
                shed = False
                self._counter += 1
                counter = self._counter
        if shed:
            self._count('shed')
            return {'error': 'gateway full (%d sessions)'
                             % self.max_sessions, 'shed': True}
        env_name = str(body.get('env') or '')
        model = str(body.get('model') or self.default_model)
        seat = int(body.get('seat', 0))
        client = str(body.get('client') or 'anon')[:64]
        base_seed = int(body['seed']) if body.get('seed') is not None \
            else self.base_seed
        env_args = {'env': env_name,
                    'id': session_env_seed(base_seed, counter)}
        try:
            env = make_env(dict(env_args))
            env.reset()
        except Exception as exc:   # noqa: BLE001 — a bad env name or args
            return {'error': 'cannot build env %r: %s' % (env_name, exc)}
        if seat not in env.players():
            return {'error': 'seat %d not in players %s'
                             % (seat, env.players())}
        router = self._router()
        pinned = router._pin_spec(model)
        sid = 's%06d' % counter
        # the session's trace context: the client's id, else minted at
        # this edge; every ply, seat and reconstruct span links to it
        tid = body.get(TRACE_KEY) or (telemetry.mint_trace_id()
                                      if telemetry.trace_enabled() else None)
        t0 = time.time()
        session = MatchSession(sid, counter, env_name, env_args, env,
                               pinned, seat, base_seed, client, trace=tid)
        with self._lock:
            self._sessions[sid] = session
        with session.lock:
            self._advance(session, None, router, trace=tid)
            if router.last_replica is not None:
                self.ledger.book(sid, router.last_replica)
            reply = self._state_reply(session)
        if tid:
            telemetry.trace_event('gateway_open', ts=t0,
                                  dur=time.time() - t0, trace_id=tid,
                                  sid=sid, model=pinned, client=client)
        self._count('opened')
        self._set_gauges()
        reply.update({'sid': sid, 'seat': seat, 'model': pinned})
        if session.done:
            self._finish(session)
        return reply

    def _op_play(self, body: Dict[str, Any]) -> Dict[str, Any]:
        sid = str(body.get('sid') or '')
        with self._lock:
            session = self._sessions.get(sid)
        if session is None:
            return {'error': 'unknown session %r' % sid}
        router = self._router()
        # the ply's trace context: the client's id if it sent one, else a
        # fresh one; its span carries the session's open-time id as a link
        tid = body.get(TRACE_KEY) or (telemetry.mint_trace_id()
                                      if telemetry.trace_enabled() else None)
        t0 = time.monotonic()
        t0_wall = time.time()
        with session.lock:
            if session.done:
                return dict(self._state_reply(session), sid=sid)
            action: Optional[int] = None
            if session.seat in (int(p) for p in session.env.turns()):
                if body.get('action') is None:
                    return {'error': 'it is your turn in session %s; '
                                     'an action is required' % sid}
                action = int(body['action'])
                if action not in [int(a) for a in
                                  session.env.legal_actions(session.seat)]:
                    return {'error': 'illegal action %d in session %s'
                                     % (action, sid)}
            elif body.get('action') is not None:
                return {'error': 'not your turn in session %s' % sid}
            # no action here is a spectate poll (the client's seat is out
            # of the match, the game runs on): advance to its end
            before = session.plies()
            self._advance(session, action, router, trace=tid)
            played = session.journal['actions'][before:]
            if router.last_replica is not None:
                self.ledger.move(sid, router.last_replica)
            session.last_active = time.time()
            session.lat_ring.append(time.monotonic() - t0)
            reply = self._state_reply(session)
        dt = time.monotonic() - t0
        with self._lock:
            self._lat_ring.append(dt)
        self._count('plies')
        self._m_ply_h.observe(dt)
        if tid:
            telemetry.trace_event('gateway_ply', ts=t0_wall, dur=dt,
                                  trace_id=tid, sid=sid,
                                  session_trace=session.trace)
        reply.update({'sid': sid,
                      'actions': [{int(p): int(a) for p, a in step.items()}
                                  for step in played]})
        if session.done:
            self._finish(session)
        self._set_gauges()
        return reply

    def _op_close(self, body: Dict[str, Any]) -> Dict[str, Any]:
        sid = str(body.get('sid') or '')
        with self._lock:
            session = self._sessions.pop(sid, None)
        if session is None:
            return {'error': 'unknown session %r' % sid}
        self.ledger.release(sid)
        self._count('closed')
        self._set_gauges()
        return {'sid': sid, 'closed': True, 'done': session.done}

    def _state_reply(self, session: MatchSession) -> Dict[str, Any]:
        env = session.env
        out: Dict[str, Any] = {'done': bool(env.terminal())}
        if out['done']:
            session.done = True
            session.outcome = {int(p): float(s)
                               for p, s in env.outcome().items()}
            out['outcome'] = session.outcome
        else:
            out['obs'] = env.observation(session.seat)
            out['legal'] = [int(a)
                            for a in env.legal_actions(session.seat)] \
                if session.seat in env.turns() else []
            out['to_move'] = session.seat in env.turns()
        return out

    # -- the opponents' plies ----------------------------------------------

    def _advance(self, session: MatchSession, action: Optional[int],
                 router: RoutedClient, trace=None) -> None:
        """Step the env until it is the client's turn with no action in
        hand, or its end. Every step's actions land in the journal; the
        opponent seats act (and the observers watch) through the fleet in
        sorted seat order, so a journal replay takes the same audited-seed
        sequence."""
        env = session.env
        while not env.terminal():
            acting = sorted(int(p) for p in env.turns())
            watching = sorted(int(p) for p in env.observers())
            if session.seat in acting and action is None:
                break
            moves: Dict[int, int] = {}
            for p in acting:
                if p == session.seat:
                    moves[p] = int(action)
                    action = None
                else:
                    moves[p] = self._opponent_act(session, p, router,
                                                  trace)
            for p in watching:
                if p != session.seat:
                    self._opponent_watch(session, p, router, trace)
            env.step(moves)
            session.journal['actions'].append(
                {int(p): int(a) for p, a in moves.items()})
        session.journal['hidden_digest'] = state_digest(session.hiddens)

    def _seed_seq(self, session: MatchSession) -> List[int]:
        seq = sample_seed(session.base_seed,
                          (GATEWAY_SEED_NAMESPACE, session.counter),
                          session.draws)
        session.draws += 1
        return seq

    def _opponent_act(self, session: MatchSession, p: int,
                      router: RoutedClient, trace=None) -> int:
        env = session.env
        t0 = time.time()
        reply = router.request(
            session.model, env.observation(p),
            hidden=session.hiddens.get(p),
            legal=[int(a) for a in env.legal_actions(p)],
            seed=self._seed_seq(session), timeout=self.ply_timeout,
            replica=self.ledger.replica_of(session.sid), trace=trace)
        if trace:
            telemetry.trace_event('gateway_seat', ts=t0,
                                  dur=time.time() - t0, trace_id=trace,
                                  sid=session.sid, seat=p)
        session.hiddens[p] = reply.get('hidden')
        return int(reply['action'])

    def _opponent_watch(self, session: MatchSession, p: int,
                        router: RoutedClient, trace=None) -> None:
        env = session.env
        t0 = time.time()
        reply = router.request(
            session.model, env.observation(p),
            hidden=session.hiddens.get(p), timeout=self.ply_timeout,
            replica=self.ledger.replica_of(session.sid), trace=trace)
        if trace:
            telemetry.trace_event('gateway_seat', ts=t0,
                                  dur=time.time() - t0, trace_id=trace,
                                  sid=session.sid, seat=p, watch=True)
        session.hiddens[p] = (reply.get('outputs') or {}).get('hidden')

    # -- outcomes ----------------------------------------------------------

    def _finish(self, session: MatchSession):
        """Book the finished match into the RatingBook (the external
        player a provisional member, the served model its rated
        ``line@version`` entry) and retire the session."""
        with self._lock:
            live = self._sessions.pop(session.sid, None)
        self.ledger.release(session.sid)
        if live is None:      # closed or dropped meanwhile
            return
        score = (session.outcome or {}).get(session.seat, 0.0)
        score = min(max(0.5 * (1.0 + float(score)), 0.0), 1.0)
        player = 'gateway:%s' % session.client
        with self._ratings_lock:
            self.ratings.seed_provisional(player)
            self.ratings.record_between(player, session.model, score)
            try:
                self.ratings.save(self._ratings_path)
            except OSError as exc:
                _LOG.warning('gateway: rating journal write failed: %s',
                             exc)
        self._count('outcomes')
        self._count('closed')
        self._set_gauges()

    def _drop(self, session: MatchSession, reason: str):
        with self._lock:
            self._sessions.pop(session.sid, None)
        self.ledger.release(session.sid)
        self._count('dropped')
        telemetry.record_event('session_drop', session.sid, reason=reason)
        _LOG.error('gateway: dropped session %s (%s)', session.sid, reason)
        self._set_gauges()

    # -- journal reconstruction --------------------------------------------

    def _reconstruct(self, session: MatchSession,
                     router: RoutedClient) -> bool:
        """Rebuild a stranded session from its journal through a
        survivor: a fresh env from ``(env, seed)``, every opponent ply
        replayed with its audited seed. The replayed actions and the
        rebuilt hidden digest must match the journal; the rebuilt state is
        then adopted, so play goes on from proven state. False (and a
        drop) on a divergence. The link span carries the session's
        ORIGINAL open-time trace id, so a SIGKILL reads as one chain."""
        j = session.journal
        tid = session.trace
        t0 = time.time()

        def link(ok: bool, replayed: int):
            if tid:
                telemetry.trace_event('gateway_reconstruct', ts=t0,
                                      dur=time.time() - t0, trace_id=tid,
                                      link='reconstruct', sid=session.sid,
                                      replayed=replayed, ok=ok)

        env = make_env(dict(j['env_args']))
        env.reset()
        hiddens: Dict[int, Any] = {}
        draws = 1
        replayed = 0
        for step in list(j['actions']):
            step = {int(p): int(a) for p, a in step.items()}
            acting = sorted(int(p) for p in env.turns())
            watching = sorted(int(p) for p in env.observers())
            for p in acting:
                if p == j['seat']:
                    continue
                seq = sample_seed(j['base_seed'],
                                  (GATEWAY_SEED_NAMESPACE, j['counter']),
                                  draws)
                draws += 1
                reply = router.request(
                    j['model'], env.observation(p), hidden=hiddens.get(p),
                    legal=[int(a) for a in env.legal_actions(p)],
                    seed=seq, timeout=self.ply_timeout, trace=tid)
                hiddens[p] = reply.get('hidden')
                replayed += 1
                if int(reply['action']) != step.get(p):
                    self._count('mismatches')
                    link(False, replayed)
                    self._drop(session, 'reconstruct action mismatch at '
                                        'ply %d seat %d' % (replayed, p))
                    return False
            for p in watching:
                if p != j['seat']:
                    reply = router.request(j['model'], env.observation(p),
                                           hidden=hiddens.get(p),
                                           timeout=self.ply_timeout,
                                           trace=tid)
                    hiddens[p] = (reply.get('outputs') or {}).get('hidden')
            env.step(step)
        if state_digest(hiddens) != j['hidden_digest']:
            self._count('mismatches')
            link(False, replayed)
            self._drop(session, 'reconstruct hidden-digest mismatch')
            return False
        session.env = env
        session.hiddens = hiddens
        session.draws = draws
        self._count('reconstructs')
        self._count('replayed_plies', replayed)
        link(True, replayed)
        if router.last_replica is not None:
            self.ledger.move(session.sid, router.last_replica)
        _LOG.warning('gateway: reconstructed session %s (%d plies '
                     'replayed, digest verified)', session.sid, replayed)
        return True

    # -- fleet monitoring: handoff and reconstruction ----------------------

    def _monitor_loop(self):
        router: Optional[RoutedClient] = None
        known: Dict[str, Dict[str, Any]] = {}
        while not self._stop:
            time.sleep(self.monitor_interval)
            try:
                if router is None:
                    router = self._new_router('gateway-monitor')
                table = {str(r['replica']): r for r in router.replicas()}
            except (ServiceUnavailable, TimeoutError, ServiceError):
                continue
            survivors = [n for n, r in sorted(table.items())
                         if r.get('state') in _ROUTABLE
                         and not r.get('draining')]
            # drain -> handoff: no ply replayed, the hidden cache is ours
            # and rides the next request to the survivor
            for name, rec in table.items():
                if rec.get('draining') and rec.get('state') in _ROUTABLE:
                    self._handoff(name, survivors, reason='drain')
            # SIGKILL -> reconstruct: the replica left the table (run
            # elsewhere) or left the routable states (a managed corpse
            # walks healthy -> quarantined and is respawned under its old
            # name; its plies in flight died with it)
            dead = list(set(known) - set(table))
            dead += [name for name, rec in table.items()
                     if rec.get('state') not in _ROUTABLE]
            for name in dead:
                for sid in self.ledger.fail_replica(name, reason='killed'):
                    with self._lock:
                        session = self._sessions.get(sid)
                    if session is None:
                        continue
                    with session.lock:
                        if not session.done:
                            try:
                                self._reconstruct(session, router)
                            except (ServiceError, ServiceUnavailable,
                                    TimeoutError) as exc:
                                self._drop(session, 'reconstruct failed '
                                           '(%s: %s)' % (type(exc).__name__,
                                                         exc))
            known = table
            self._reap()
            self._set_gauges()
            if self._alerts is not None:
                self._alerts.poll()

    def _handoff(self, replica: str, survivors: List[str], reason: str):
        sids = self.ledger.sessions_on(replica)
        if not sids:
            return
        pool = [s for s in survivors if s != replica]
        if not pool:
            return      # nowhere to go yet; the next tick retries
        for i, sid in enumerate(sids):
            target = pool[i % len(pool)]
            self.ledger.move(sid, target)
            self._count('handoffs')
            with self._lock:
                session = self._sessions.get(sid)
            if session is not None and session.trace:
                # the link span, under the session's open-time id
                telemetry.trace_event('gateway_handoff',
                                      trace_id=session.trace,
                                      link='handoff', sid=sid,
                                      from_replica=replica,
                                      to_replica=target, reason=reason)
        _LOG.warning('gateway: handed %d session(s) off %s (%s)',
                     len(sids), replica, reason)

    def _reap(self):
        now = time.time()
        with self._lock:
            idle = [s for s in self._sessions.values()
                    if now - s.last_active > self.session_timeout]
        for session in idle:
            self._drop(session, 'session_timeout')

    # -- introspection -----------------------------------------------------

    def _set_gauges(self):
        now = time.time()
        with self._lock:
            n = len(self._sessions)
            oldest = max((now - s.opened_at
                          for s in self._sessions.values()), default=0.0)
            lats = list(self._lat_ring)
        self._m_open_g.set(float(n))
        self._m_age_g.set(float(oldest))
        self._m_p99_g.set(ring_percentile_ms(lats, 0.99))

    def session_table(self) -> List[Dict[str, Any]]:
        with self._lock:
            sessions = list(self._sessions.values())
        return [s.summary(replica=self.ledger.replica_of(s.sid))
                for s in sessions]

    def _status_info(self) -> Dict[str, Any]:
        """/statusz payload for the gateway metrics port: the live
        session table (``--status`` renders it), session and ply
        progress, and the gateway's alert state."""
        with self._lock:
            lats = list(self._lat_ring)
            counts = dict(self.counts)
        info: Dict[str, Any] = {
            'sessions': self.session_table(),
            'progress': {key: int(counts[key])
                         for key in ('opened', 'plies', 'outcomes',
                                     'handoffs', 'reconstructs',
                                     'dropped')},
            'slo': {'ply_p50_ms': ring_percentile_ms(lats, 0.50),
                    'ply_p99_ms': ring_percentile_ms(lats, 0.99)},
        }
        if self._alerts is not None:
            info['alerts'] = self._alerts.poll()
        return info

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n = len(self._sessions)
            lats = list(self._lat_ring)
            counts = dict(self.counts)
        return dict(counts, **{
            'gateway': True, 'port': self.port,
            'resolver': self.resolver_endpoint,
            'sessions': n, 'max_sessions': self.max_sessions,
            'ply_p50_ms': ring_percentile_ms(lats, 0.50),
            'ply_p99_ms': ring_percentile_ms(lats, 0.99),
            'ledger': dict(self.ledger.stats),
            'ratings': self.ratings.names()})


class GatewayClient:
    """A client of the match gateway: the session protocol over one
    :class:`ServiceClient` admin channel (``open``/``play``/``close`` round
    trips, one in flight at a time a client)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 name: str = ''):
        self.name = str(name)
        self._client = ServiceClient(host, int(port), timeout=timeout,
                                     name=name)

    def _call(self, body: Dict[str, Any],
              timeout: Optional[float] = None) -> Dict[str, Any]:
        if (body.get('op') in ('open', 'play') and TRACE_KEY not in body
                and telemetry.trace_enabled()):
            # minted at the true request edge, so that the chain starts
            # with the client; the gateway adopts the id
            body = dict(body, **{TRACE_KEY: telemetry.mint_trace_id()})
        reply = self._client.call_admin(body, timeout)
        if reply.get('error'):
            raise ServiceError(str(reply['error']))
        return reply

    def open(self, env: str, model: Optional[str] = None, seat: int = 0,
             seed: Optional[int] = None,
             timeout: Optional[float] = None) -> Dict[str, Any]:
        body: Dict[str, Any] = {'op': 'open', 'env': str(env),
                                'seat': int(seat), 'client': self.name}
        if model is not None:
            body['model'] = str(model)
        if seed is not None:
            body['seed'] = int(seed)
        return self._call(body, timeout)

    def play(self, sid: str, action: Optional[int] = None,
             timeout: Optional[float] = None) -> Dict[str, Any]:
        """Submit a ply (``action=None`` is a spectate poll: the seat is
        out of the match but the game runs on)."""
        body: Dict[str, Any] = {'op': 'play', 'sid': str(sid),
                                'client': self.name}
        if action is not None:
            body['action'] = int(action)
        return self._call(body, timeout)

    def close_session(self, sid: str) -> Dict[str, Any]:
        return self._call({'op': 'close', 'sid': str(sid)})

    def sessions(self) -> List[Dict[str, Any]]:
        return self._call({'op': 'sessions'}).get('sessions', [])

    def status(self) -> Dict[str, Any]:
        return self._call({'op': 'status'})

    def close(self):
        self._client.close()


def gateway_main(args: Dict[str, Any]) -> int:
    """``--gateway``: one MatchGateway over a running fleet resolver until
    SIGTERM/SIGINT, then drain and return 75 (the supervisor's restart
    contract). The gateway runs no model: its plies run on the fleet's
    replicas. Prints one JSON ``gateway_ready`` line once the listener is
    bound."""
    telemetry.adopt_config(args)
    telemetry.set_process_label('gateway')
    telemetry.install_crash_dump()
    guard = PreemptionGuard().install()
    gateway = MatchGateway(args).start()
    print(json.dumps({'gateway_ready': {
        'port': gateway.port, 'pid': os.getpid(),
        'resolver': gateway.resolver_endpoint,
        'max_sessions': gateway.max_sessions}}), flush=True)
    try:
        while not guard.requested():
            time.sleep(0.2)
        _LOG.warning('gateway: preemption signal received; draining')
    finally:
        gateway.stop(drain=True)
        guard.uninstall()
    return PREEMPT_EXIT_CODE
