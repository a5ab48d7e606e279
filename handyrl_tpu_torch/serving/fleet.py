"""The serving fleet: a resolver and a router over N InferenceService
replicas, the port of ``handyrl_tpu/serving/fleet.py`` on its wire.

One service is one process: one SIGKILL takes it down. The fleet
replicates it with failover that loses no request:

* :class:`ServiceResolver`, the control plane. Replicas register and
  heartbeat their liveness and an SLO snapshot (p50/p99, sheds,
  in-flight); the resolver runs the :class:`~..fault.FleetController`
  state walk over them (healthy, degraded, draining, quarantined),
  supervises the replica processes it spawned (a crashed one is respawned
  under its old name, and its re-registration re-admits it), and may
  autoscale: a sustained SLO breach admits a standby replica, sustained
  idleness drains one through the SIGTERM drain (every accepted request
  answered, exit 75).
* :class:`RoutedClient`, the data plane: the :class:`~.client.ServiceClient`
  surface, routed through the resolver's replica table with one
  :class:`ReplicaBreaker` a replica. A request stranded on a dead or
  draining replica is replayed on another; inference is pure in
  ``(model@version, obs, hidden, legal, seed)``, so the replayed reply is
  byte-identical and the caller never sees the kill.
* **Rolling promotes**: the resolver's ``promote`` op walks the fleet
  replica by replica, each one warming the candidate version end to end
  (the ``warm`` admin op) before the registry's champion flips.

Each managed replica is a ``python -m handyrl_tpu_torch.serving`` process
on the device the resolver's caller names (``--device``, 'cuda' unless
asked otherwise), with its own CUDA context and its own K1 launches.
The resolver runs an alert engine over its registry (heartbeat misses,
quarantine flaps, sheds) and, with ``serving.fleet.metrics_port``, a
Prometheus exporter whose ``/statusz`` carries the replica table and the
per-replica request table. The router stamps a ``route_dispatch`` span on
each dispatch of a request carrying a trace id and, on a failover, a
``router_replay`` span under the request's original id.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import telemetry
from ..connection import (FramedConnection, Hub, INFER_KIND, TRACE_KEY,
                          is_infer, open_socket_connection)
from ..fault import Backoff, FleetController, HOST_DEGRADED, HOST_HEALTHY
from ..guard import PREEMPT_EXIT_CODE, PreemptionGuard
from .client import (SERVE_KIND, ServiceClient, ServiceError,
                     ServiceUnavailable, is_serve, parse_endpoint)
from .registry import ModelRegistry, RegistryError, parse_spec

_LOG = telemetry.get_logger('fleet')

# the replica states a router dispatches to
_ROUTABLE = (HOST_HEALTHY, HOST_DEGRADED)


class ReplicaBreaker:
    """A replica's circuit breaker: ``closed`` admits requests; a failure
    opens it (the probe delay doubling with each failure in a row); once
    the delay has passed ONE half-open probe is admitted, whose success
    closes the breaker and resets the backoff, and whose failure re-opens
    it with a longer delay."""

    def __init__(self, initial: float = 0.5, maximum: float = 8.0,
                 clock=time.monotonic, rng=None):
        self._backoff = Backoff(initial=initial, maximum=maximum, rng=rng)
        self._clock = clock
        self.state = 'closed'
        self._probe_at = 0.0
        self._probing = False

    def admits(self) -> bool:
        """May a request go here now? While closed, and for exactly one
        probe in flight once the reprobe delay has passed."""
        if self.state == 'closed':
            return True
        return not self._probing and self._clock() >= self._probe_at

    def begin_probe(self):
        """Mark the half-open probe in flight (routing a request to an open
        breaker that ``admits()``)."""
        if self.state != 'closed':
            self._probing = True

    def record_success(self):
        self.state = 'closed'
        self._probing = False
        self._backoff.reset()

    def record_failure(self) -> bool:
        """Open (or re-open) the breaker; True when this call opened a
        closed one."""
        opened = self.state == 'closed'
        self.state = 'open'
        self._probing = False
        self._probe_at = self._clock() + self._backoff.next_delay()
        return opened


class AutoscalerPolicy:
    """The SLO-driven admit/drain decision over heartbeat snapshots.

    ``decide(replicas)`` reads the resolver's fleet table (state and
    p99_ms/shed/inflight a replica) and returns ``'admit'`` (a sustained
    SLO breach with room below ``max_replicas``), ``'drain'`` (a sustained
    idle fleet above ``min_replicas``) or None. A breach is a routable
    replica over ``slo_p99_ms`` (when set) or one that shed since the last
    look. Each condition must last its window (``breach_window``,
    ``idle_window``), so one slow batch or one quiet second does not
    thrash the fleet. Pure on an injectable clock."""

    def __init__(self, slo_p99_ms: float = 0.0, breach_window: float = 10.0,
                 idle_window: float = 60.0, min_replicas: int = 1,
                 max_replicas: int = 4, clock=time.monotonic):
        self.slo_p99_ms = float(slo_p99_ms)
        self.breach_window = float(breach_window)
        self.idle_window = float(idle_window)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self._clock = clock
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_shed: Dict[str, int] = {}

    def decide(self, replicas: List[Dict[str, Any]]) -> Optional[str]:
        now = self._clock()
        routable = [r for r in replicas if r.get('state') in _ROUTABLE]
        shedding = False
        for r in routable:
            name = str(r.get('replica'))
            shed = int(r.get('shed', 0))
            if shed > self._last_shed.get(name, 0):
                shedding = True
            self._last_shed[name] = shed
        if not routable:
            self._breach_since = self._idle_since = None
            return None
        breach = shedding or (
            self.slo_p99_ms > 0.0
            and any(float(r.get('p99_ms', 0.0)) > self.slo_p99_ms
                    for r in routable))
        idle = not breach and all(int(r.get('inflight', 0)) == 0
                                  for r in routable)
        if breach:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            if (now - self._breach_since >= self.breach_window
                    and len(routable) < self.max_replicas):
                self._breach_since = None
                return 'admit'
        elif idle:
            self._breach_since = None
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= self.idle_window
                    and len(routable) > self.min_replicas):
                self._idle_since = None
                return 'drain'
        else:
            self._breach_since = self._idle_since = None
        return None


class ServiceResolver:
    """The fleet's control plane: a TCP server speaking the SERVE_KIND
    admin protocol (register / heartbeat / fleet / status / promote /
    drain) over the service's Hub, plus a tick thread that runs the
    heartbeat liveness, the FleetController walk, the supervision of
    managed replicas and the autoscaler.

    ``spawner(name) -> subprocess.Popen`` (set by :func:`resolver_main`, or
    a test) makes a replica *managed*: the resolver respawns it when it
    crashes and SIGTERMs it to drain it. Replicas run elsewhere only
    register and heartbeat; a drain directive rides their heartbeat
    reply."""

    def __init__(self, args: Dict[str, Any],
                 spawner: Optional[Callable[[str], Any]] = None,
                 clock=time.monotonic):
        srv = dict(args.get('serving') or {})
        flt = dict(srv.get('fleet') or {})
        self.host = str(srv.get('host') or '')
        self.port = int(flt.get('port', 0))
        self.default_line = str(srv.get('line', 'default'))
        self.registry_root = str(srv.get('registry_dir')
                                 or args.get('model_dir', 'models'))
        self.lock_timeout = float(srv.get('lock_timeout', 10.0))
        self.heartbeat_timeout = float(flt.get('heartbeat_timeout', 10.0))
        self.metrics_port = int(flt.get('metrics_port') or 0)
        self.autoscale = bool(flt.get('autoscale', False))
        self.max_replicas = max(1, int(flt.get('max_replicas', 4)))
        self.spawner = spawner
        self._clock = clock
        self.policy = AutoscalerPolicy(
            slo_p99_ms=float(flt.get('slo_p99_ms', 0.0)),
            breach_window=float(flt.get('breach_window', 10.0)),
            idle_window=float(flt.get('idle_window', 60.0)),
            min_replicas=int(flt.get('min_replicas', 1)),
            max_replicas=self.max_replicas, clock=clock)

        self._lock = threading.Lock()
        # replica name -> {endpoint, pid, slo, last_beat, drain_wanted}
        self._replicas: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._procs: Dict[str, Any] = {}       # managed  # guarded-by: _lock
        self._respawn_at: Dict[str, float] = {}          # guarded-by: _lock
        self._respawn_backoff: Dict[str, Backoff] = {}   # guarded-by: _lock
        self._next_replica = 0                           # guarded-by: _lock
        # driven from the dispatch thread (register/heartbeat) and the tick
        self.controller = FleetController(            # guarded-by: _lock
            degrade_after=1, quarantine_after=1,
            health_window=max(30.0, self.heartbeat_timeout * 6),
            quarantine_period=float(flt.get('quarantine_period', 30.0)),
            clock=clock)

        self._stop = False
        self._stopping = False    # stop() began: no more ticks
        self._sock: Optional[socket.socket] = None
        self.hub: Optional[Hub] = None
        self._threads: list = []

        self._m_state = lambda replica: telemetry.gauge(
            'fleet_replica_state', replica=replica)
        self._m_transitions = lambda frm, to: telemetry.counter(
            'fleet_replica_transitions_total', **{'from': frm, 'to': to})
        self._m_replicas = telemetry.gauge('fleet_replicas')
        self._m_heartbeats = telemetry.counter('fleet_heartbeats_total')
        self._m_hb_misses = telemetry.counter('fleet_heartbeat_misses_total')
        self._m_admits = telemetry.counter('fleet_autoscale_admits_total')
        self._m_drains = telemetry.counter('fleet_autoscale_drains_total')
        self._m_respawns = telemetry.counter('fleet_respawns_total')
        self._m_promotes = telemetry.counter('fleet_rolling_promotes_total')

        # resolver-side SLO alert engine (heartbeat misses, quarantine
        # flap, shed burn over the merged heartbeat counters), driven from
        # the tick loop and /statusz scrapes
        self._alerts = telemetry.AlertEngine.from_config(args)
        self._exporter = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> 'ServiceResolver':
        self._sock = open_socket_connection(self.port, self.host)
        self._sock.listen(64)
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]
        self.hub = Hub()
        for target, name in ((self._accept_loop, 'fleet-accept'),
                             (self._dispatch_loop, 'fleet-dispatch'),
                             (self._tick_loop, 'fleet-tick')):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        self._exporter, self.metrics_port = telemetry.start_exporter(
            self.metrics_port, self._status_info)
        _LOG.info('fleet: resolver listening on port %d (registry %s)',
                  self.port, self.registry_root)
        return self

    def stop(self, drain: bool = True):
        """SIGTERM every managed replica (the graceful drain, exit 75) and
        wait them out (SIGKILL without ``drain``), then tear the resolver
        down. The tick thread ends first, so that no replica exiting 75 is
        taken for a crash and respawned while the fleet drains."""
        self._stopping = True
        for t in self._threads:
            if t.name == 'fleet-tick':
                t.join(timeout=10.0)
        with self._lock:
            procs = dict(self._procs)
        for name, proc in procs.items():
            if proc.poll() is None:
                if drain:
                    _LOG.info('fleet: draining managed replica %r (SIGTERM '
                              'pid %d)', name, proc.pid)
                try:
                    proc.send_signal(signal.SIGTERM if drain
                                     else signal.SIGKILL)
                except OSError:
                    pass
        for name, proc in procs.items():
            try:
                proc.wait(timeout=60 if drain else 10)
            except subprocess.TimeoutExpired:
                _LOG.error('fleet: replica %r did not exit; killing', name)
                proc.kill()
                proc.wait(timeout=10)
        self._stop = True
        if self._exporter is not None:
            self._exporter.stop()
            self._exporter = None
        if self._sock is not None:
            self._sock.close()
        for t in self._threads:
            t.join(timeout=5.0)
        if self.hub is not None:
            self.hub.close()     # flushes the final replies first

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
                body = msg[1] if (isinstance(msg, (list, tuple))
                                  and len(msg) == 2
                                  and isinstance(msg[1], dict)) else {}
                if is_serve(msg):
                    self._admin(ep, body)
                elif is_infer(msg):
                    # control plane only: a misdirected request fails fast
                    self.hub.send(ep, (INFER_KIND, {
                        'rid': body.get('rid'), 'engine_fault': True,
                        'error': 'resolver is control-plane only; route '
                                 'requests through a RoutedClient or dial '
                                 'a replica endpoint'}))
                else:
                    self.hub.send(ep, (SERVE_KIND,
                                       {'error': 'unknown frame kind'}))
            except Exception as exc:   # noqa: BLE001 — the loop must live
                _LOG.exception('fleet: dispatch error (%s: %s)',
                               type(exc).__name__, str(exc)[:200])

    def _admin(self, ep, body: Dict[str, Any]):
        op = body.get('op')
        if op == 'register':
            self._register(ep, body)
        elif op == 'heartbeat':
            self._heartbeat(ep, body)
        elif op == 'fleet':
            self.hub.send(ep, (SERVE_KIND, {'fleet': True,
                                            'replicas': self.fleet_table()}))
        elif op == 'status':
            self.hub.send(ep, (SERVE_KIND, self.stats()))
        elif op == 'promote':
            self._promote_async(ep, str(body.get('model')))
        elif op == 'drain':
            name = str(body.get('replica') or '')
            if self._request_drain(name):
                self.hub.send(ep, (SERVE_KIND, {'ok': True,
                                                'replica': name}))
            else:
                self.hub.send(ep, (SERVE_KIND,
                                   {'error': 'unknown replica %r' % name}))
        else:
            self.hub.send(ep, (SERVE_KIND,
                               {'error': 'unknown admin op %r' % (op,)}))

    # -- registration / heartbeats -----------------------------------------

    def _name_replica(self) -> str:
        with self._lock:
            name = 'r%d' % self._next_replica
            self._next_replica += 1
            return name

    def _register(self, ep, body: Dict[str, Any]):
        endpoint = str(body.get('endpoint') or '')
        if not endpoint:
            self.hub.send(ep, (SERVE_KIND,
                               {'error': 'register carries no endpoint'}))
            return
        name = str(body.get('replica') or '') or self._name_replica()
        now = self._clock()
        with self._lock:
            rec = self._replicas.get(name)
            known = rec is not None
            if rec is None:
                rec = self._replicas[name] = {'slo': {},
                                              'drain_wanted': False}
            rec['endpoint'] = endpoint
            rec['pid'] = int(body.get('pid') or 0)
            rec['last_beat'] = now
            self.controller.observe(name)
            recovered = known and self.controller.state(name) != HOST_HEALTHY
            if recovered:
                # it proved itself alive by re-registering (a respawn):
                # re-admit it now instead of waiting out the quarantine
                self.controller.readmit(name)
        _LOG.info('fleet: replica %r registered at %s (pid %d)%s',
                  name, endpoint, int(body.get('pid') or 0),
                  '; re-admitted' if recovered else '')
        self._journal()
        self.hub.send(ep, (SERVE_KIND, {'ok': True, 'replica': name}))

    def _heartbeat(self, ep, body: Dict[str, Any]):
        name = str(body.get('replica') or '')
        slo = dict(body.get('slo') or {})
        with self._lock:
            rec = self._replicas.get(name)
            if rec is not None:
                rec['last_beat'] = self._clock()
                prev_shed = int((rec.get('slo') or {}).get('shed', 0))
                rec['slo'] = slo
                if int(slo.get('shed', 0)) > prev_shed:
                    # shedding load: alive but struggling, a soft fault
                    self.controller.record_soft_fault(name)
                drain = bool(rec['drain_wanted'])
        if rec is None:
            self.hub.send(ep, (SERVE_KIND,
                               {'error': 'unknown replica %r; register '
                                         'first' % name}))
            return
        self._m_heartbeats.inc()
        self.hub.send(ep, (SERVE_KIND, {'ok': True, 'drain': drain}))

    # -- the tick: liveness, state walk, autoscaler, supervision -----------

    def _tick_loop(self):
        while not self._stop and not self._stopping:
            try:
                self.tick_once()
            except Exception as exc:   # noqa: BLE001 — the loop must live
                _LOG.exception('fleet: tick error (%s: %s)',
                               type(exc).__name__, str(exc)[:200])
            self._sleep(0.25)

    def tick_once(self):
        now = self._clock()
        with self._lock:
            beats = {n: r['last_beat'] for n, r in self._replicas.items()}
        for name, last in beats.items():
            silent = now - last
            with self._lock:
                missed = (self.controller.state(name) in _ROUTABLE
                          and silent > self.heartbeat_timeout)
                if missed:
                    self.controller.record_stranding(name)
            if missed:
                self._m_hb_misses.inc()
                _LOG.warning('fleet: replica %r silent for %.1fs '
                             '(heartbeat_timeout %.1fs); draining it',
                             name, silent, self.heartbeat_timeout)
        with self._lock:
            # the resolver books no requests (clients replay their own),
            # so a draining replica quarantines on the next tick
            self.controller.tick({})
        if self.autoscale:
            self._autoscale_step()
        self._supervise()
        self._journal()
        if self._alerts is not None:
            self._alerts.poll()

    def _autoscale_step(self):
        decision = self.policy.decide(self.fleet_table())
        if decision == 'admit':
            if self.spawner is None:
                _LOG.warning('fleet: the autoscaler wants a replica admitted '
                             'but no spawner is configured')
                return
            name = self.admit_replica()
            if name:
                self._m_admits.inc()
                _LOG.warning('fleet: SLO breach sustained; admitted standby '
                             'replica %r', name)
        elif decision == 'drain':
            victim = self._drain_victim()
            if victim and self._request_drain(victim):
                self._m_drains.inc()
                _LOG.warning('fleet: fleet idle; draining replica %r',
                             victim)

    def _drain_victim(self) -> Optional[str]:
        """The replica an idle drain retires: a routable one, managed
        preferred (the resolver can stop it), the youngest name first."""
        rows = [r for r in self.fleet_table()
                if r['state'] in _ROUTABLE and not r['draining']]
        if not rows:
            return None
        with self._lock:
            managed = set(self._procs)
        rows.sort(key=lambda r: (r['replica'] in managed, r['replica']))
        return rows[-1]['replica']

    def _request_drain(self, name: str) -> bool:
        with self._lock:
            rec = self._replicas.get(name)
            if rec is None:
                return False
            rec['drain_wanted'] = True
            self.controller.force_drain(name)
            proc = self._procs.get(name)
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)   # graceful drain, exit 75
            except OSError:
                pass
        self._journal()
        return True

    def admit_replica(self) -> Optional[str]:
        """Spawn one managed replica (within ``max_replicas``); its name,
        or None at capacity or without a spawner."""
        if self.spawner is None:
            return None
        with self._lock:
            if len(self._procs) >= self.max_replicas:
                return None
        name = self._name_replica()
        proc = self.spawner(name)
        with self._lock:
            self._procs[name] = proc
        _LOG.info('fleet: spawned managed replica %r (pid %d)', name,
                  proc.pid)
        return name

    def _supervise(self):
        """Reap and respawn managed replicas: a deliberate drain is retired
        (forgotten); a crash is respawned under the SAME name after a
        backoff, and its re-registration re-admits it."""
        with self._lock:
            procs = dict(self._procs)
        for name, proc in procs.items():
            rc = proc.poll()
            if rc is None:
                continue
            respawned = False
            with self._lock:
                rec = self._replicas.get(name)
                retired = bool(rec and rec.get('drain_wanted'))
                if retired:
                    self._procs.pop(name, None)
                    self._replicas.pop(name, None)
                    self._respawn_at.pop(name, None)
                    self.controller.forget(name)
                else:
                    due = self._respawn_at.get(name)
                    now = self._clock()
                    if due is None:
                        # a reaped corpse is a stranding: walk the state
                        # machine now (healthy -> draining -> quarantined)
                        # instead of waiting out the heartbeat silence
                        self.controller.record_stranding(name)
                        backoff = self._respawn_backoff.setdefault(
                            name, Backoff(initial=0.2, maximum=5.0))
                        self._respawn_at[name] = now + backoff.next_delay()
                    elif now >= due:
                        self._respawn_at.pop(name, None)
                        self._procs[name] = self.spawner(name)
                        self._m_respawns.inc()
                        respawned = True
            if retired:
                self._m_state(name).set(-1.0)
                _LOG.info('fleet: replica %r drained and exited %s; '
                          'retired', name, rc)
            elif respawned:
                _LOG.warning('fleet: replica %r (exit %s) respawned under '
                             'its old name', name, rc)

    def _journal(self):
        """Mirror the controller's transitions onto logs and gauges (the
        resolver is where the whole fleet's state is seen)."""
        with self._lock:
            events = self.controller.drain_transitions()
            states = {name: self.controller.state(name)
                      for name in self._replicas}
        for name, frm, to, _t in events:
            _LOG.warning('fleet: replica %s: %s -> %s', name, frm, to)
            self._m_transitions(frm, to).inc()
        for name, state in states.items():
            self._m_state(name).set(
                float(telemetry.HOST_STATE_CODES.get(state, -1)))
        self._m_replicas.set(float(
            sum(1 for s in states.values() if s in _ROUTABLE)))

    def _sleep(self, seconds: float):
        deadline = time.monotonic() + seconds
        while (not self._stop and not self._stopping
               and time.monotonic() < deadline):
            time.sleep(min(0.1, max(0.0, deadline - time.monotonic())))

    # -- rolling promote ---------------------------------------------------

    def _promote_async(self, ep, spec: str):
        def run():
            try:
                result = self.rolling_promote(spec)
            except (RegistryError, ServiceError, ServiceUnavailable,
                    RuntimeError, ValueError, TimeoutError) as exc:
                result = {'error': '%s: %s' % (type(exc).__name__, exc)}
            self.hub.send(ep, (SERVE_KIND, result))

        threading.Thread(target=run, name='fleet-promote', daemon=True).start()

    def rolling_promote(self, spec: str) -> Dict[str, Any]:
        """Walk the fleet replica by replica: each routable replica warms
        the candidate version end to end, and only then does the registry's
        champion flip, one atomic manifest swap every replica is already
        warm for."""
        line, selector = parse_spec(spec)
        registry = ModelRegistry(self.registry_root,
                                 lock_timeout=self.lock_timeout)
        version, _meta = registry.resolve(line, selector)
        warmed = []
        for row in self.fleet_table():
            if row['state'] not in _ROUTABLE:
                continue
            host, port = parse_endpoint(row['endpoint'])
            client = ServiceClient(host, port, timeout=120.0,
                                   name='fleet-promote')
            try:
                rep = client.call_admin(
                    {'op': 'warm', 'model': '%s@%s' % (line, version)},
                    timeout=120.0)
            finally:
                client.close()
            if rep.get('error'):
                raise RuntimeError(
                    'replica %r failed to warm %s@%s: %s; champion NOT '
                    'flipped' % (row['replica'], line, version,
                                 rep['error']))
            warmed.append(row['replica'])
            _LOG.info('fleet: replica %r warmed %s@%s', row['replica'],
                      line, version)
        registry.promote(line, version)
        self._m_promotes.inc()
        _LOG.info('fleet: rolling promote of %s@%s complete (%d replica(s) '
                  'warmed)', line, version, len(warmed))
        return {'ok': True, 'line': line, 'version': version,
                'warmed': warmed}

    # -- introspection -----------------------------------------------------

    def _status_info(self) -> Dict[str, Any]:
        """/statusz payload for the resolver metrics port: per-replica
        states, the routable count, and the fleet-level alert state."""
        with self._lock:
            states = {n: self.controller.state(n) for n in self._replicas}
            slos = {n: dict(r.get('slo') or {})
                    for n, r in self._replicas.items()}
        info: Dict[str, Any] = {
            'fleet_replicas': states,
            'progress': {'replicas': len(states),
                         'routable': sum(1 for s in states.values()
                                         if s in _ROUTABLE)},
            # the live per-replica request table (--status renders it)
            'requests': [{'replica': n,
                          'inflight': int(slos[n].get('inflight', 0)),
                          'p50_ms': float(slos[n].get('p50_ms', 0.0)),
                          'p99_ms': float(slos[n].get('p99_ms', 0.0)),
                          'received': int(slos[n].get('received', 0)),
                          'answered': int(slos[n].get('answered', 0)),
                          'draining': bool(slos[n].get('draining'))}
                         for n in sorted(slos)],
        }
        if self._alerts is not None:
            info['alerts'] = self._alerts.poll()
        return info

    def fleet_table(self) -> List[Dict[str, Any]]:
        """The replica table routers read: name, endpoint, state and the
        latest heartbeat's SLO numbers."""
        with self._lock:
            snap = {n: dict(r) for n, r in self._replicas.items()}
            states = {n: self.controller.state(n) for n in snap}
        out = []
        for name in sorted(snap):
            rec = snap[name]
            slo = rec.get('slo') or {}
            out.append({'replica': name,
                        'endpoint': str(rec.get('endpoint', '')),
                        'pid': int(rec.get('pid', 0)),
                        'state': states[name],
                        'p50_ms': float(slo.get('p50_ms', 0.0)),
                        'p99_ms': float(slo.get('p99_ms', 0.0)),
                        'inflight': int(slo.get('inflight', 0)),
                        'shed': int(slo.get('shed', 0)),
                        'draining': bool(slo.get('draining')
                                         or rec.get('drain_wanted'))})
        return out

    def wait_routable(self, count: int, timeout: float = 120.0) -> bool:
        """Block until ``count`` replicas are registered and routable
        (managed replicas register some seconds after their spawn)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            table = self.fleet_table()
            if sum(1 for r in table if r['state'] in _ROUTABLE) >= count:
                return True
            time.sleep(0.05)
        return False

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counts = self.controller.counts()
            fc_stats = dict(self.controller.stats)
            managed = sorted(self._procs)
        return {'resolver': True, 'port': self.port,
                'registry': self.registry_root, 'autoscale': self.autoscale,
                'managed': managed, 'counts': counts,
                'controller': fc_stats, 'replicas': self.fleet_table()}


class RoutedClient:
    """The client-side router over the fleet: the :class:`ServiceClient`
    surface (submit/collect/request/status/resolve), every request sent to
    a routable replica of the resolver's table, guarded by one
    :class:`ReplicaBreaker` a replica and, on a dead socket, a timeout or a
    draining reply, replayed on another replica for a byte-identical
    answer.

    As with ServiceClient, one submitter at a time an instance; concurrent
    load generators hold one RoutedClient each."""

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 name: str = '', refresh_interval: float = 2.0):
        self.timeout = float(timeout)
        self.name = name
        self._resolver = ServiceClient(host, int(port), timeout=timeout,
                                       name=name or 'router')
        self._refresh_interval = float(refresh_interval)
        self._lock = threading.Lock()
        self._table: Dict[str, Dict[str, Any]] = {}  # guarded-by: _lock
        self._clients: Dict[str, ServiceClient] = {}  # guarded-by: _lock
        self._breakers: Dict[str, ReplicaBreaker] = {}  # guarded-by: _lock
        self._last_refresh = 0.0
        self._rr = 0          # round-robin cursor
        self._rid = 0
        # rid -> (replica, the connection and its rid there, the request):
        # a reply is awaited on the connection the request went out on, so
        # that a respawned replica under the same name is never asked for
        # a rid its predecessor took to its grave
        self._book: Dict[int, Tuple[str, ServiceClient, int,
                                    Dict[str, Any]]] = {}
        # floating spec -> (concrete line@version, expiry); see _pin_spec
        self._pins: Dict[str, Tuple[str, float]] = {}  # guarded-by: _lock
        # the replica that served the latest dispatch (submit or replay)
        self.last_replica: Optional[str] = None
        self.replays = 0
        self._m_requests = lambda replica: telemetry.counter(
            'router_requests_total', replica=replica)
        self._m_replays = telemetry.counter('router_replays_total')
        self._m_breaker_opens = telemetry.counter(
            'router_breaker_opens_total')
        self._refresh(force=True)

    def close(self):
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
        self._resolver.close()

    # -- replica table -----------------------------------------------------

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < self._refresh_interval:
            return
        try:
            reply = self._resolver.fleet(timeout=self.timeout)
        except (ServiceUnavailable, TimeoutError) as exc:
            # route on the stale table: a resolver outage must not take
            # the data plane with it
            _LOG.warning('router: resolver unreachable (%s); keeping the '
                         'stale replica table', exc)
            self._last_refresh = now
            return
        if reply.get('error') or not reply.get('fleet'):
            raise ServiceError('endpoint is not a fleet resolver: %s'
                               % (reply.get('error') or reply))
        with self._lock:
            self._table = {str(r['replica']): r
                           for r in reply.get('replicas', [])}
            # a replica gone, or respawned under its name elsewhere: its
            # connection goes
            for name, client in list(self._clients.items()):
                row = self._table.get(name)
                if row is None or parse_endpoint(row['endpoint']) != (
                        client.host, client.port):
                    self._clients.pop(name).close()
            self._last_refresh = now

    def replicas(self) -> List[Dict[str, Any]]:
        self._refresh()     # at most once a refresh_interval
        with self._lock:
            return [dict(r) for r in self._table.values()]

    # -- routing -----------------------------------------------------------

    def _candidates(self) -> List[str]:
        """Routable replicas in dispatch order: closed breakers first
        (round robin), then open breakers due a half-open probe."""
        with self._lock:
            names = [n for n, r in sorted(self._table.items())
                     if r.get('state') in _ROUTABLE
                     and not r.get('draining')]
            closed, probes = [], []
            for n in names:
                b = self._breakers.get(n)
                if b is None or b.state == 'closed':
                    closed.append(n)
                elif b.admits():
                    probes.append(n)
            if closed:
                self._rr = (self._rr + 1) % len(closed)
                closed = closed[self._rr:] + closed[:self._rr]
        return closed + probes

    def _client(self, name: str) -> ServiceClient:
        with self._lock:
            client = self._clients.get(name)
            endpoint = str(self._table[name]['endpoint'])
        if client is None:
            host, port = parse_endpoint(endpoint)
            client = ServiceClient(host, port, timeout=self.timeout,
                                   name=self.name, dial_retries=1,
                                   dial_backoff=0.05)
            with self._lock:
                self._clients[name] = client
        return client

    def _breaker(self, name: str) -> ReplicaBreaker:
        with self._lock:
            b = self._breakers.get(name)
            if b is None:
                b = self._breakers[name] = ReplicaBreaker()
            return b

    def _ok(self, name: str):
        self._breaker(name).record_success()

    def _fail(self, name: str, client: Optional[ServiceClient] = None):
        """Open ``name``'s breaker and drop its connection (``client``,
        when given: a newer connection to a respawned replica under the
        same name stays)."""
        if self._breaker(name).record_failure():
            self._m_breaker_opens.inc()
            _LOG.warning('router: breaker OPEN for replica %r', name)
        with self._lock:
            if client is None or self._clients.get(name) is client:
                client = self._clients.pop(name, client)
        if client is not None:
            client.close()

    def _pin_spec(self, spec: str) -> str:
        """A floating selector (``champion``/``previous``/``latest``)
        resolved to the concrete ``line@version`` it names now, cached for
        one refresh interval and dropped by :meth:`promote`. A request
        stranded mid-promote then replays against the SAME version it was
        first sent with. Concrete specs pass through; a failed resolve
        leaves the raw spec (each replica resolves it)."""
        line, selector = parse_spec(str(spec))
        if selector not in ('champion', 'previous', 'latest'):
            return str(spec)
        now = time.monotonic()
        with self._lock:
            hit = self._pins.get(spec)
            if hit is not None and hit[1] > now:
                return hit[0]
        try:
            reply = self.resolve(spec, timeout=self.timeout)
        except (ServiceUnavailable, TimeoutError):
            return str(spec)
        if reply.get('error') or reply.get('version') is None:
            return str(spec)
        pinned = '%s@%s' % (reply.get('line') or line, reply['version'])
        with self._lock:
            self._pins[str(spec)] = (pinned, now + self._refresh_interval)
        return pinned

    def _dispatch(self, req: Dict[str, Any], prefer: Optional[str] = None
                  ) -> Tuple[str, ServiceClient, int]:
        """Send ``req`` to the first admissible replica: (replica, the
        connection, its rid there). A dial or send failure opens that
        replica's breaker and moves on; a second pass runs after a forced
        table refresh. ``prefer`` puts a session's replica first while it
        is routable (the gateway's affinity, never a hard pin)."""
        last: Optional[BaseException] = None
        trace = req.get(TRACE_KEY)
        t0 = time.time()
        for _attempt in range(2):
            names = self._candidates()
            if prefer is not None and prefer in names:
                names.remove(prefer)
                names.insert(0, prefer)
            for name in names:
                breaker = self._breaker(name)
                breaker.begin_probe()
                client = None
                try:
                    client = self._client(name)
                    sub = client.submit(**req)
                except ServiceUnavailable as exc:
                    last = exc
                    self._fail(name, client)
                    continue
                self._m_requests(name).inc()
                self.last_replica = name
                if trace:
                    telemetry.trace_event('route_dispatch', ts=t0,
                                          dur=time.time() - t0,
                                          trace_id=trace, replica=name,
                                          breaker=breaker.state)
                return name, client, sub
            self._refresh(force=True)
        raise ServiceUnavailable(
            'no routable replica accepted the request (%d in table): %s'
            % (len(self._table), last))

    # -- the ServiceClient surface -----------------------------------------

    def submit(self, model: str, obs, hidden=None, legal=None,
               seed=None, replica: Optional[str] = None, trace=None) -> int:
        self._refresh()
        if trace is None and telemetry.trace_enabled():
            trace = telemetry.mint_trace_id()
        req = {'model': self._pin_spec(model), 'obs': obs, 'hidden': hidden,
               'legal': legal, 'seed': seed}
        if trace:
            # booked in the replay request itself, so that a failover
            # replay dispatches with, and links to, the ORIGINAL trace id
            req[TRACE_KEY] = trace
        name, client, sub = self._dispatch(req, prefer=replica)
        with self._lock:
            self._rid += 1
            rid = self._rid
            self._book[rid] = (name, client, sub, req)
        return rid

    def collect(self, rid: int, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        with self._lock:
            entry = self._book.pop(rid, None)
        if entry is None:
            raise ValueError('unknown router rid %d' % rid)
        name, client, sub, req = entry
        try:
            reply = client.collect(sub, timeout=timeout)
            self._ok(name)
            return reply
        except (ServiceUnavailable, TimeoutError) as exc:
            self._fail(name, client)
            last: BaseException = exc
        except ServiceError as exc:
            if 'draining' not in str(exc):
                raise           # a real error reply: the service answered
            # a draining replica error-answers everything and is about to
            # exit: route away from it and replay elsewhere
            self._fail(name, client)
            last = exc
        # the replay: inference is pure in (model@version, obs, hidden,
        # legal, seed), so another replica's reply is byte-identical
        attempts = max(2, len(self.replicas()) + 1)
        for _attempt in range(attempts):
            t_replay = time.time()
            name2, client2, sub2 = self._dispatch(req)
            self._m_replays.inc()
            self.replays += 1
            if req.get(TRACE_KEY):
                # the link span: the replay carries the ORIGINAL trace id,
                # so a SIGKILL reads as one causal chain in the trace
                telemetry.trace_event('router_replay', ts=t_replay,
                                      dur=time.time() - t_replay,
                                      trace_id=req[TRACE_KEY], link='replay',
                                      from_replica=name, to_replica=name2)
            try:
                reply = client2.collect(sub2, timeout=timeout)
                self._ok(name2)
                return reply
            except (ServiceUnavailable, TimeoutError) as exc:
                self._fail(name2, client2)
                last = exc
            except ServiceError as exc:
                if 'draining' not in str(exc):
                    raise
                self._fail(name2, client2)
                last = exc
        raise ServiceUnavailable(
            'request could not be replayed on any replica: %s' % last) \
            from last

    def request(self, model: str, obs, hidden=None, legal=None, seed=None,
                timeout: Optional[float] = None,
                replica: Optional[str] = None, trace=None
                ) -> Dict[str, Any]:
        return self.collect(self.submit(model, obs, hidden=hidden,
                                        legal=legal, seed=seed,
                                        replica=replica, trace=trace),
                            timeout=timeout)

    def status(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """The resolver's fleet-wide stats."""
        return self._resolver.status(timeout=timeout)

    def promote(self, spec: str, timeout: float = 600.0) -> Dict[str, Any]:
        """Rolling-promote ``line@selector`` across the fleet (blocks until
        every routable replica warmed it and the champion flipped)."""
        reply = self._resolver.call_admin({'op': 'promote',
                                           'model': str(spec)},
                                          timeout=timeout)
        with self._lock:
            # the flip moved every floating selector: drop the stale pins
            self._pins.clear()
        return reply

    def resolve(self, spec: str, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        """Resolve ``line@selector`` against a routable replica."""
        for name in self._candidates():
            client = None
            try:
                client = self._client(name)
                return client.resolve(spec, timeout=timeout)
            except (ServiceUnavailable, TimeoutError):
                self._fail(name, client)
        raise ServiceUnavailable('no routable replica to resolve against')


# ---------------------------------------------------------------------------
# the --serve-fleet entry point


def _replica_spawner(sargs: Dict[str, Any], resolver: ServiceResolver,
                     device: str) -> Callable[[str], Any]:
    """``spawner(name)``: one ``python -m handyrl_tpu_torch.serving``
    process a replica, on ``device``, registering back with the resolver
    under its assigned name (an ephemeral port: the register op carries the
    bound endpoint, so the resolver never parses a child's stdout)."""
    srv = dict(sargs.get('serving') or {})
    flt = dict(srv.get('fleet') or {})
    inf = dict(sargs.get('inference') or {})
    env_name = str((sargs.get('env') or {}).get('env', 'TicTacToe'))

    def spawn(name: str):
        cmd = [sys.executable, '-m', 'handyrl_tpu_torch.serving',
               '--env', env_name,
               '--registry', resolver.registry_root,
               '--port', '0',
               '--line', str(srv.get('line', 'default')),
               '--engines', str(int(srv.get('engines', 1))),
               '--max-clients', str(int(srv.get('max_clients', 64))),
               '--drain-timeout', str(float(srv.get('drain_timeout', 30.0))),
               '--resolver', '127.0.0.1:%d' % resolver.port,
               '--replica', name,
               '--heartbeat', str(float(flt.get('heartbeat_interval', 2.0))),
               '--device', str(device)]
        if inf.get('batch_wait_ms') is not None:
            cmd += ['--wait-ms', str(float(inf['batch_wait_ms']))]
        if inf.get('max_batch') is not None:
            cmd += ['--max-batch', str(int(inf['max_batch']))]
        return subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                cwd=os.getcwd())

    return spawn


def resolver_main(args: Dict[str, Any], device: Any = 'cuda') -> int:
    """``--serve-fleet``: the resolver and ``serving.fleet.replicas``
    managed replicas on ``device`` until SIGTERM/SIGINT, then a fleet-wide
    graceful drain (the replicas answer everything accepted and exit 75)
    and 75. ``args`` is a service's args (``config.serving_args``). Prints
    one JSON ``fleet_ready`` line once every initial replica is
    routable."""
    from ..model import resolve_device
    # no replica may serve from the host because the card is missing
    device = str(resolve_device(device))
    flt = dict((args.get('serving') or {}).get('fleet') or {})
    n = int(flt.get('replicas', 2))
    # the spawned replicas inherit the tracing switch, directory and rate
    # through the environment this mirrors them into
    telemetry.adopt_config(args)
    telemetry.set_process_label('fleet-resolver')
    telemetry.install_crash_dump()
    guard = PreemptionGuard().install()
    resolver = ServiceResolver(args)
    if n > 0 or bool(flt.get('autoscale', False)):
        resolver.spawner = _replica_spawner(args, resolver, device)
    resolver.start()
    try:
        for _ in range(n):
            resolver.admit_replica()
        if n and not resolver.wait_routable(n, timeout=180.0):
            _LOG.error('fleet: only %d/%d replicas registered in time',
                       sum(1 for r in resolver.fleet_table()
                           if r['state'] in _ROUTABLE), n)
        print(json.dumps({'fleet_ready': {
            'port': resolver.port, 'pid': os.getpid(), 'replicas': n,
            'device': device,
            'registry': os.path.abspath(resolver.registry_root),
            'table': resolver.fleet_table()}}), flush=True)
        while not guard.requested():
            time.sleep(0.2)
        _LOG.warning('fleet: preemption signal received; draining the '
                     'fleet')
    finally:
        resolver.stop(drain=True)
        guard.uninstall()
    return PREEMPT_EXIT_CODE
