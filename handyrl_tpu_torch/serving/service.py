"""The InferenceService: a long-lived model-serving process.

The subset of ``handyrl_tpu/serving/service.py`` the serving path uses. One
process hosts one or more :class:`~..inference.InferenceEngine` instances
on one device behind a TCP listener speaking the framed ``INFER_KIND``
protocol. Requests name models by ``line@selector`` against the
:class:`~.registry.ModelRegistry`; a promote flips what ``@champion``
resolves to between one request and the next.

* **Continuous batching**: requests from every client coalesce in the
  engine's intake queue (``inference.batch_wait_ms``, ``max_batch``,
  power-of-two row padding), one ``batch_inference`` per tick.
* **Admission control**: a connection past ``serving.max_clients`` is
  refused with an error frame; a request past the engine's bounded queue is
  shed with an error reply. Nothing queues without bound or is dropped.
* **Graceful drain**: SIGTERM stops admission, answers every request
  already accepted (new arrivals get an immediate ``draining`` error
  reply), waits out the engines up to ``serving.drain_timeout``, then exits
  75 (restart me).

The fleet membership loop, warm-up/promote walk, metrics exporter, alerts
and tracing are not ported yet.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
from typing import Any, Dict, Optional, Tuple

import torch

from .. import telemetry
from ..connection import (FramedConnection, Hub, INFER_KIND, is_infer,
                          open_socket_connection)
from ..guard import PREEMPT_EXIT_CODE, PreemptionGuard
from ..model import resolve_device
from .. import ops
from ..ops import cuda_build
from .client import SERVE_KIND, is_serve
from .registry import ModelRegistry, RegistryError, parse_spec

_LOG = telemetry.get_logger('serving')


def kernel_launches() -> Dict[str, int]:
    """Launches of each CUDA kernel of the port in this process (serving
    launches only ``geese_trunk``; the others stay 0)."""
    return ops.kernel_launches()


class InferenceService:
    """One serving process: listener + Hub + registry-backed engines.

    ``args`` carries an ``env`` block (the env builds the example
    observation) and the ``inference`` and ``serving`` blocks
    (config.serving_args fills the defaults). ``device`` is where the
    engines run the models: 'cuda' unless the caller asks for 'cpu'.
    ``start()`` binds and spins the accept/dispatch threads; ``stop()``
    drains and tears down."""

    def __init__(self, args: Dict[str, Any],
                 registry: Optional[ModelRegistry] = None,
                 device: Any = 'cuda'):
        self.device = resolve_device(device)
        srv = dict(args.get('serving') or {})
        self._args = args
        self.host = str(srv.get('host') or '')
        self.port = int(srv.get('port', 9997))
        self.default_line = str(srv.get('line', 'default'))
        self.max_clients = max(1, int(srv.get('max_clients', 64)))
        self.drain_timeout = max(0.1, float(srv.get('drain_timeout', 30.0)))
        self.engines_n = max(1, int(srv.get('engines', 1)))
        self.registry = registry if registry is not None else ModelRegistry(
            srv.get('registry_dir') or 'models',
            lock_timeout=float(srv.get('lock_timeout', 10.0)))

        from ..environment import make_env
        env = make_env(dict(args['env']))
        env.reset()
        self._example_obs = env.observation(env.players()[0])

        self._lock = threading.Lock()
        # (line, version) <-> engine-facing integer model handle
        self._handles: Dict[Tuple[str, str], int] = {}      # guarded-by: _lock
        self._handle_meta: Dict[int, Tuple[str, str]] = {}  # guarded-by: _lock
        # (endpoint id, rid) -> (t0, model label, client label)
        self._pending: Dict[Tuple[int, Any], tuple] = {}    # guarded-by: _lock
        self._draining = False
        self._stop = False
        self._sock: Optional[socket.socket] = None
        self.hub: Optional[Hub] = None
        self.engines: list = []
        self._threads: list = []
        self.received = 0
        self.answered = 0
        self.refused = 0      # connections shed by the admission gate

        self._m_requests = lambda model, client: telemetry.counter(
            'serve_requests_total', model=model, client=client)
        self._m_latency = lambda model, client: telemetry.histogram(
            'serve_request_seconds', model=model, client=client)
        self._m_errors = lambda reason: telemetry.counter(
            'serve_errors_total', reason=reason)
        self._m_shed = telemetry.counter('serve_shed_total')
        self._m_clients = telemetry.gauge('serve_clients')
        self._m_inflight = telemetry.gauge('serve_inflight')
        self._m_draining = telemetry.gauge('serve_draining')

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> 'InferenceService':
        from ..inference import InferenceEngine
        if self.device.type == 'cuda':
            # bring up the CUDA context and build/load every kernel before
            # the listener opens, so that no request pays for either
            torch.zeros((), device=self.device)
            for name in cuda_build.SOURCES:
                cuda_build.load(name)
        self._sock = open_socket_connection(self.port, self.host)
        self._sock.listen(self.max_clients + 8)
        self._sock.settimeout(0.5)
        self.port = self._sock.getsockname()[1]   # resolve port 0
        self.hub = Hub()
        self.engines = [
            InferenceEngine(self._args, fetch_snapshot=self._fetch,
                            reply_fn=self._reply,
                            example_obs=self._example_obs,
                            device=self.device).start()
            for _ in range(self.engines_n)]
        for target, name in ((self._accept_loop, 'serve-accept'),
                             (self._dispatch_loop, 'serve-dispatch')):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        _LOG.info('inference service listening on port %d (%d engine(s) on '
                  '%s, registry %s)', self.port, self.engines_n, self.device,
                  self.registry.root)
        return self

    def request_drain(self):
        """Begin graceful drain: no new work is admitted; everything
        already accepted is answered."""
        if not self._draining:
            self._draining = True
            self._m_draining.set(1.0)
            _LOG.warning('serving: drain requested; answering %d in-flight '
                         'request(s), refusing new work', self.inflight())

    def drained(self) -> bool:
        return self.inflight() == 0

    def stop(self, drain: bool = True):
        """Drain (bounded by ``serving.drain_timeout``), then tear down the
        listener, the engines and the hub."""
        if drain:
            self.request_drain()
            deadline = time.monotonic() + self.drain_timeout
            while not self.drained() and time.monotonic() < deadline:
                time.sleep(0.02)
            if not self.drained():
                _LOG.error('serving: drain timeout (%.1fs) with %d '
                           'request(s) still unanswered',
                           self.drain_timeout, self.inflight())
        self._stop = True
        if self._sock is not None:
            self._sock.close()
        for engine in self.engines:
            engine.stop()
        for t in self._threads:
            t.join(timeout=5.0)
        if self.hub is not None:
            self.hub.close()     # flushes the final replies first

    # -- accept / admission ------------------------------------------------

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return            # listener closed: shutting down
            ep = FramedConnection(conn)
            if self.hub.count() >= self.max_clients:
                # admission control: refuse loudly instead of queueing a
                # client the engines cannot keep up with
                self.refused += 1
                self._m_shed.inc()
                try:
                    ep.send((SERVE_KIND,
                             {'error': 'service full (%d clients)'
                                       % self.max_clients}))
                finally:
                    ep.close()
                continue
            # clients may idle between matches: no silent-peer deadline
            self.hub.attach(ep, liveness=0)
            self._m_clients.set(self.hub.count())

    # -- dispatch ----------------------------------------------------------

    def _dispatch_loop(self):
        while not self._stop:
            try:
                ep, msg = self.hub.recv(timeout=0.3)
            except queue.Empty:
                self._m_clients.set(self.hub.count())
                continue
            try:
                body = msg[1] if (isinstance(msg, (list, tuple))
                                  and len(msg) == 2
                                  and isinstance(msg[1], dict)) else {}
                if is_infer(msg):
                    self._submit(ep, body)
                elif is_serve(msg):
                    self._admin(ep, body)
                else:
                    self.hub.send(ep, (SERVE_KIND,
                                       {'error': 'unknown frame kind'}))
            except Exception as exc:   # noqa: BLE001 — the loop must live
                _LOG.exception('serving: dispatch error (%s: %s)',
                               type(exc).__name__, str(exc)[:200])

    def _client_label(self, ep, body: Dict[str, Any]) -> str:
        name = body.get('client')
        if name:
            return str(name)[:64]
        try:
            return '%s:%s' % ep.sock.getpeername()[:2]
        except (OSError, AttributeError, TypeError):
            return 'unknown'

    def _error_reply(self, ep, body: Dict[str, Any], reason: str,
                     error: str):
        """Answer a request the service itself rejects (resolve failure,
        drain, missing fields): counted and always SENT."""
        self._m_errors(reason).inc()
        self.answered += 1
        self.hub.send(ep, (INFER_KIND, {'rid': body.get('rid'),
                                        'engine_fault': True,
                                        'error': error}))

    def _submit(self, ep, body: Dict[str, Any]):
        self.received += 1
        if self._draining:
            self._error_reply(ep, body, 'draining',
                              'service draining (restart imminent)')
            return
        spec = body.get('model')
        try:
            if spec is not None:
                line, selector = parse_spec(str(spec))
            elif body.get('mid') is not None:
                # bare integer ids resolve as versions of the default line
                line, selector = self.default_line, str(int(body['mid']))
            else:
                raise RegistryError('request names no model (neither '
                                    "'model' nor 'mid')")
            version, _meta = self.registry.resolve(line, selector)
        except (RegistryError, ValueError) as exc:
            self._error_reply(ep, body, 'resolve', str(exc))
            return
        if body.get('obs') is None:
            self._error_reply(ep, body, 'malformed', 'request carries no obs')
            return
        handle = self._intern(line, version)
        with self._lock:
            self._pending[(id(ep), body.get('rid'))] = (
                time.monotonic(), '%s@%s' % (line, version),
                self._client_label(ep, body))
            self._m_inflight.set(len(self._pending))
        self.engines[handle % len(self.engines)].submit(
            ep, dict(body, mid=handle))

    def _intern(self, line: str, version: str) -> int:
        with self._lock:
            key = (line, version)
            handle = self._handles.get(key)
            if handle is None:
                handle = len(self._handles) + 1
                self._handles[key] = handle
                self._handle_meta[handle] = key
            return handle

    def _fetch(self, handle: int) -> Dict[str, Any]:
        """Engine-side snapshot fetch: handle -> registry bytes (CRC
        re-verified on every load)."""
        with self._lock:
            line, version = self._handle_meta[handle]
        return self.registry.load_snapshot(line, version)

    def _reply(self, ep, msg: Dict[str, Any]):
        """Engine reply fan-in: close the latency span, count, forward."""
        with self._lock:
            entry = self._pending.pop((id(ep), (msg or {}).get('rid')), None)
            self._m_inflight.set(len(self._pending))
        if entry is not None:
            t0, model_label, client_label = entry
            self._m_latency(model_label, client_label).observe(
                time.monotonic() - t0)
            self._m_requests(model_label, client_label).inc()
            if msg.get('error'):
                self._m_errors('engine').inc()
        self.answered += 1
        self.hub.send(ep, (INFER_KIND, msg))

    # -- admin frames ------------------------------------------------------

    def _admin(self, ep, body: Dict[str, Any]):
        op = body.get('op')
        if op == 'status':
            self.hub.send(ep, (SERVE_KIND, self.stats()))
        elif op == 'resolve':
            try:
                line, selector = parse_spec(str(body.get('model')))
                version, meta = self.registry.resolve(line, selector)
                self.hub.send(ep, (SERVE_KIND,
                                   {'line': line, 'version': version,
                                    'steps': meta.get('steps'),
                                    'architecture': meta.get('architecture')}))
            except (RegistryError, ValueError) as exc:
                self.hub.send(ep, (SERVE_KIND, {'error': str(exc)}))
        else:
            self.hub.send(ep, (SERVE_KIND,
                               {'error': 'unknown admin op %r' % (op,)}))

    # -- introspection -----------------------------------------------------

    def inflight(self) -> int:
        with self._lock:
            return len(self._pending)

    def stats(self) -> Dict[str, Any]:
        # local tallies of THIS service instance, plus the process's kernel
        # launch counts (a served batch on the card launches the trunk
        # kernel once)
        return {
            'port': self.port,
            'device': str(self.device),
            'clients': self.hub.count() if self.hub is not None else 0,
            'received': self.received,
            'answered': self.answered,
            'inflight': self.inflight(),
            'shed': self.refused + sum(e.sheds for e in self.engines),
            'draining': self._draining,
            'engines': len(self.engines),
            'engine_requests': sum(e.requests_served for e in self.engines),
            'engine_batches': sum(e.batches_run for e in self.engines),
            'kernel_launches': kernel_launches(),
            'lines': {line: {'champion': entry['champion'],
                             'previous': entry['previous'],
                             'versions': sorted(entry['versions'])}
                      for line, entry in self.registry.describe().items()},
        }


def serve_main(args: Dict[str, Any], device: Any = 'cuda') -> int:
    """Run the service until SIGTERM/SIGINT, then drain and return 75 (the
    PreemptionGuard supervisor contract). Prints one JSON ready line on
    stdout carrying the bound port."""
    guard = PreemptionGuard().install()
    service = InferenceService(args, device=device).start()
    print(json.dumps({'serving_ready': {
        'port': service.port, 'pid': os.getpid(), 'device': str(service.device),
        'registry': service.registry.root}}), flush=True)
    try:
        while not guard.requested():
            time.sleep(0.2)
        _LOG.warning('serving: preemption signal received; draining')
    finally:
        service.stop(drain=True)
        guard.uninstall()
    return PREEMPT_EXIT_CODE
