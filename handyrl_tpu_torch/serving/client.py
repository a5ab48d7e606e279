"""Client side of the serving tier: the framed-protocol transport and the
``serve://`` model proxy.

The port of ``handyrl_tpu/serving/client.py``. :class:`ServiceClient`
owns one TCP connection to an :class:`~.service.InferenceService` (of
either package: the wire format is shared) and speaks the framed
``INFER_KIND`` protocol plus the ``SERVE_KIND`` admin frames (status /
resolve / fleet / warm, and the gateway's session ops).
:class:`RemoteServiceModel` wraps a client (or the fleet's
:class:`~.fleet.RoutedClient`) and a ``line@selector`` spec into the model
surface the agents call (``inference`` / ``init_hidden``), so a match
resolves its model by name against a running service or fleet.

Reply canonicalization: the wire codec turns numpy scalars into Python
floats; ``collect`` re-wraps the sampled probability as ``np.float32`` so a
reply equals the locally computed one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .. import telemetry
from ..connection import (INFER_KIND, TRACE_KEY, connect_socket_connection,
                          is_infer)
from ..fault import Backoff

# transport-layer exceptions that mean "the socket died", as opposed to a
# service-sent error frame (ValueError covers framing-layer corruption)
_TRANSPORT_ERRORS = (OSError, ConnectionError, EOFError, ValueError)

# Admin frames on a service connection (status / resolve / drain probes).
# Rides next to INFER_KIND; the Hub passes both through untyped.
SERVE_KIND = '__serve__'


def is_serve(msg) -> bool:
    """True for a serving-tier admin frame (request or reply)."""
    return (isinstance(msg, (list, tuple)) and len(msg) == 2
            and msg[0] == SERVE_KIND)


def parse_endpoint(endpoint: str) -> Tuple[str, int]:
    """``'host:port'`` -> (host, port); a bare port means localhost."""
    host, _, port = str(endpoint).rpartition(':')
    return host or 'localhost', int(port)


def canonicalize_reply(reply: Dict[str, Any]) -> Dict[str, Any]:
    """Restore the scalar dtype the engine computed: the wire codec turns
    ``np.float32`` scalars into python floats, and a record storing the
    python float would pickle to different bytes than the local path's."""
    if isinstance(reply.get('prob'), float):
        reply['prob'] = np.float32(reply['prob'])
    return reply


class ServiceError(RuntimeError):
    """The service answered a request with an error reply."""


class ServiceUnavailable(RuntimeError):
    """Transport-level failure: the service could not be dialed, or the
    socket died before a reply landed. DISTINCT from :class:`ServiceError`
    (the service itself answered with an error frame): an unavailable
    service never saw — or never answered — the request, and because
    requests are pure in ``(model@version, obs, seed)`` the caller may
    safely replay it against another replica for a byte-identical reply."""


class ServiceClient:
    """One client connection to an InferenceService endpoint.

    ``submit``/``collect`` split (so simultaneous requests pipeline into
    one engine batch, like the worker's act_send/act_recv); ``request`` is
    the one-shot convenience. Thread-safe for one submitter at a time per
    instance — concurrent load generators should hold one client each.

    Dialing retries ``dial_retries`` times with jittered backoff before
    raising :class:`ServiceUnavailable` (a restarting replica's listen
    socket is down for tens of milliseconds; callers should not crash on
    that). A socket that dies later surfaces as :class:`ServiceUnavailable`
    from ``submit``/``collect``; the next ``submit`` redials.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 name: str = '', dial_retries: int = 3,
                 dial_backoff: float = 0.2):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self.name = name
        self.dial_retries = max(0, int(dial_retries))
        self.dial_backoff = float(dial_backoff)
        self.conn = None
        self._rid = 0
        self._box: Dict[int, Dict[str, Any]] = {}   # rid -> early reply
        self._traces: Dict[int, Tuple[Any, float]] = {}   # rid -> (tid, t0)
        self._admin: deque = deque()                # out-of-band serve frames
        self._lock = threading.Lock()
        self._connect()

    def _connect(self):
        backoff = Backoff(initial=self.dial_backoff, maximum=2.0)
        last: Optional[BaseException] = None
        for attempt in range(self.dial_retries + 1):
            try:
                self.conn = connect_socket_connection(self.host, self.port)
                return
            except _TRANSPORT_ERRORS as exc:
                last = exc
                if attempt < self.dial_retries:
                    time.sleep(backoff.next_delay())
        self.conn = None
        raise ServiceUnavailable(
            'cannot dial service %s:%d after %d attempt(s): %s'
            % (self.host, self.port, self.dial_retries + 1, last))

    def _drop(self, why: BaseException) -> ServiceUnavailable:
        """Close the dead socket and build the exception to raise; replies
        in flight on it are gone (the rid book dies with the socket)."""
        self.close()
        return ServiceUnavailable(
            'connection to service %s:%d lost: %s' % (self.host, self.port,
                                                      why))

    def close(self):
        conn, self.conn = self.conn, None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    # -- request path ------------------------------------------------------

    def submit(self, model: str, obs, hidden=None, legal=None,
               seed=None, trace=None) -> int:
        """Post one inference request for ``model`` (a ``line@selector``
        spec); returns its request id.

        ``trace`` is the serving-path trace context: the caller's id when
        one exists (router replays, gateway plies), else a fresh one is
        minted here, at the request's edge, whenever tracing is on. It
        rides in the body under ``TRACE_KEY`` so every downstream hop
        stamps the same id; the matching ``client_request`` span closes in
        :meth:`collect`."""
        if trace is None and telemetry.trace_enabled():
            trace = telemetry.mint_trace_id()
        with self._lock:
            self._rid += 1
            rid = self._rid
        body: Dict[str, Any] = {'rid': rid, 'model': str(model), 'obs': obs}
        if self.name:
            body['client'] = self.name
        if hidden is not None:
            body['hidden'] = hidden
        if legal is not None:
            body['legal'] = [int(a) for a in legal]
        if seed is not None:
            body['seed'] = [int(s) for s in seed]
        if trace:
            body[TRACE_KEY] = trace
            # wall clock for the Chrome trace only: never in the reply
            self._traces[rid] = (trace, time.time())
        self._send((INFER_KIND, body))
        return rid

    def collect(self, rid: int, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        """The reply for ``rid`` (raises :class:`ServiceError` on an error
        reply, TimeoutError past the deadline)."""
        ctx = self._traces.pop(rid, None)
        if rid in self._box:
            reply = self._box.pop(rid)
        else:
            reply = self._await(lambda m: (is_infer(m)
                                           and m[1].get('rid') == rid),
                                timeout)
            if reply is None:
                raise TimeoutError('no service reply for rid %d within '
                                   '%.1fs' % (rid, timeout or self.timeout))
            reply = reply[1]
        if reply.get('error'):
            raise ServiceError(str(reply['error']))
        if ctx is not None:
            tid, t0 = ctx
            telemetry.trace_event('client_request', ts=t0,
                                  dur=time.time() - t0, trace_id=tid,
                                  rid=rid, client=self.name or '')
        return canonicalize_reply(reply)

    def trace_of(self, rid: int):
        """The trace context minted for an in-flight ``rid`` (None when
        unsampled or already collected): the router reads it to link
        replay spans to the original id."""
        ctx = self._traces.get(rid)
        return ctx[0] if ctx else None

    def request(self, model: str, obs, hidden=None, legal=None, seed=None,
                trace=None, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        return self.collect(self.submit(model, obs, hidden=hidden,
                                        legal=legal, seed=seed, trace=trace),
                            timeout=timeout)

    # -- admin frames ------------------------------------------------------

    def _call_admin(self, body: Dict[str, Any],
                    timeout: Optional[float] = None) -> Dict[str, Any]:
        self._send((SERVE_KIND, body))
        reply = self._await(is_serve, timeout)
        if reply is None:
            raise TimeoutError('no %r reply from the service'
                               % body.get('op'))
        return reply[1]

    def call_admin(self, body: Dict[str, Any],
                   timeout: Optional[float] = None) -> Dict[str, Any]:
        """One admin round trip: send a SERVE_KIND frame, await the reply
        body (the gateway client's whole session protocol rides it; admin
        frames interleave with inference replies in flight)."""
        return self._call_admin(dict(body), timeout)

    def status(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """The service's live stats: lines/champions, request counters,
        drain state."""
        return self._call_admin({'op': 'status'}, timeout)

    def resolve(self, spec: str, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        """Ask the service what ``line@selector`` currently names."""
        return self._call_admin({'op': 'resolve', 'model': str(spec)},
                                timeout)

    def fleet(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """The fleet replica table (a resolver answers it; a plain service
        answers an unknown-op error body, see :func:`model_from_spec`)."""
        return self._call_admin({'op': 'fleet'}, timeout)

    # -- internals ---------------------------------------------------------

    def _send(self, msg):
        """Frame out one message, redialing a previously-dropped socket;
        transport death raises :class:`ServiceUnavailable` (retryable)."""
        if self.conn is None:
            self._connect()
        try:
            self.conn.send(msg)
        except _TRANSPORT_ERRORS as exc:
            raise self._drop(exc)

    def _await(self, want, timeout: Optional[float]):
        """Next frame matching ``want``; early inference replies are boxed,
        stray admin frames queued. None on deadline; a dead socket raises
        :class:`ServiceUnavailable` (retryable), never a raw OSError."""
        if want is is_serve and self._admin:
            return (SERVE_KIND, self._admin.popleft())
        if self.conn is None:
            raise ServiceUnavailable(
                'connection to service %s:%d is down (pending replies died '
                'with it)' % (self.host, self.port))
        deadline = time.monotonic() + (self.timeout if timeout is None
                                       else float(timeout))
        while True:
            remaining = deadline - time.monotonic()
            try:
                if remaining <= 0 or not self.conn.poll(remaining):
                    return None
                msg = self.conn.recv()
            except _TRANSPORT_ERRORS as exc:
                raise self._drop(exc)
            if want(msg):
                return msg
            if is_infer(msg) and isinstance(msg[1], dict):
                rid = msg[1].get('rid')
                if rid is not None:
                    self._box[rid] = msg[1]
                continue
            if is_serve(msg) and isinstance(msg[1], dict):
                self._admin.append(msg[1])



class RemoteServiceModel:
    """Model-surface proxy over a :class:`ServiceClient` (or a
    :class:`~.fleet.RoutedClient`, which has its surface): each call is a
    request frame against one ``line@selector`` spec. ``init_hidden``
    returns None by design: the engine substitutes a fresh initial state
    for a None hidden, so the client needs no knowledge of the recurrent
    state's structure."""

    def __init__(self, client: ServiceClient, model: str):
        self.client = client
        self.model = str(model)

    def init_hidden(self, batch_shape=None):
        return None

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        return self.client.request(self.model, obs, hidden=hidden)['outputs']

    def close(self):
        self.client.close()


def model_from_spec(spec: str, timeout: float = 10.0) -> RemoteServiceModel:
    """``'serve://host:port/line@selector'`` -> a connected proxy model
    (owning its client connection).

    The endpoint may be a single service or a fleet resolver: one
    ``fleet`` probe at connect time (a plain service answers an unknown-op
    error body) decides, and a resolver's spec gets a
    :class:`~.fleet.RoutedClient`, so a ``serve://`` opponent fails over
    between the fleet's replicas."""
    rest = str(spec)
    if rest.startswith('serve://'):
        rest = rest[len('serve://'):]
    endpoint, _, model = rest.partition('/')
    if not model:
        raise ValueError('serve:// spec %r carries no line@selector path'
                         % spec)
    host, port = parse_endpoint(endpoint)
    client = ServiceClient(host, port, timeout=timeout)
    try:
        probe = client.fleet(timeout=min(timeout, 5.0))
    except (TimeoutError, ServiceUnavailable):
        probe = {}
    if probe.get('fleet'):
        client.close()
        from .fleet import RoutedClient   # fleet imports this module
        return RemoteServiceModel(RoutedClient(host, port, timeout=timeout),
                                  model)
    return RemoteServiceModel(client, model)
