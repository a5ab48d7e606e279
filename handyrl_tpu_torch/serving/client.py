"""Client side of the serving tier: the framed-protocol transport.

The subset of ``handyrl_tpu/serving/client.py`` the serving path uses.
:class:`ServiceClient` owns one TCP connection to an
:class:`~.service.InferenceService` (of either package: the wire format is
shared) and speaks the framed ``INFER_KIND`` protocol plus the
``SERVE_KIND`` admin frames (status / resolve).

Reply canonicalization: the wire codec turns numpy scalars into Python
floats; ``collect`` re-wraps the sampled probability as ``np.float32`` so a
reply equals the locally computed one.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np

from ..connection import INFER_KIND, connect_socket_connection, is_infer
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
               seed=None) -> int:
        """Post one inference request for ``model`` (a ``line@selector``
        spec); returns its request id."""
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
        self._send((INFER_KIND, body))
        return rid

    def collect(self, rid: int, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        """The reply for ``rid`` (raises :class:`ServiceError` on an error
        reply, TimeoutError past the deadline)."""
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
        return canonicalize_reply(reply)

    def request(self, model: str, obs, hidden=None, legal=None, seed=None,
                timeout: Optional[float] = None) -> Dict[str, Any]:
        return self.collect(self.submit(model, obs, hidden=hidden,
                                        legal=legal, seed=seed),
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

    def status(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        """The service's live stats: lines/champions, request counters,
        drain state."""
        return self._call_admin({'op': 'status'}, timeout)

    def resolve(self, spec: str, timeout: Optional[float] = None
                ) -> Dict[str, Any]:
        """Ask the service what ``line@selector`` currently names."""
        return self._call_admin({'op': 'resolve', 'model': str(spec)},
                                timeout)

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

