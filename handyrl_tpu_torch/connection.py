"""Transport: a data-only wire codec, framed sockets and an event-loop hub.

The subset of ``handyrl_tpu/connection.py`` the serving path uses, wire
compatible with it:

* **Codec.** :func:`pack` / :func:`unpack` are a small pure-Python encoder
  and decoder for the msgpack subset the protocol uses: nil, bool, int,
  float, str, bin, array, map, and ext type 1 for numpy arrays (payload =
  msgpack ``[dtype.str, shape]`` followed by the raw C-order bytes). The
  bytes equal ``msgpack.packb(msg, default=..., use_bin_type=True)`` with
  the JAX package's ndarray hook, so peers of either package talk to each
  other. Numpy scalars travel as Python scalars. A frame decodes only to
  data, never to code.
* **Framing.** 4-byte big-endian length headers; :class:`FrameParser`
  validates every length before buffering. A spawned process takes a
  connection, read-ahead included, as a :class:`SocketHandover` (the
  network battle's runners and client children).
* **Hub.** One selector read loop plus one writer thread per endpoint;
  heartbeat frames (``HEARTBEAT_KIND``) refresh a peer's liveness deadline
  and land in ``peer_info_snapshot`` instead of the inbox, and every
  detach is journaled (``drain_detach_events``) for the learner's task
  ledger. A detached peer's last heartbeat stays readable
  (``departed_peer_info``): a worker's and a gather's final beacon arrive
  just before they close.
* **Process pool.** :func:`spawn_pipe_workers` and :class:`JobPool`: jobs
  fanned out to spawned children over pipes (the batcher processes, and
  the worker plane's gathers and workers, whose pipes the Hub multiplexes
  through :class:`PipeEndpoint`).
"""

from __future__ import annotations

import contextlib
import os
import queue
import select
import selectors
import socket
import struct
import sys
import threading
import time
import traceback
import types
from collections import deque
from typing import (Any, Callable, Dict, Iterator, List, NamedTuple,
                    Optional, Tuple)

import numpy as np

from . import telemetry

_HEADER = struct.Struct('!i')
_EXT_NDARRAY = 1

# the wire's byte and frame counters (every framed socket of the process)
_NET_TX = telemetry.counter('net_bytes_sent_total')
_NET_RX = telemetry.counter('net_bytes_recv_total')
_NET_FRAMES_TX = telemetry.counter('net_frames_sent_total')
_LOG = telemetry.get_logger('connection')


# ---------------------------------------------------------------------------
# codec


class ExtType(NamedTuple):
    """An ext value of a type this codec does not interpret."""
    code: int
    data: bytes


def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xff)
    elif n >= 0:
        if n <= 0xff:
            out += b'\xcc' + struct.pack('>B', n)
        elif n <= 0xffff:
            out += b'\xcd' + struct.pack('>H', n)
        elif n <= 0xffffffff:
            out += b'\xce' + struct.pack('>I', n)
        elif n <= 0xffffffffffffffff:
            out += b'\xcf' + struct.pack('>Q', n)
        else:
            raise OverflowError('int %d too large for the wire' % n)
    elif n >= -0x80:
        out += b'\xd0' + struct.pack('>b', n)
    elif n >= -0x8000:
        out += b'\xd1' + struct.pack('>h', n)
    elif n >= -0x80000000:
        out += b'\xd2' + struct.pack('>i', n)
    elif n >= -0x8000000000000000:
        out += b'\xd3' + struct.pack('>q', n)
    else:
        raise OverflowError('int %d too small for the wire' % n)


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes: bytes,
              out: bytearray):
    """Length header: a fix form below ``fix_max`` (when the family has
    one), else the 8/16/32-bit forms named by ``codes`` (None = absent)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xff:
        out += bytes((codes[0], n))
    elif n <= 0xffff:
        out += bytes((codes[1],)) + struct.pack('>H', n)
    elif n <= 0xffffffff:
        out += bytes((codes[2],)) + struct.pack('>I', n)
    else:
        raise ValueError('object of %d entries is too large for the wire' % n)


_FIXEXT = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}


def _pack_ext(code: int, data: bytes, out: bytearray):
    n = len(data)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    elif n <= 0xff:
        out += bytes((0xc7, n))
    elif n <= 0xffff:
        out += b'\xc8' + struct.pack('>H', n)
    else:
        out += b'\xc9' + struct.pack('>I', n)
    out += struct.pack('>b', code)
    out += data


def _default(obj):
    """Numpy arrays become ext type 1, numpy scalars Python scalars; any
    other type is refused (data-only codec)."""
    if isinstance(obj, np.ndarray):
        header = pack([obj.dtype.str, list(obj.shape)])
        return ExtType(_EXT_NDARRAY,
                       header + np.ascontiguousarray(obj).tobytes())
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError('refusing to serialize %r (data-only codec)' % type(obj))


def _pack(obj, out: bytearray, depth: int = 0):
    if depth > 512:
        raise ValueError('message nested too deeply')
    # the type tests follow msgpack's own order, so subclasses (np.float64
    # is a float, np.str_ a str, ExtType a tuple) encode as msgpack does
    for _ in range(2):
        if obj is None:
            out.append(0xc0)
        elif obj is True:
            out.append(0xc3)
        elif obj is False:
            out.append(0xc2)
        elif isinstance(obj, int):
            _pack_int(int(obj), out)
        elif isinstance(obj, float):
            out += b'\xcb' + struct.pack('>d', obj)
        elif isinstance(obj, (bytes, bytearray)):
            _pack_len(len(obj), None, 0, b'\xc4\xc5\xc6', out)
            out += obj
        elif isinstance(obj, str):
            raw = obj.encode('utf-8')
            _pack_len(len(raw), 0xa0, 32, b'\xd9\xda\xdb', out)
            out += raw
        elif isinstance(obj, dict):
            _pack_len(len(obj), 0x80, 16, b'\x00\xde\xdf', out)
            for k, v in obj.items():
                _pack(k, out, depth + 1)
                _pack(v, out, depth + 1)
        elif isinstance(obj, ExtType):
            _pack_ext(obj.code, obj.data, out)
        elif isinstance(obj, (list, tuple)):
            _pack_len(len(obj), 0x90, 16, b'\x00\xdc\xdd', out)
            for v in obj:
                _pack(v, out, depth + 1)
        elif isinstance(obj, memoryview):
            raw = obj.tobytes()
            _pack_len(len(raw), None, 0, b'\xc4\xc5\xc6', out)
            out += raw
        else:
            obj = _default(obj)
            continue
        return
    raise TypeError('cannot serialize %r' % type(obj))


def pack(msg) -> bytes:
    """Serialize a message for the wire. Tuples become lists, as with
    msgpack: every protocol message is a ``(kind, payload)`` pair and all
    receive sites sequence-unpack."""
    out = bytearray()
    _pack(msg, out)
    return bytes(out)


class _Reader:
    __slots__ = ('data', 'pos')

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError('truncated message')
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def fmt(self, f: str):
        s = struct.Struct(f)
        return s.unpack(self.take(s.size))[0]


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        r = _Reader(data)
        dtype_str, shape = _read(r, 0)
        arr = np.frombuffer(data[r.pos:], dtype=np.dtype(dtype_str))
        return arr.reshape(shape).copy()
    return ExtType(code, data)


def _read_array(r: _Reader, n: int, depth: int, ext) -> list:
    return [_read(r, depth + 1, ext) for _ in range(n)]


def _read_map(r: _Reader, n: int, depth: int, ext) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, depth + 1, ext)
        out[k] = _read(r, depth + 1, ext)
    return out


def _read(r: _Reader, depth: int, ext=_decode_ext):
    """One msgpack object from ``r``; ``ext(code, data)`` decodes ext
    values (the wire's by default)."""
    if depth > 512:
        raise ValueError('message nested too deeply')
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f, depth, ext)
    if 0x90 <= b <= 0x9f:
        return _read_array(r, b & 0x0f, depth, ext)
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), 'utf-8')
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in (0xc4, 0xc5, 0xc6):
        n = r.fmt({0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}[b])
        return bytes(r.take(n))
    if b in (0xc7, 0xc8, 0xc9):
        n = r.fmt({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[b])
        code = r.fmt('>b')
        return ext(code, bytes(r.take(n)))
    if b == 0xca:
        return r.fmt('>f')
    if b == 0xcb:
        return r.fmt('>d')
    if 0xcc <= b <= 0xd3:
        return r.fmt('>' + 'BHIQbhiq'[b - 0xcc])
    if 0xd4 <= b <= 0xd8:
        n = 1 << (b - 0xd4)
        code = r.fmt('>b')
        return ext(code, bytes(r.take(n)))
    if b in (0xd9, 0xda, 0xdb):
        n = r.fmt({0xd9: '>B', 0xda: '>H', 0xdb: '>I'}[b])
        return str(r.take(n), 'utf-8')
    if b in (0xdc, 0xdd):
        return _read_array(r, r.fmt('>H' if b == 0xdc else '>I'), depth,
                           ext)
    if b in (0xde, 0xdf):
        return _read_map(r, r.fmt('>H' if b == 0xde else '>I'), depth, ext)
    raise ValueError('unknown msgpack type byte 0x%02x' % b)


def unpack(payload: bytes):
    """Inverse of :func:`pack`. Decodes only data, never code objects."""
    r = _Reader(payload)
    msg = _read(r, 0)
    if r.pos != len(r.data):
        raise ValueError('%d trailing bytes after the message'
                         % (len(r.data) - r.pos))
    return msg


# ---------------------------------------------------------------------------
# endpoints


MAX_FRAME_BYTES = 256 * (1 << 20)   # largest legal payload (256 MiB)


class FrameParser:
    """Incremental splitter of a byte stream into length-framed payloads.
    Lengths come from the network, so a negative or oversized header
    poisons the connection instead of buffering without bound."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf += data
        frames = []
        while len(self._buf) >= _HEADER.size:
            (n,) = _HEADER.unpack_from(self._buf)
            if n < 0 or n > MAX_FRAME_BYTES:
                raise ConnectionResetError(
                    'protocol violation: frame length %d' % n)
            if len(self._buf) < _HEADER.size + n:
                break
            frames.append(bytes(self._buf[_HEADER.size:_HEADER.size + n]))
            del self._buf[:_HEADER.size + n]
        return frames


class SocketHandover(NamedTuple):
    """A :class:`FramedConnection` on its way into a spawned process: the
    socket, which multiprocessing's reducer duplicates into the child as
    it starts, and the bytes the parent had read but not consumed, framed
    again. :meth:`open` rebuilds the connection in the child."""

    sock: socket.socket
    pending: bytes

    def open(self) -> 'FramedConnection':
        conn = FramedConnection(self.sock)
        conn._ready.extend(conn._parser.feed(self.pending))
        return conn


class FramedConnection:
    """Duplex message endpoint over a stream socket: blocking
    ``send``/``recv`` for call-response clients, non-blocking ``drain``
    for the Hub. A connection cannot be pickled (its send lock); a spawned
    process takes it as a :meth:`handover`."""

    def __init__(self, sock: socket.socket):
        self.sock: Optional[socket.socket] = sock
        self._parser = FrameParser()
        self._ready: deque = deque()
        # concurrent senders would splice two frames together
        self._send_lock = threading.Lock()

    def fileno(self) -> int:
        return self.sock.fileno()

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            finally:
                self.sock = None

    __del__ = close

    def send(self, msg):
        payload = pack(msg)
        if len(payload) > MAX_FRAME_BYTES:
            raise ValueError('message of %d bytes exceeds the frame limit'
                             % len(payload))
        with self._send_lock:
            self.sock.sendall(_HEADER.pack(len(payload)) + payload)
        _NET_TX.inc(_HEADER.size + len(payload))
        _NET_FRAMES_TX.inc()

    @staticmethod
    def _decode(payload: bytes):
        """A frame that passed the length check can still carry garbage;
        a decode failure poisons the connection."""
        try:
            return unpack(payload)
        except Exception as exc:
            raise ConnectionResetError('undecodable frame (%s: %s)'
                                       % (type(exc).__name__,
                                          str(exc)[:80])) from exc

    def recv(self):
        while not self._ready:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionResetError('peer closed')
            _NET_RX.inc(len(chunk))
            self._ready.extend(self._parser.feed(chunk))
        return self._decode(self._ready.popleft())

    def handover(self) -> SocketHandover:
        """The socket and every frame and byte already read from it, as an
        argument of a spawned process. A frame the peer sent with the last
        one consumed here (a battle's first command behind its env_args)
        may sit in this read-ahead; dropping it would leave the child
        waiting for it forever. Under 'spawn' the child holds its
        duplicate of the socket once ``Process.start()`` has returned:
        only then may this copy be closed, and nothing reads it before."""
        pending = b''.join(_HEADER.pack(len(p)) + p for p in self._ready)
        return SocketHandover(self.sock, pending + bytes(self._parser._buf))

    def poll(self, timeout: float = 0.0) -> bool:
        """True when a recv() would find data within ``timeout`` seconds."""
        if self._ready:
            return True
        if self.sock is None:
            return False
        readable, _, _ = select.select([self.sock], [], [],
                                       max(0.0, float(timeout)))
        return bool(readable)

    def drain(self) -> List[Any]:
        """Non-blocking read of everything currently available."""
        try:
            chunk = self.sock.recv(1 << 16, socket.MSG_DONTWAIT)
        except (BlockingIOError, InterruptedError):
            return []
        if not chunk:
            raise ConnectionResetError('peer closed')
        _NET_RX.inc(len(chunk))
        self._ready.extend(self._parser.feed(chunk))
        out = [self._decode(p) for p in self._ready]
        self._ready.clear()
        return out


class PipeEndpoint:
    """Adapter giving an ``mp.Connection`` the endpoint surface of
    :class:`FramedConnection` (``drain`` for the Hub)."""

    def __init__(self, conn):
        self.conn = conn

    def fileno(self) -> int:
        return self.conn.fileno()

    def close(self):
        self.conn.close()

    def send(self, msg):
        self.conn.send(msg)

    def recv(self):
        return self.conn.recv()

    def drain(self) -> List[Any]:
        """Everything available now. A peer's last messages and its EOF
        can arrive together: the messages are returned, and the EOF raises
        on the next call (the JAX package's drain loses them)."""
        out = []
        try:
            while self.conn.poll(0):
                out.append(self.conn.recv())
        except (EOFError, OSError):
            if not out:
                raise
        return out


def send_recv(conn, msg):
    """One blocking call-response on an endpoint."""
    conn.send(msg)
    return conn.recv()


# ---------------------------------------------------------------------------
# sockets


def open_socket_connection(port: int, host: str = '') -> socket.socket:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, int(port)))
    return sock


def connect_socket_connection(host: str, port: int) -> FramedConnection:
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.connect((host, int(port)))
    return FramedConnection(sock)


def accept_socket_connections(port: int, timeout: Optional[float] = None,
                              maxsize: int = 1024
                              ) -> Iterator[Optional[FramedConnection]]:
    """Yield one FramedConnection per accepted client; None on idle
    timeout. The listening socket closes when the iteration ends."""
    sock = open_socket_connection(port)
    try:
        sock.listen(maxsize)
        sock.settimeout(timeout)
        accepted = 0
        while accepted < maxsize:
            try:
                conn, _ = sock.accept()
            except socket.timeout:
                yield None
                continue
            accepted += 1
            yield FramedConnection(conn)
    finally:   # the caller stopped iterating
        sock.close()


# ---------------------------------------------------------------------------
# frame kinds

# Heartbeat frames are a one-way beacon from blocking RPC clients (workers
# to their gather, gathers to the learner): the Hub refreshes the sender's
# liveness deadline, keeps the payload (the sender's stats) and never
# replies, since a reply would land inside the client's call-response
# stream.
HEARTBEAT_KIND = '__hb__'

# Inference-service frames: a request ``(INFER_KIND, body)`` is answered
# with ``(INFER_KIND, reply)``, matched by the body's ``rid``.
INFER_KIND = '__infer__'

# The resume-token handshake of the durable training plane: a gather's
# first frame after a redial is a ``(RESUME_KIND, {gather, run_id,
# generation})`` RPC. A restarted learner that recognizes the run_id
# answers ``{'ok': True, 'run_id', 'generation'}`` and the gather
# reattaches in place (its resend buffer replayed, nothing respawned); any
# other answer sends the gather down the cold-respawn path.
RESUME_KIND = '__resume__'

# Serving-path trace context rides inside the INFER body under this key;
# peers that do not trace ignore it.
TRACE_KEY = 'trace'


def is_heartbeat(msg) -> bool:
    return (isinstance(msg, (list, tuple)) and len(msg) == 2
            and msg[0] == HEARTBEAT_KIND)


def is_infer(msg) -> bool:
    """True for an inference-service frame (request or reply)."""
    return (isinstance(msg, (list, tuple)) and len(msg) == 2
            and msg[0] == INFER_KIND)


# ---------------------------------------------------------------------------
# event-loop hub


_WRITER_EXIT = object()   # per-endpoint writer shutdown sentinel


def _describe(endpoint) -> str:
    sock = getattr(endpoint, 'sock', None)
    if sock is not None:
        try:
            peer = sock.getpeername()
        except OSError:
            return 'socket peer (already closed)'
        if isinstance(peer, tuple) and len(peer) >= 2:   # AF_INET[6]
            return 'socket peer %s:%s' % peer[:2]
        return 'socket peer %r' % (peer,)                # AF_UNIX
    try:
        return 'pipe fd %d' % endpoint.fileno()
    except Exception:
        return 'endpoint'


class Hub:
    """Message multiplexer: one selector read loop + one writer per endpoint.

    Incoming messages land in one inbox as ``(endpoint, message)``;
    outgoing messages go to a PER-ENDPOINT outbox drained by that
    endpoint's own writer thread, so a peer that stops reading delays only
    its own replies. A peer is detached on a read or write error, a send
    past ``SEND_TIMEOUT``, an outbox past ``OUTBOX_MAX`` messages, or
    silence longer than its liveness deadline (``LIVENESS_TIMEOUT`` for
    sockets by default; pipes have none, a dead pipe peer is an EOF).
    Any received frame refreshes the deadline; heartbeat frames stay out
    of the inbox and their payloads are kept per endpoint
    (``peer_info_snapshot``), and past its detach
    (``departed_peer_info``). Every detach is counted by reason in
    ``stats`` and journaled for ``drain_detach_events``."""

    SEND_TIMEOUT = 30.0
    OUTBOX_MAX = 512
    LIVENESS_TIMEOUT = 60.0   # silent-socket-peer deadline; 0 disables
    DEPARTED_MAX = 4096       # detached peers whose last heartbeat is kept

    def __init__(self, inbox_max: int = 256):
        self._inbox: queue.Queue = queue.Queue(maxsize=inbox_max)
        self._lock = threading.Lock()
        self._outboxes: Dict[Any, queue.Queue] = {}        # guarded-by: _lock
        self._commands: deque = deque()                    # guarded-by: _lock
        self._liveness: Dict[Any, float] = {}              # guarded-by: _lock
        self._last_recv: Dict[Any, float] = {}             # guarded-by: _lock
        self._peer_info: Dict[Any, Any] = {}               # guarded-by: _lock
        self._departed: Dict[Any, Any] = {}                # guarded-by: _lock
        self._detach_events: deque = deque(maxlen=4096)    # guarded-by: _lock
        self.stats: Dict[str, int] = {}                    # guarded-by: _lock
        self._closed = False
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._selector = selectors.DefaultSelector()
        self._selector.register(self._wake_r, selectors.EVENT_READ, None)
        self._reader = threading.Thread(target=self._read_loop,
                                        name='hub-read', daemon=True)
        self._reader.start()

    def count(self) -> int:
        with self._lock:
            return len(self._outboxes)

    def stats_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.stats)

    def peer_info_snapshot(self) -> Dict[Any, Any]:
        """Latest heartbeat payload per live endpoint."""
        with self._lock:
            return dict(self._peer_info)

    def departed_peer_info(self) -> Dict[Any, Any]:
        """Last heartbeat payload of each detached endpoint (the newest
        ``DEPARTED_MAX`` of them)."""
        with self._lock:
            return dict(self._departed)

    def drain_detach_events(self) -> List[Tuple[Any, str, float]]:
        """Consume the (endpoint, reason, time) disconnect journal."""
        with self._lock:
            events = list(self._detach_events)
            self._detach_events.clear()
        return events

    def recv(self, timeout: Optional[float] = None) -> Tuple[Any, Any]:
        return self._inbox.get(timeout=timeout)

    def send(self, endpoint, msg):
        with self._lock:
            outbox = self._outboxes.get(endpoint)
        if outbox is None:      # already detached: drop, like a dead socket
            return
        try:
            outbox.put_nowait(msg)
        except queue.Full:      # peer hopelessly behind: treat as stalled
            self.detach(endpoint, reason='outbox_overflow')

    def attach(self, endpoint, liveness: Optional[float] = None):
        """Register ``endpoint``; ``liveness`` > 0 detaches it after that
        many seconds without a received frame (default:
        ``LIVENESS_TIMEOUT`` for a socket, none for a pipe)."""
        sock = getattr(endpoint, 'sock', None)
        if sock is not None:
            sock.settimeout(self.SEND_TIMEOUT)   # bound writer stalls
        if liveness is None:
            liveness = self.LIVENESS_TIMEOUT if sock is not None else 0.0
        outbox: queue.Queue = queue.Queue(maxsize=self.OUTBOX_MAX)
        with self._lock:
            if endpoint in self._outboxes:
                return
            self._outboxes[endpoint] = outbox
            self._liveness[endpoint] = float(liveness or 0.0)
            self._last_recv[endpoint] = time.monotonic()
            self._commands.append(('+', endpoint))
            self.stats['attached'] = self.stats.get('attached', 0) + 1
            telemetry.gauge('hub_peers').set(len(self._outboxes))
        threading.Thread(target=self._write_loop, args=(endpoint, outbox),
                         name='hub-write', daemon=True).start()
        self._wake()

    def detach(self, endpoint, reason: str = 'requested'):
        with self._lock:
            outbox = self._outboxes.pop(endpoint, None)
            if outbox is not None:
                self._liveness.pop(endpoint, None)
                self._last_recv.pop(endpoint, None)
                info = self._peer_info.pop(endpoint, None)
                if info is not None:
                    self._departed[endpoint] = info
                    while len(self._departed) > self.DEPARTED_MAX:
                        self._departed.pop(next(iter(self._departed)))
                self._commands.append(('-', endpoint))
                self.stats['detached'] = self.stats.get('detached', 0) + 1
                key = 'disconnect_' + reason
                self.stats[key] = self.stats.get(key, 0) + 1
                self._detach_events.append((endpoint, reason, time.time()))
                telemetry.gauge('hub_peers').set(len(self._outboxes))
        if outbox is None:
            return
        telemetry.counter('hub_disconnects_total', reason=reason).inc()
        _LOG.info('disconnected %s (%s)', _describe(endpoint), reason)
        try:
            outbox.put_nowait(_WRITER_EXIT)
        except queue.Full:      # the writer also polls its attachment
            pass
        self._wake()

    def close(self, timeout: float = 5.0):
        """Detach every endpoint, letting each writer flush its outbox
        first, and stop the read loop."""
        with self._lock:
            endpoints = list(self._outboxes)
        for ep in endpoints:
            with self._lock:
                outbox = self._outboxes.get(ep)
            if outbox is not None:
                deadline = time.monotonic() + timeout
                while not outbox.empty() and time.monotonic() < deadline:
                    time.sleep(0.01)
            self.detach(ep, reason='closed')
        self._closed = True
        self._wake()
        self._reader.join(timeout)

    # -- loop internals --

    def _wake(self):
        try:
            self._wake_w.send(b'.')
        except OSError:
            pass

    def _apply_commands(self):
        while True:
            with self._lock:
                if not self._commands:
                    return
                op, ep = self._commands.popleft()
            try:
                if op == '+':
                    self._selector.register(ep, selectors.EVENT_READ, ep)
                else:
                    self._selector.unregister(ep)
                    ep.close()
            except (KeyError, ValueError, OSError):
                pass

    def _write_loop(self, ep, outbox: queue.Queue):
        """Drain ONE endpoint's outbox; exit when it is detached."""
        while True:
            try:
                msg = outbox.get(timeout=1.0)
            except queue.Empty:
                with self._lock:
                    if self._outboxes.get(ep) is not outbox:
                        return        # detached while idle
                continue
            if msg is _WRITER_EXIT:
                return
            try:
                ep.send(msg)
            except (OSError, ValueError, TimeoutError, AttributeError) as exc:
                # AttributeError: the socket was closed while queued
                reason = ('send_timeout'
                          if isinstance(exc, (socket.timeout, TimeoutError))
                          else 'send_error')
                self.detach(ep, reason=reason)
                return

    def _check_liveness(self):
        now = time.monotonic()
        with self._lock:
            stale = [ep for ep, limit in self._liveness.items()
                     if limit > 0 and now - self._last_recv.get(ep, now) > limit]
        for ep in stale:
            self.detach(ep, reason='heartbeat_miss')

    def _read_loop(self):
        while not self._closed:
            for key, _mask in self._selector.select(timeout=0.5):
                if key.data is None:        # wake pipe
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    continue
                ep = key.data
                try:
                    msgs = ep.drain()
                except (ConnectionResetError, EOFError, OSError):
                    self.detach(ep, reason='read_error')
                    continue
                if msgs:
                    with self._lock:
                        if ep in self._last_recv:
                            self._last_recv[ep] = time.monotonic()
                for msg in msgs:
                    if is_heartbeat(msg):
                        with self._lock:
                            if ep in self._outboxes:
                                self._peer_info[ep] = msg[1]
                            self.stats['heartbeats'] = (
                                self.stats.get('heartbeats', 0) + 1)
                        telemetry.counter('hub_heartbeats_total').inc()
                        continue
                    self._inbox.put((ep, msg))
            self._apply_commands()
            self._check_liveness()
        self._selector.close()
        self._wake_r.close()
        self._wake_w.close()


# ---------------------------------------------------------------------------
# spawned worker processes


_SPAWN_LOCK = threading.Lock()


@contextlib.contextmanager
def _bare_main():
    """Hide the parent's ``__main__`` while children are spawned. A spawned
    child re-imports the parent's main module (``python -m
    handyrl_tpu_torch.train`` imports torch); with a bare ``__main__`` it
    imports only its target's module."""
    with _SPAWN_LOCK:
        main = sys.modules.get('__main__')
        sys.modules['__main__'] = types.ModuleType('__main__')
        try:
            yield
        finally:
            sys.modules['__main__'] = main


@contextlib.contextmanager
def child_environ(env: Optional[Dict[str, str]]):
    """Set ``env`` in ``os.environ`` while children are spawned (they copy
    it at start), and restore it after."""
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spawn_pipe_workers(count: int, target: Callable,
                       make_args: Callable[[int, Any], tuple],
                       daemon: bool = False,
                       env: Optional[Dict[str, str]] = None
                       ) -> List[Tuple[Any, PipeEndpoint]]:
    """Spawn ``count`` processes, each holding one end of a duplex pipe;
    returns ``(process, parent end)`` pairs, the parent end a
    :class:`PipeEndpoint` (a Hub attaches it; ``multiprocessing.connection
    .wait`` takes it). The 'spawn' context, never fork: the parent may hold
    a CUDA context and threads. ``target`` must live in a module that
    imports what the child needs and nothing more; ``env`` is set in the
    children's environment."""
    import multiprocessing as mp
    ctx = mp.get_context('spawn')
    out = []
    with _bare_main(), child_environ(env):
        for i in range(count):
            ours, theirs = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=target, args=make_args(i, theirs),
                               daemon=daemon)
            proc.start()
            theirs.close()
            out.append((proc, PipeEndpoint(ours)))
    return out


class JobPool:
    """Fan jobs out to spawned worker processes, demand-driven.

    ``job_source`` is an iterator of job payloads (it ends the pool by
    ending); ``worker_fn(conn, idx)`` is the child entry point (receive a
    job, send a result, until a ``None`` job or a closed pipe). One
    dispatcher thread keeps every child busy: each result buys its sender
    the next job, then lands (through ``transform``) in ``results``, whose
    bound is the backpressure.

    Unlike the JAX package's pool, which drops a child whose pipe ends and
    leaves its consumer waiting, a child lost before :meth:`close` makes
    :meth:`recv` raise, naming the child (``error``)."""

    def __init__(self, worker_fn: Callable, job_source, num_workers: int,
                 transform: Optional[Callable] = None, results_max: int = 8,
                 name: str = 'worker process'):
        self._jobs = job_source
        self._transform = transform
        self._name = name
        self.results: queue.Queue = queue.Queue(maxsize=results_max)
        self._workers = spawn_pipe_workers(
            num_workers, worker_fn, lambda i, c: (c, i), daemon=True)
        # Connection.send is not thread-safe: the dispatcher and the
        # out-of-band senders (send_to: slot releases from the trainer
        # thread) take the endpoint's lock
        self._send_locks = [threading.Lock() for _ in self._workers]
        self._closing = False
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[str] = None

    @property
    def pids(self) -> List[int]:
        return [proc.pid for proc, _ in self._workers]

    def start(self):
        self._thread = threading.Thread(target=self._dispatch,
                                        name='jobpool-dispatch', daemon=True)
        self._thread.start()

    def recv(self, timeout: Optional[float] = None):
        """The next result (``queue.Empty`` after ``timeout``); raises
        RuntimeError once a child was lost."""
        if self.error is not None:
            raise RuntimeError(self.error)
        try:
            return self.results.get(timeout=timeout)
        except queue.Empty:
            if self.error is not None:
                raise RuntimeError(self.error)
            raise

    def send_to(self, idx: int, msg):
        """An out-of-band message to child ``idx`` (any thread). Best
        effort: a lost child is reported by :meth:`recv`, not here."""
        try:
            with self._send_locks[idx]:
                self._workers[idx][1].send(msg)
        except (OSError, ValueError):
            pass

    def _send_job(self, idx: int) -> bool:
        job = next(self._jobs, None)
        if job is None:
            return False
        with self._send_locks[idx]:
            self._workers[idx][1].send(job)
        return True

    def _lost(self, idx: int):
        proc = self._workers[idx][0]
        proc.join(timeout=1.0)
        self.error = ('%s %d (pid %s) was lost: exit code %s' % (
            self._name, idx, proc.pid, proc.exitcode))
        _LOG.error(self.error)

    def _dispatch(self):
        try:
            self._dispatch_loop()
        except Exception:   # the consumer must hear of it, not wait
            if not self._closing:
                self.error = '%s dispatcher failed: %s' % (
                    self._name, traceback.format_exc(limit=4))
                _LOG.error(self.error)

    def _dispatch_loop(self):
        import multiprocessing.connection as mpc
        for i in range(len(self._workers)):
            if not self._send_job(i):
                return
        live = {conn: i for i, (_, conn) in enumerate(self._workers)}
        while live:
            for conn in mpc.wait(list(live), timeout=0.5):
                i = live[conn]
                try:
                    result = conn.recv()
                except (EOFError, OSError):
                    del live[conn]
                    if not self._closing:
                        self._lost(i)
                        return
                    continue
                if self._closing:
                    continue   # drained so no child blocks in its send
                if not self._send_job(i):   # refill before the maybe-block
                    return
                if self._transform is not None:
                    result = self._transform(result)
                while not self._closing:
                    try:
                        self.results.put(result, timeout=0.5)
                        break
                    except queue.Full:
                        continue

    def close(self, timeout: float = 5.0):
        """Tell every child to exit (a ``None`` job), join them (terminate
        the ones still running after ``timeout``) and the dispatcher."""
        self._closing = True
        for i in range(len(self._workers)):
            self.send_to(i, None)
        for proc, _ in self._workers:
            proc.join(timeout)
            if proc.is_alive():
                _LOG.warning('%s pid %s did not exit; terminating',
                             self._name, proc.pid)
                proc.terminate()
                proc.join(timeout)
        if self._thread is not None:
            self._thread.join(timeout)
        for _, conn in self._workers:
            conn.close()
