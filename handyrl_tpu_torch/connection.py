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
  validates every length before buffering.
* **Hub.** One selector read loop plus one writer thread per endpoint.
"""

from __future__ import annotations

import queue
import select
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from . import telemetry

_HEADER = struct.Struct('!i')
_EXT_NDARRAY = 1

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


class FramedConnection:
    """Duplex message endpoint over a stream socket: blocking
    ``send``/``recv`` for call-response clients, non-blocking ``drain``
    for the Hub."""

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
            self._ready.extend(self._parser.feed(chunk))
        return self._decode(self._ready.popleft())

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
        self._ready.extend(self._parser.feed(chunk))
        out = [self._decode(p) for p in self._ready]
        self._ready.clear()
        return out


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


# ---------------------------------------------------------------------------
# frame kinds

# Inference-service frames: a request ``(INFER_KIND, body)`` is answered
# with ``(INFER_KIND, reply)``, matched by the body's ``rid``.
INFER_KIND = '__infer__'

# Serving-path trace context rides inside the INFER body under this key;
# peers that do not trace ignore it.
TRACE_KEY = 'trace'


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
        return 'socket peer %s:%s' % peer[:2]
    return 'endpoint'


class Hub:
    """Message multiplexer: one selector read loop + one writer per endpoint.

    Incoming messages land in one inbox as ``(endpoint, message)``;
    outgoing messages go to a PER-ENDPOINT outbox drained by that
    endpoint's own writer thread, so a peer that stops reading delays only
    its own replies. A peer is detached on a read or write error, a send
    past ``SEND_TIMEOUT``, an outbox past ``OUTBOX_MAX`` messages, or
    (when its ``liveness`` deadline is set) silence longer than that."""

    SEND_TIMEOUT = 30.0
    OUTBOX_MAX = 512

    def __init__(self, inbox_max: int = 256):
        self._inbox: queue.Queue = queue.Queue(maxsize=inbox_max)
        self._lock = threading.Lock()
        self._outboxes: Dict[Any, queue.Queue] = {}        # guarded-by: _lock
        self._commands: deque = deque()                    # guarded-by: _lock
        self._liveness: Dict[Any, float] = {}              # guarded-by: _lock
        self._last_recv: Dict[Any, float] = {}             # guarded-by: _lock
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

    def attach(self, endpoint, liveness: float = 0.0):
        """Register ``endpoint``; ``liveness`` > 0 detaches it after that
        many seconds without a received frame."""
        sock = getattr(endpoint, 'sock', None)
        if sock is not None:
            sock.settimeout(self.SEND_TIMEOUT)   # bound writer stalls
        outbox: queue.Queue = queue.Queue(maxsize=self.OUTBOX_MAX)
        with self._lock:
            if endpoint in self._outboxes:
                return
            self._outboxes[endpoint] = outbox
            self._liveness[endpoint] = float(liveness or 0.0)
            self._last_recv[endpoint] = time.monotonic()
            self._commands.append(('+', endpoint))
            self.stats['attached'] = self.stats.get('attached', 0) + 1
        threading.Thread(target=self._write_loop, args=(endpoint, outbox),
                         name='hub-write', daemon=True).start()
        self._wake()

    def detach(self, endpoint, reason: str = 'requested'):
        with self._lock:
            outbox = self._outboxes.pop(endpoint, None)
            if outbox is not None:
                self._liveness.pop(endpoint, None)
                self._last_recv.pop(endpoint, None)
                self._commands.append(('-', endpoint))
                key = 'disconnect_' + reason
                self.stats[key] = self.stats.get(key, 0) + 1
        if outbox is None:
            return
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
                    self._inbox.put((ep, msg))
            self._apply_commands()
            self._check_liveness()
        self._selector.close()
        self._wake_r.close()
        self._wake_w.close()
