"""Param trees in flax's msgpack layout, written and read without msgpack.

The JAX package's snapshots carry their params as
``flax.serialization.to_bytes`` of the param tree: msgpack maps of str keys
in the tree's order, each ndarray as ext type 1 whose payload is the
msgpack array ``[shape, dtype.name, raw C-order bytes]``, and each numpy
scalar as ext type 3 with the same payload. :func:`to_bytes` writes those
bytes with the port's own msgpack writer (``connection._pack``), so both
packages read the port's snapshots, and :func:`from_bytes` reads them with
its reader. It also reads ext 1 in the wire codec's layout (msgpack
``[dtype.str, shape]`` followed by the raw bytes), which the port's
snapshots used before they took flax's: the payload's first msgpack object
tells the two apart (a 3-array spanning the payload against a 2-array of
str and shape). The wire codec itself (``connection.pack``) is untouched.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..connection import ExtType, _pack, _Reader, _read

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# flax splits arrays over 2**30 bytes into maps under this key; no param
# tree of the port comes near that, so such a snapshot is refused by name
_CHUNKED = '__msgpack_chunked_array__'


def _ndarray_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise TypeError('snapshot: %s arrays have no flax layout' % a.dtype)
    out = bytearray()
    _pack([list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()],
          out)
    return bytes(out)


def _flax_leaves(tree):
    """``tree`` with each ndarray and numpy scalar as flax's ext value."""
    if isinstance(tree, dict):
        return {str(k): _flax_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return ExtType(_EXT_NDARRAY, _ndarray_payload(tree))
    if isinstance(tree, np.generic):
        return ExtType(_EXT_NPSCALAR, _ndarray_payload(np.asarray(tree)))
    if tree is None or type(tree) in (bool, int, float, str, bytes):
        return tree
    raise TypeError('snapshot: cannot write %r in flax\'s layout'
                    % type(tree))


def to_bytes(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` gives for ``tree``, a
    nested dict of numpy arrays (and numpy or Python scalars)."""
    out = bytearray()
    _pack(_flax_leaves(tree), out)
    return bytes(out)


def _ndarray(data: bytes) -> np.ndarray:
    """An ext 1 payload in either layout, as an array that owns its memory."""
    r = _Reader(data)
    head = _read(r, 0, ExtType)
    if (isinstance(head, list) and len(head) == 3
            and r.pos == len(data)):                    # flax's
        shape, name, raw = head
        return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
    if isinstance(head, list) and len(head) == 2 and isinstance(head[0], str):
        dtype_str, shape = head                         # the wire codec's
        return np.frombuffer(data[r.pos:], dtype=np.dtype(dtype_str)) \
            .reshape(shape).copy()
    raise ValueError('snapshot: an ndarray payload in neither flax\'s nor '
                     'the wire codec\'s layout')


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError('snapshot: ext type %d is not a param' % code)


def _refuse_chunked(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError('snapshot: flax chunked an array over 2**30 '
                             'bytes (%s); the port reads no chunked arrays'
                             % _CHUNKED)
        for v in tree.values():
            _refuse_chunked(v)


def from_bytes(raw: bytes) -> Any:
    """The tree of :func:`to_bytes` (or of flax's ``to_bytes``, or of the
    port's older snapshots) as nested dicts of numpy arrays."""
    r = _Reader(raw)
    tree = _read(r, 0, _decode_ext)
    if r.pos != len(r.data):
        raise ValueError('snapshot: %d trailing bytes after the params'
                         % (len(r.data) - r.pos))
    _refuse_chunked(tree)
    return tree
