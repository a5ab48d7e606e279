"""Crash-safe file writes with CRC32 sidecars and append-safe JSONL (the
subset of ``handyrl_tpu/utils/fs.py`` the model registry and the
learner's checkpoints and metrics rows use).

Writes go to a temp file in the SAME directory (os.replace must not cross
filesystems), are fsynced, then atomically renamed over the target, so a
reader sees either the old bytes or the new bytes, never a prefix. The
sidecar format is the JAX package's, so both packages verify each other's
files.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import zlib


def atomic_write_bytes(path: str, data: bytes):
    """Write ``data`` to ``path`` atomically (temp file + fsync + rename)."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + '.tmp.',
                               dir=directory)
    try:
        with os.fdopen(fd, 'wb') as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        # the target is untouched; leave no partial temp file behind
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def sidecar_path(path: str) -> str:
    """The checksum manifest that rides next to a checkpoint file."""
    return path + '.crc'


def checksummed_write_bytes(path: str, data: bytes):
    """Atomic write plus a CRC32 sidecar manifest (``<path>.crc``): a
    one-line JSON dict ``{"algo": "crc32", "crc32": N, "size": N, "time":
    T}``. The data lands BEFORE the manifest, so a crash between the two
    leaves a stale manifest that FAILS verification."""
    atomic_write_bytes(path, data)
    manifest = {'algo': 'crc32', 'crc32': zlib.crc32(data) & 0xffffffff,
                'size': len(data), 'time': time.time()}
    atomic_write_bytes(sidecar_path(path),
                       (json.dumps(manifest) + '\n').encode('utf-8'))


def _verify(path: str):
    """(ok, reason, data-or-None). A missing sidecar reads as ok with
    reason 'unverified' (files written by external tools stay loadable)."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError as exc:
        return False, 'unreadable (%s)' % exc, None
    try:
        with open(sidecar_path(path), 'r') as f:
            manifest = json.load(f)
    except OSError:
        return True, 'unverified', data
    except ValueError:
        return False, 'manifest unparsable', None
    if int(manifest.get('size', -1)) != len(data):
        return False, 'size mismatch (truncated write?)', None
    if int(manifest.get('crc32', -1)) != (zlib.crc32(data) & 0xffffffff):
        return False, 'crc32 mismatch (corrupt bytes)', None
    return True, 'ok', data


def verify_checkpoint(path: str):
    """(ok, reason) for ``path`` against its CRC32 sidecar manifest."""
    ok, reason, _data = _verify(path)
    return ok, reason


def read_verified_bytes(path: str):
    """The file's bytes, or None when it is missing, truncated, or fails
    the sidecar checksum (files without a sidecar pass)."""
    ok, _reason, data = _verify(path)
    return data if ok else None


def append_jsonl(path: str, record: dict, fsync: bool = True):
    """Append ``record`` to a JSONL file append-safely: the whole encoded
    line (payload and newline) goes down in ONE ``os.write`` on an
    ``O_APPEND`` descriptor and is fsynced (unless ``fsync`` is False)
    before the descriptor closes, so a learner killed mid-epoch leaves
    the complete line or no line, never a torn half-line."""
    line = (json.dumps(record) + '\n').encode('utf-8')
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line)
        if fsync:
            os.fsync(fd)
    finally:
        os.close(fd)
