"""Crash-safe file writes with CRC32 sidecars, append-safe JSONL and
CRC-framed records (the subset of ``handyrl_tpu/utils/fs.py`` the model
registry, the learner's checkpoints and metrics rows, the episode spool
and the ledger journal use).

Writes go to a temp file in the SAME directory (os.replace must not cross
filesystems), are fsynced, then atomically renamed over the target, so a
reader sees either the old bytes or the new bytes, never a prefix. The
sidecar format is the JAX package's, so both packages verify each other's
files.
"""

from __future__ import annotations

import json
import os
import struct
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


def rotate_file(path: str, max_mb: float) -> bool:
    """Size-gated single-generation rotation: when ``path`` exceeds
    ``max_mb`` megabytes it is renamed to ``<path>.1`` (replacing an older
    generation) and True is returned; the next append recreates the live
    file. ``os.replace`` on one filesystem is atomic, so a reader sees the
    old file or the rotated one, never a truncation in progress. A
    missing file or a non-positive cap is a no-op."""
    if not path or max_mb <= 0:
        return False
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size < max_mb * 1024 * 1024:
        return False
    os.replace(path, path + '.1')
    return True


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


# ---------------------------------------------------------------------------
# CRC-framed binary records (the episode spool's and the ledger journal's
# vocabulary, byte for byte the JAX package's)
#
# One record = MAGIC(4) + length(4, big-endian) + crc32(4, big-endian) +
# payload. An append goes down in ONE os.write on an O_APPEND descriptor,
# so a SIGKILL leaves at worst one torn record at the tail, which
# read_framed_records detects (bad magic, short header, short payload or
# crc mismatch) so that recovery can truncate it.

RECORD_MAGIC = b'HRLW'
_RECORD_HEADER = struct.Struct('>II')   # payload length, crc32


def frame_record(payload: bytes) -> bytes:
    """One self-verifying framed record for ``payload``."""
    return (RECORD_MAGIC
            + _RECORD_HEADER.pack(len(payload),
                                  zlib.crc32(payload) & 0xffffffff)
            + payload)


def open_append(path: str) -> int:
    """An O_APPEND descriptor for a record file (created if missing)."""
    return os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)


def append_framed_record(fd: int, payload: bytes) -> int:
    """Append one framed record in a single write; returns bytes written."""
    frame = frame_record(payload)
    os.write(fd, frame)
    return len(frame)


def read_framed_records(path: str):
    """Decode a framed-record file tolerantly: ``(records, valid_bytes,
    torn)``, the verified payloads, the offset just past the last good
    record, and whether bytes past it failed the framing or the CRC (a
    SIGKILL mid-append; the caller truncates the file to ``valid_bytes``).
    A missing file reads as no records."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError:
        return [], 0, False
    records, offset = [], 0
    frame_len = len(RECORD_MAGIC) + _RECORD_HEADER.size
    while offset + frame_len <= len(data):
        if data[offset:offset + len(RECORD_MAGIC)] != RECORD_MAGIC:
            break
        size, crc = _RECORD_HEADER.unpack_from(data,
                                               offset + len(RECORD_MAGIC))
        start = offset + frame_len
        payload = data[start:start + size]
        if len(payload) < size or (zlib.crc32(payload) & 0xffffffff) != crc:
            break
        records.append(payload)
        offset = start + size
    return records, offset, offset < len(data)
