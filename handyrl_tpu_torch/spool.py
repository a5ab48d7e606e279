"""EpisodeSpool: the training plane's episode write-ahead log (the port of
``handyrl_tpu/spool.py``; its files are the JAX package's, byte for byte).

Every episode a remote learner admits (it passed the TaskLedger's duplicate
screen and is about to be counted and fed to training) is first appended to
a segmented spool under ``model_dir/spool/``: one CRC-framed record
(``utils/fs.py``) an episode, written with a single ``O_APPEND`` write, so a
SIGKILL can tear at most the last record. A restarted learner replays every
spooled record at or past the newest checkpoint's consumption horizon back
into its buffer before it serves the fleet, so a learner's death costs no
admitted episode.

* Segments are ``%08d.wal`` files that rotate once they pass
  ``segment_mb``; rotation fsyncs and closes the old segment, so only the
  live segment can hold a torn tail.
* A record's payload is ``connection.pack({'idx': N, 'episode': ...})``
  (or ``{'idx': N, 'chunk': ...}`` for a streamed window), ``idx`` the
  learner's admission index, which makes recovery horizons and GC exact
  without an index file.
* :meth:`EpisodeSpool.recover` scans the segments in order, truncates a
  torn tail in place and returns the records with ``idx >= min_idx``.
* :meth:`EpisodeSpool.gc` deletes closed segments whose newest record fell
  behind the horizon, keeping the newest ``keep_segments`` closed ones.

Appends are not fsynced one by one: a process SIGKILL cannot lose bytes the
kernel accepted; rotation and ``close`` fsync, so a machine crash can cost
the live segment only.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import telemetry
from .utils.fs import append_framed_record, open_append, read_framed_records

SEGMENT_SUFFIX = '.wal'


def spool_dir(model_dir: str) -> str:
    return os.path.join(model_dir, 'spool')


class EpisodeSpool:
    """Segmented append-only episode WAL under ``model_dir/spool/``.

    Single-threaded: the learner's server loop is the only writer (append
    and GC run inline with admission and the epoch sync), and recovery
    runs before the fleet is served."""

    def __init__(self, model_dir: str, segment_mb: float = 64.0,
                 keep_segments: int = 2):
        self.root = spool_dir(model_dir)
        self.segment_bytes = max(1, int(float(segment_mb) * 1024 * 1024))
        self.keep_segments = max(0, int(keep_segments))
        self._fd: Optional[int] = None
        self._live: Optional[str] = None      # live segment path
        self._live_bytes = 0
        self._seq = 0                         # next segment number
        self._max_idx: Dict[str, int] = {}    # closed segment -> newest idx
        self._live_max_idx = -1
        self._m_bytes = telemetry.counter('spool_bytes_total')
        self._m_segments = telemetry.gauge('spool_segments')
        self._m_recovered = telemetry.counter('spool_recovered_episodes_total')
        self._m_gc = telemetry.counter('spool_gc_segments_total')

    # -- write path --------------------------------------------------------

    def _segments(self) -> List[str]:
        try:
            names = sorted(n for n in os.listdir(self.root)
                           if n.endswith(SEGMENT_SUFFIX))
        except OSError:
            return []
        return [os.path.join(self.root, n) for n in names]

    def _open_segment(self):
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, '%08d%s' % (self._seq, SEGMENT_SUFFIX))
        self._seq += 1
        self._fd = open_append(path)
        self._live = path
        self._live_bytes = 0
        self._live_max_idx = -1
        self._m_segments.set(len(self._segments()))

    def _close_segment(self):
        if self._fd is None:
            return
        try:
            os.fsync(self._fd)
        except OSError:
            pass
        os.close(self._fd)
        if self._live is not None and self._live_max_idx >= 0:
            self._max_idx[self._live] = self._live_max_idx
        self._fd = None
        self._live = None

    def append(self, idx: int, payload: bytes) -> int:
        """Spool one admitted record (already ``connection.pack``-ed, with
        ``idx`` in it); returns the bytes written."""
        if self._fd is None:
            self._open_segment()
        n = append_framed_record(self._fd, payload)
        self._live_bytes += n
        self._live_max_idx = max(self._live_max_idx, int(idx))
        self._m_bytes.inc(n)
        if self._live_bytes >= self.segment_bytes:
            self._close_segment()
        return n

    # -- recovery ----------------------------------------------------------

    def recover(self, min_idx: int, unpack) -> List[dict]:
        """The spooled records with ``idx >= min_idx`` in admission order,
        truncating a torn tail in place. ``unpack`` decodes a payload
        (``connection.unpack``); an undecodable record is skipped (the CRC
        already screened corruption, so that means a format change)."""
        out = []
        for path in self._segments():
            records, valid_bytes, torn = read_framed_records(path)
            if torn:
                os.truncate(path, valid_bytes)
            seg_max = -1
            for payload in records:
                try:
                    rec = unpack(payload)
                    idx = int(rec['idx'])
                except Exception:
                    continue
                seg_max = max(seg_max, idx)
                if idx >= int(min_idx):
                    out.append(rec)
            if seg_max >= 0:
                self._max_idx[path] = seg_max
        out.sort(key=lambda rec: rec['idx'])
        if out:
            self._m_recovered.inc(len(out))
        # appends resume in a fresh segment past every existing one, so a
        # double restart never interleaves generations within a segment
        existing = self._segments()
        if existing:
            tail = os.path.basename(existing[-1])[:-len(SEGMENT_SUFFIX)]
            try:
                self._seq = int(tail) + 1
            except ValueError:
                self._seq = len(existing)
        self._m_segments.set(len(existing))
        return out

    # -- GC ----------------------------------------------------------------

    def gc(self, horizon: int) -> int:
        """Delete the closed segments whose records all fell behind
        ``horizon`` (every idx < horizon), keeping the newest
        ``keep_segments`` closed segments regardless; returns the number
        removed."""
        closed = [p for p in self._segments() if p != self._live]
        victims = [p for p in closed
                   if self._max_idx.get(p, horizon) < int(horizon)]
        if self.keep_segments:
            victims = victims[:-self.keep_segments] or []
        removed = 0
        for path in victims:
            try:
                os.unlink(path)
            except OSError:
                continue
            self._max_idx.pop(path, None)
            removed += 1
        if removed:
            self._m_gc.inc(removed)
        self._m_segments.set(len(self._segments()))
        return removed

    def close(self):
        self._close_segment()
