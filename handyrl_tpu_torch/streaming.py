"""Streaming partial-episode ingest: the learner's chunk reassembly (the
port of ``handyrl_tpu/streaming.py``).

With the ``streaming`` block enabled, workers and the device actor flush
fixed-T window chunks of in-flight episodes through the upload path
(``generation.build_chunk``) instead of holding whole episodes. The
:class:`ChunkAssembler` merges the chunks back into episode records.

* Host streams are pure: an episode is a function of (seed, sample_key,
  params), and so are its chunk boundaries. A re-issued attempt of a
  stranded task regenerates the same chunks under the same sample_key, so
  host assemblies key by sample_key and duplicate chunks merge. Device
  actor streams carry ``record_version``: their episodes follow the
  block's draws, not the key, so they key by task_id and never merge
  across attempts.
* Chunk moments ship with ``'return': None`` and the final chunk carries
  the outcome; reassembly concatenates the decoded windows and hands them
  to ``generation.finalize_episode_record``, the return fill and the
  compression every whole-episode producer uses, so the record's decoded
  moments, returns and outcome are a whole-episode upload's.

While an episode is in flight the assembler exposes a partial buffer
entry (``'partial': True``, a provisional zero outcome, returns None) made
of the contiguous chunk prefix: ``chunk_steps`` is a multiple of
``compress_steps``, so the chunk blocks land on the whole-episode block
grid and ``ops/batch.py`` windows into them unchanged. The entry grows in
an order safe for the batcher threads that read it: blocks first, then the
step count.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from . import telemetry
from .generation import finalize_episode_record
from .ops.batch import decompress_moments


def streaming_enabled(args: Dict[str, Any]) -> bool:
    return bool((args.get('streaming') or {}).get('enabled'))


def chunk_key(chunk: Dict[str, Any]):
    """The assembly (and duplicate screen) key of a chunk: ``('k',
    sample_key)`` for a host stream, ``('t', task_id)`` for a
    ``record_version``-stamped device stream; None for a chunk with
    neither."""
    args = chunk.get('args') or {}
    skey = args.get('sample_key')
    if not chunk.get('record_version') and skey is not None:
        return ('k', int(skey))
    tid = args.get('task_id')
    if tid is not None:
        return ('t', int(tid))
    return None


class ChunkAssembler:
    """Merge streamed chunks back into episode records.

    :meth:`add` runs on the learner's server thread (and in spool
    recovery, before the fleet attaches); the entries it exposes are read
    by the batcher threads at the same time. The counters
    ``streaming_reassembled_episodes_total``,
    ``streaming_open_assemblies`` and
    ``streaming_abandoned_assemblies_total`` are the telemetry registry's
    (:meth:`counts` reads them for the learner's JSON line)."""

    def __init__(self, args: Dict[str, Any], check_finite: bool = True,
                 clock=time.time):
        self.args = args
        self._check_finite = bool(check_finite)
        self._clock = clock
        self._open: Dict[Any, dict] = {}
        self.reassembled = 0
        self.abandoned = 0
        self._m_open = telemetry.gauge('streaming_open_assemblies')
        self._m_done = telemetry.counter(
            'streaming_reassembled_episodes_total')
        self._m_abandoned = telemetry.counter(
            'streaming_abandoned_assemblies_total')

    def _chunk_steps(self) -> int:
        return int((self.args.get('streaming') or {}).get('chunk_steps', 32))

    # -- ingest -----------------------------------------------------------

    def add(self, chunk: Dict[str, Any], mark: Optional[int] = None) -> dict:
        """Fold one chunk (screened by the ledger already) into its
        assembly. ``mark`` is the spool index it was written under (the
        GC horizon must not pass an open assembly's first mark). Returns
        ``{'status': ...}``:

        * ``'dropped'``: unkeyed or duplicate, nothing to do;
        * ``'open'``: data landed; ``entry`` is the live buffer entry and
          ``new`` says whether the caller must insert it;
        * ``'complete'``: the episode is whole; ``record`` is the
          canonical record (already swapped into ``entry``), or None when
          a poisoned chunk froze the assembly (the task completes all the
          same); ``final_args`` the closing attempt's task args.
        """
        key = chunk_key(chunk)
        if key is None:
            return {'status': 'dropped'}
        asm = self._open.get(key)
        if asm is None:
            asm = self._open[key] = {
                'chunks': {}, 'final_ci': None, 'outcome': None,
                'final_args': None, 'next': 0, 'entry': None,
                'mark': mark, 'poisoned': False, 'touched': self._clock(),
                'stamped': bool(chunk.get('record_version')),
            }
            self._m_open.set(len(self._open))
        asm['touched'] = self._clock()
        if mark is not None and (asm['mark'] is None or mark < asm['mark']):
            asm['mark'] = mark
        ci = int(chunk.get('chunk', 0))
        if ci in asm['chunks']:
            return {'status': 'dropped'}     # a duplicate window, merged
        if self._check_finite:
            from .guard import episode_is_finite
            if not episode_is_finite({'outcome': chunk.get('outcome'),
                                      'moment': chunk.get('moment') or []}):
                # freeze: the clean prefix stays usable, nothing more is
                # exposed and the record drops whole
                asm['poisoned'] = True
        try:
            moments = ([] if asm['poisoned']
                       else decompress_moments(chunk.get('moment') or []))
        except Exception:
            asm['poisoned'] = True
            moments = []
        asm['chunks'][ci] = {'moments': moments,
                             'blocks': list(chunk.get('moment') or [])}
        if chunk.get('final'):
            asm['final_ci'] = ci
            asm['outcome'] = chunk.get('outcome')
            asm['final_args'] = dict(chunk.get('args') or {})
        new = self._expose(asm, chunk)
        fin = asm['final_ci']
        if fin is not None:
            if asm['poisoned']:
                # a poisoned stream still closes its task once every window
                # landed, or the deadline would re-issue the same poison
                if all(c in asm['chunks'] for c in range(fin + 1)):
                    return self._complete(key, asm, new)
            elif asm['next'] > fin:
                return self._complete(key, asm, new)
        return {'status': 'open', 'entry': asm['entry'], 'new': new}

    def _expose(self, asm: dict, chunk: Dict[str, Any]) -> bool:
        """Extend the live buffer entry with the contiguous chunk prefix:
        blocks are appended before the step count moves, so a concurrent
        window selection never indexes past decoded data."""
        new = False
        now = time.time()
        while not asm['poisoned'] and asm['next'] in asm['chunks']:
            ci = asm['next']
            moments = asm['chunks'][ci]['moments']
            blocks = asm['chunks'][ci]['blocks']
            entry = asm['entry']
            if entry is None and moments:
                players = list(moments[0]['return'].keys())
                entry = asm['entry'] = {
                    'args': dict(chunk.get('args') or {}),
                    'outcome': {p: 0.0 for p in players},   # provisional
                    'moment': [], 'steps': 0, 'partial': True,
                    'recv_time': now, 'chunk_recv': [],
                    'chunk_steps': self._chunk_steps(),
                }
                if asm['stamped']:
                    entry['record_version'] = 1
                new = True
            if entry is not None:
                entry['moment'].extend(blocks)
                entry['chunk_recv'].append(now)
                entry['steps'] += len(moments)
            asm['next'] = ci + 1
        return new

    def _complete(self, key, asm: dict, new: bool) -> dict:
        """Every window landed: build the canonical record and swap it
        into the live entry."""
        self._open.pop(key, None)
        self._m_open.set(len(self._open))
        record = None
        entry = asm['entry']
        if not asm['poisoned']:
            moments: List[dict] = []
            for ci in range(asm['final_ci'] + 1):
                moments.extend(asm['chunks'][ci]['moments'])
            record = finalize_episode_record(
                asm['outcome'], moments, self.args, asm['final_args'])
        if record is not None:
            if asm['stamped']:
                record['record_version'] = 1
            self.reassembled += 1
            self._m_done.inc()
            if entry is None:
                # completed in one go (shorter than T, or a recovery
                # replay): expose the finished record itself
                entry = asm['entry'] = dict(record)
                entry['chunk_recv'] = [time.time()]
                entry['chunk_steps'] = self._chunk_steps()
                new = True
            else:
                entry['args'] = record['args']
                entry['moment'] = record['moment']
                entry['outcome'] = record['outcome']
                entry['steps'] = record['steps']
                entry.pop('partial', None)
        return {'status': 'complete', 'record': record, 'entry': entry,
                'final_args': asm['final_args'], 'new': new}

    # -- bookkeeping ------------------------------------------------------

    def min_open_mark(self) -> Optional[int]:
        """The lowest spool index an open assembly's chunks were written
        under: the epoch's GC horizon is held back to it, so a restart can
        still replay every chunk of a partly delivered episode."""
        marks = [asm['mark'] for asm in self._open.values()
                 if asm['mark'] is not None]
        return min(marks) if marks else None

    def open_count(self) -> int:
        return len(self._open)

    def counts(self) -> Dict[str, int]:
        """The learner's JSON line: episodes reassembled, assemblies open
        and abandoned."""
        return {'reassembled_episodes': self.reassembled,
                'open_assemblies': len(self._open),
                'abandoned_assemblies': self.abandoned}

    def reap(self, older_than: float) -> list:
        """Abandon the assemblies untouched for ``older_than`` seconds;
        returns their keys (the caller drops their ledger screen). A dead
        device stream can never complete (its re-issue keys a new
        task_id), and no assembly may pin the spool's GC horizon for ever.
        The exposed partial entry (clean data) stays in the buffer."""
        now = self._clock()
        stale = [key for key, asm in self._open.items()
                 if now - asm['touched'] > older_than]
        for key in stale:
            self._open.pop(key, None)
            self.abandoned += 1
            self._m_abandoned.inc()
        if stale:
            self._m_open.set(len(self._open))
        return stale
