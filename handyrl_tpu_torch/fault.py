"""Fault-tolerance primitives of the learner-worker plane (the subset of
``handyrl_tpu/fault.py`` the port runs):

* :class:`Backoff`: exponential reconnect delays with jitter.
* :class:`TaskLedger`: the learner's book of outstanding tasks. Tasks
  stranded by a detached endpoint or a missed deadline are re-issued ahead
  of fresh work, and late duplicate uploads are dropped once, so episode
  accounting converges while actors come and go. It also screens streamed
  chunks per (assembly, chunk index).
* :class:`LedgerJournal`: the book on disk (``ledger.snap`` and
  ``ledger.delta.wal``), the JAX package's files byte for byte, so a
  restarted learner of either package restores it.
* :class:`FleetController`: the per-host health states (healthy,
  degraded, draining, quarantined) that decide whether a host gets fresh
  tasks, or whether a serving replica is routable.
* :class:`SessionLedger`: the match gateway's session-affinity book
  (which replica a session's plies go to) and its strandings.
* :func:`parse_chaos`: the ``HANDYRL_TPU_CHAOS`` drills
  (``kill_gather=<mean s>`` and ``kill_worker=<mean s>`` with
  ``max_kills``/``seed`` on the worker plane; ``preempt``, ``nanstep`` and
  friends in the learner).

The book and the fleet controller are pure Python on an injectable clock.
"""

from __future__ import annotations

import copy
import os
import random
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional

from . import telemetry
from .utils.fs import (append_framed_record, atomic_write_bytes,
                       open_append, read_framed_records)

# the endpoint of tasks restored from a persisted book: their endpoints
# died with the previous learner process
RESTORED_ENDPOINT = '<restored>'


class Backoff:
    """Exponential backoff with jitter: delays double from ``initial`` up to
    ``maximum``; each delay is uniformly jittered into
    ``[(1 - jitter) * d, d]`` so synchronized failures desynchronize."""

    def __init__(self, initial: float = 1.0, maximum: float = 30.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.initial = float(initial)
        self.maximum = float(maximum)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self._rng = rng or random
        self._cur = self.initial

    def next_delay(self) -> float:
        base = min(self._cur, self.maximum)
        self._cur = min(self._cur * self.factor, self.maximum)
        return base * (1.0 - self.jitter * self._rng.random())

    def reset(self):
        self._cur = self.initial


class TaskLedger:
    """Outstanding-task book for the learner's 4-RPC server.

    ``assign`` stamps a fresh ``task_id`` into the task payload and books it
    against the endpoint it was sent to, with a deadline. ``admit`` filters
    an upload batch: items completing a booked task pass (and close the
    book), items with an unknown ``task_id`` are duplicates (a resent RPC
    whose first copy already landed) and are dropped, items with no
    ``task_id`` pass untouched (peers that predate the ledger).
    ``fail_endpoint`` / ``reap`` move stranded tasks to the re-issue queue,
    which ``next_reissue`` serves ahead of fresh assignments: a re-issue
    must not count again in the server's num_episodes/num_results, which
    is why it bypasses the fresh-task path.

    With a :class:`LedgerJournal` attached (``self.journal``) the book is
    durable: assignments, strandings and cancels journal at once,
    completions and chunk deliveries are batched until
    :meth:`flush_journal`, which the server calls after the episode
    spool's append, so "admitted but completion unjournaled" is the only
    crash window, and spool recovery closes it by cancelling the spooled
    task ids. :meth:`restore_state` repopulates the book from a journal
    replay: restored tasks re-issue with their original payloads
    (``sample_key`` included) ahead of fresh work, unless a reattached
    gather's resent upload completes them first."""

    def __init__(self, deadline: float = 300.0, clock=time.time):
        self.deadline = float(deadline)
        self._clock = clock
        self._tasks: Dict[int, tuple] = {}          # tid -> (endpoint, base, expires)
        self._by_endpoint: Dict[Any, set] = defaultdict(set)
        self._reissue: deque = deque()
        self._restored_reissue: deque = deque()     # (tid, base) restored
        self._strandings: deque = deque(maxlen=4096)  # (endpoint, reason, t)
        self._next_tid = 0
        self.journal: Optional['LedgerJournal'] = None
        self._pending_complete: list = []   # ('c', tid), ('p', ...), ('q', key)
        # streamed ingest (streaming.py): the chunk indices delivered per
        # assembly key (sample_key for host streams, task_id for device
        # ones); closed keys move to a bounded ring, so resends of a
        # finished episode's chunks still screen as duplicates
        self._chunks: Dict[Any, set] = {}
        self._closed_chunk_keys: deque = deque(maxlen=4096)
        self._closed_chunk_set: set = set()
        self.stats: Dict[str, int] = {
            'assigned': 0, 'completed': 0, 'duplicates': 0,
            'reissued': 0, 'expired': 0, 'endpoint_failures': 0,
        }

    # -- assignment / completion --

    def assign(self, endpoint, role_args: Dict[str, Any]) -> int:
        """Book ``role_args`` against ``endpoint`` and stamp its task_id.
        The booked copy is the full payload (deep-copied, minus the
        task_id), so a re-issue replays it verbatim, server-stamped
        ``sample_key`` included."""
        tid, self._next_tid = self._next_tid, self._next_tid + 1
        base = copy.deepcopy(
            {k: v for k, v in role_args.items() if k != 'task_id'})
        role_args['task_id'] = tid
        self._tasks[tid] = (endpoint, base, self._clock() + self.deadline)
        self._by_endpoint[endpoint].add(tid)
        self.stats['assigned'] += 1
        if self.journal is not None:
            self.journal.record('a', tid, base)
        if telemetry.trace_enabled():
            # the trace context is born here: the server-stamped
            # sample_key becomes the trace id every later hop derives
            ttid = telemetry.episode_trace_id(role_args)
            if ttid:
                telemetry.trace_event('task_assign', trace_id=ttid,
                                      task_id=tid)
        return tid

    def _unbook(self, tid):
        entry = self._tasks.pop(tid, None)
        if entry is not None:
            owners = self._by_endpoint.get(entry[0])
            if owners is not None:
                owners.discard(tid)
                if not owners:
                    self._by_endpoint.pop(entry[0], None)
        return entry

    def complete(self, tid) -> bool:
        """Close the book on ``tid``. False (and counted) for duplicates."""
        if self._unbook(tid) is None:
            self.stats['duplicates'] += 1
            return False
        self.stats['completed'] += 1
        if self.journal is not None:
            # journaled at flush_journal, after the spool's append
            self._pending_complete.append(('c', tid))
        return True

    def admit(self, items):
        """Filter an upload batch through the book (see the class
        docstring). A None item (a failed episode) passes: its task's
        deadline re-issues it. Each admitted booked item closes its trace
        chain's delivery hop: an ``ingest`` event on the shared trace
        id."""
        out = []
        tracing = telemetry.trace_enabled()
        for item in items:
            if item is None:
                out.append(item)
                continue
            args = item.get('args') or {}
            tid = args.get('task_id')
            if tid is None or self.complete(tid):
                out.append(item)
                if tracing and tid is not None:
                    ttid = telemetry.episode_trace_id(args)
                    if ttid:
                        telemetry.trace_event('ingest', trace_id=ttid,
                                              task_id=tid)
        return out

    def admit_chunks(self, items):
        """Screen a streamed chunk batch for duplicates (streaming.py).
        A chunk does not close its task (the task completes when the
        assembler reports the episode whole, :meth:`complete_chunked`).
        The screen is per (assembly key, chunk index): re-issued attempts
        of a host task share the sample_key, so their regenerated chunks
        merge here instead of counting twice, and chunks of an assembly
        already closed drop like any duplicate upload. Accepted deliveries
        journal as ``p`` ops at the next flush."""
        from .streaming import chunk_key
        out = []
        tracing = telemetry.trace_enabled()
        for chunk in items:
            if chunk is None:
                continue
            key = chunk_key(chunk)
            ci = int(chunk.get('chunk', 0))
            if key is None or key in self._closed_chunk_set \
                    or ci in self._chunks.get(key, ()):
                self.stats['duplicates'] += 1
                telemetry.counter('chunk_duplicates_total').inc()
                continue
            self._chunks.setdefault(key, set()).add(ci)
            if self.journal is not None:
                # after the spool's append, or a kill between them would
                # journal a delivery whose bytes no replay can produce
                self._pending_complete.append(
                    ('p', (int((chunk.get('args') or {})
                               .get('task_id') or -1), list(key), ci)))
            telemetry.counter('chunks_ingested_total').inc()
            out.append(chunk)
            if tracing:
                args = chunk.get('args') or {}
                ttid = telemetry.episode_trace_id(args)
                if ttid:
                    telemetry.trace_event('ingest', trace_id=ttid,
                                          task_id=args.get('task_id'),
                                          chunk=ci)
        return out

    def seed_chunk(self, key, ci: int):
        """Re-seed the screen during spool recovery (the replayed chunks
        were journaled already; no new op)."""
        self._chunks.setdefault(key, set()).add(int(ci))

    def complete_chunked(self, key, tid) -> bool:
        """Close the book on a reassembled streamed episode: its task
        completes (the final chunk's tid, or, when that attempt's entry
        closed already, whichever open 'g' task carries the assembly's
        sample_key), and the key moves to the closed ring."""
        done = tid is not None and self.complete(tid)
        if not done and isinstance(key, (list, tuple)) \
                and len(key) == 2 and key[0] == 'k':
            for other_tid, (_ep, base, _exp) in list(self._tasks.items()):
                if isinstance(base, dict) \
                        and base.get('sample_key') == key[1] \
                        and base.get('role') == 'g':
                    done = self.complete(other_tid)
                    break
        self._pending_complete.append(('q', self._close_chunk_key(key)))
        return done

    def _close_chunk_key(self, key):
        """Drop ``key``'s chunk book and move it into the bounded closed
        ring (stragglers and resends of a finished assembly screen as
        duplicates)."""
        k = tuple(key) if isinstance(key, list) else key
        self._chunks.pop(k, None)
        if k not in self._closed_chunk_set:
            if len(self._closed_chunk_keys) == self._closed_chunk_keys.maxlen:
                self._closed_chunk_set.discard(self._closed_chunk_keys[0])
            self._closed_chunk_keys.append(k)
            self._closed_chunk_set.add(k)
        return k

    def seed_closed_chunks(self, keys):
        """Mark the assemblies spool recovery completed as closed (no op:
        the recovery re-derives them at every restart), so a reattached
        gather's resends screen as duplicates."""
        for key in keys:
            self._close_chunk_key(key)

    def abandon_chunks(self, key):
        """Drop an abandoned assembly's screen (the assembler's reap)."""
        k = tuple(key) if isinstance(key, list) else key
        if self._chunks.pop(k, None) is not None:
            self._pending_complete.append(('q', k))

    # -- loss handling --

    def _strand(self, tid, reason: str = 'detach'):
        endpoint, base, _expires = self._unbook(tid)
        self._reissue.append(base)
        self._strandings.append((endpoint, reason, self._clock()))
        self.stats['reissued'] += 1
        if self.journal is not None:
            self.journal.record('s', tid)
        telemetry.record_event('stranding', str(endpoint), reason=reason)

    def fail_endpoint(self, endpoint) -> int:
        """Re-queue every task booked against a detached endpoint."""
        tids = list(self._by_endpoint.get(endpoint, ()))
        for tid in tids:
            self._strand(tid)
        if tids:
            self.stats['endpoint_failures'] += 1
        return len(tids)

    def reap(self, now: Optional[float] = None) -> int:
        """Re-queue every task past its deadline (slow or silently lost
        work)."""
        now = self._clock() if now is None else now
        expired = [tid for tid, (_ep, _base, exp) in self._tasks.items()
                   if exp <= now]
        for tid in expired:
            self._strand(tid, reason='deadline')
        self.stats['expired'] += len(expired)
        return len(expired)

    def next_reissue(self) -> Optional[Dict[str, Any]]:
        # a previous learner's restored book goes first; cancel() is the
        # guard: None means the task closed meanwhile (a resent upload,
        # spool recovery), so a restored entry is never issued twice
        while self._restored_reissue:
            tid, base = self._restored_reissue.popleft()
            if self.cancel(tid) is not None:
                self.stats['reissued'] += 1
                telemetry.record_event('stranding', RESTORED_ENDPOINT,
                                       reason='restart')
                return copy.deepcopy(base)
        return self._reissue.popleft() if self._reissue else None

    def cancel(self, tid) -> Optional[Dict[str, Any]]:
        """Close ``tid`` silently (no duplicate count, no re-issue);
        returns its booked payload, or None when the book holds no such
        task."""
        entry = self._unbook(tid)
        if entry is None:
            return None
        if self.journal is not None:
            self.journal.record('x', tid)
        return entry[1]

    # -- persistence --

    def flush_journal(self):
        """Journal the batched completions and chunk deliveries (called by
        the server after the spool append that makes them safe)."""
        if self.journal is None or not self._pending_complete:
            self._pending_complete = []
            return
        for op, val in self._pending_complete:
            if op == 'q':
                self.journal.record('q', -1, key=list(val))
            elif op == 'p':
                tid, key, ci = val
                self.journal.record('p', tid, key=key, ci=ci)
            else:
                self.journal.record('c', val)
        self._pending_complete = []

    def snapshot_state(self) -> Dict[str, Any]:
        """The durable book: outstanding tasks, the re-issue queue, the
        task id high-water mark and the chunk screen (``[key, [chunk
        indices]]`` pairs: msgpack maps cannot key on tuples)."""
        state = {
            'tasks': {tid: entry[1] for tid, entry in self._tasks.items()},
            'reissue': [copy.deepcopy(b) for b in self._reissue],
            'next_tid': self._next_tid,
        }
        if self._chunks:
            state['chunks'] = [[list(k), sorted(cis)]
                               for k, cis in self._chunks.items()]
        return state

    def restore_state(self, state: Dict[str, Any]):
        """Repopulate the book from :meth:`LedgerJournal.load`: restored
        tasks are booked under :data:`RESTORED_ENDPOINT` with a fresh
        deadline and queued for priority re-issue; the re-issue queue is
        carried over as it was."""
        now = self._clock()
        for tid, base in sorted((state.get('tasks') or {}).items()):
            tid = int(tid)
            self._tasks[tid] = (RESTORED_ENDPOINT, base, now + self.deadline)
            self._by_endpoint[RESTORED_ENDPOINT].add(tid)
            self._restored_reissue.append((tid, base))
        self._reissue.extend(state.get('reissue') or ())
        self._next_tid = max(self._next_tid, int(state.get('next_tid') or 0))
        for pair in state.get('chunks') or ():
            try:
                key, cis = pair
            except Exception:
                continue
            k = (str(key[0]), int(key[1]))
            self._chunks.setdefault(k, set()).update(int(c) for c in cis)

    # -- observability --

    def outstanding(self) -> int:
        return len(self._tasks)

    def outstanding_by_endpoint(self) -> Dict[Any, int]:
        """Open task count per endpoint (the fleet controller's drain
        policy waits on this before quarantining a flapping host)."""
        return {ep: len(tids) for ep, tids in self._by_endpoint.items()
                if tids}

    def pending_reissue(self) -> int:
        return len(self._reissue)

    def drain_stranding_events(self):
        """Consume the (endpoint, reason, time) stranding journal: one
        entry per task that had to be re-issued, attributed to the endpoint
        that lost it (the fleet controller's fault signal)."""
        events = list(self._strandings)
        self._strandings.clear()
        return events


class LedgerJournal:
    """The :class:`TaskLedger`'s book on disk under ``model_dir``:

    * ``ledger.snap``: the whole book (outstanding tasks, re-issue queue,
      task id high-water mark, chunk screen and the learner's counters
      under ``extra``), republished atomically at every epoch sync;
    * ``ledger.delta.wal``: CRC-framed records journaled between
      snapshots, ``a`` (assign: tid and payload), ``c`` (complete), ``s``
      (strand, re-issue), ``x`` (cancel), ``p`` (a streamed chunk
      delivered: key and chunk index) and ``q`` (a streamed assembly
      closed). One O_APPEND write a record, no fsync a record; a torn
      tail is truncated at load.

    Records are the data-only codec's (``connection.pack``: msgpack's
    bytes), because payloads carry int-keyed dicts (``model_id``) that
    JSON would turn into strings. :meth:`snapshot` lands the snap before
    it truncates the delta, and every op replays idempotently over a
    snapshot that folded it in already, so a crash between the two loads
    the same book."""

    SNAP = 'ledger.snap'
    DELTA = 'ledger.delta.wal'

    def __init__(self, model_dir: str):
        from .connection import pack, unpack
        self._pack, self._unpack = pack, unpack
        self.snap_path = os.path.join(model_dir, self.SNAP)
        self.delta_path = os.path.join(model_dir, self.DELTA)
        self._delta_fd: Optional[int] = None

    def exists(self) -> bool:
        return (os.path.exists(self.snap_path)
                or os.path.exists(self.delta_path))

    def record(self, op: str, tid: int, base: Optional[dict] = None,
               **extra):
        """Append one delta op in a single torn-safe write; ``extra``
        carries the ``p``/``q`` ops' assembly ``key`` and chunk ``ci``."""
        if self._delta_fd is None:
            os.makedirs(os.path.dirname(self.delta_path) or '.',
                        exist_ok=True)
            self._delta_fd = open_append(self.delta_path)
        rec: Dict[str, Any] = {'op': op, 'tid': int(tid)}
        if base is not None:
            rec['base'] = base
        if extra:
            rec.update(extra)
        append_framed_record(self._delta_fd, self._pack(rec))

    def snapshot(self, state: Dict[str, Any]):
        """Republish the whole book atomically, then truncate the delta
        journal."""
        os.makedirs(os.path.dirname(self.snap_path) or '.', exist_ok=True)
        atomic_write_bytes(self.snap_path, self._pack(state))
        if self._delta_fd is not None:
            os.close(self._delta_fd)
            self._delta_fd = None
        atomic_write_bytes(self.delta_path, b'')

    def load(self) -> Optional[Dict[str, Any]]:
        """Replay the snapshot and the deltas into a restorable book,
        truncating a torn delta tail in place; None when nothing was ever
        journaled. ``chunks_closed`` lists the assemblies closed after the
        snapshot (their episodes post-date its counters). ``key_marks``
        holds, by role ('g', 'e'), one past the largest ``sample_key``
        of every task assigned since the snapshot, completed ones
        included: a learner killed before its first snapshot has no
        counters in ``extra``, and without the marks its fresh tasks
        would reuse the keys of episodes the spool replays (the JAX
        package's book has no such marks; ROADMAP.md F4)."""
        try:
            with open(self.snap_path, 'rb') as f:
                state = self._unpack(f.read())
        except Exception:
            state = None          # missing or corrupt: the deltas alone
        if not isinstance(state, dict):
            state = None
        snap = state or {}
        tasks = dict(snap.get('tasks') or {})
        reissue = list(snap.get('reissue') or ())
        next_tid = int(snap.get('next_tid') or 0)
        chunks: Dict[Any, set] = {}
        closed_chunks: list = []
        key_marks: Dict[str, int] = {}
        for pair in snap.get('chunks') or ():
            try:
                key, cis = pair
                chunks[(str(key[0]), int(key[1]))] = set(int(c) for c in cis)
            except Exception:
                continue
        records, valid_bytes, torn = read_framed_records(self.delta_path)
        if torn:
            os.truncate(self.delta_path, valid_bytes)
        for payload in records:
            try:
                rec = self._unpack(payload)
                op, tid = rec['op'], int(rec['tid'])
            except Exception:
                continue
            if op == 'a':
                base = rec.get('base')
                tasks[tid] = base
                next_tid = max(next_tid, tid + 1)
                if isinstance(base, dict) \
                        and base.get('sample_key') is not None:
                    role = str(base.get('role'))
                    key_marks[role] = max(key_marks.get(role, 0),
                                          int(base['sample_key']) + 1)
            elif op in ('c', 'x'):
                tasks.pop(tid, None)
            elif op == 's':
                base = tasks.pop(tid, None)
                if base is not None:
                    reissue.append(base)
            elif op in ('p', 'q'):
                try:
                    key = rec['key']
                    k = (str(key[0]), int(key[1]))
                    if op == 'p':
                        chunks.setdefault(k, set()).add(int(rec['ci']))
                        continue
                except Exception:
                    continue
                chunks.pop(k, None)
                if k not in closed_chunks:
                    closed_chunks.append(k)
        if state is None and not records:
            return None
        out = {'tasks': tasks, 'reissue': reissue, 'next_tid': next_tid,
               'extra': dict(snap.get('extra') or {})}
        if chunks:
            out['chunks'] = [[list(k), sorted(cis)]
                             for k, cis in chunks.items()]
        if closed_chunks:
            out['chunks_closed'] = [list(k) for k in closed_chunks]
        if key_marks:
            out['key_marks'] = key_marks
        return out

    def close(self):
        if self._delta_fd is not None:
            os.close(self._delta_fd)
            self._delta_fd = None


# host health states, in escalation order
HOST_HEALTHY = 'healthy'
HOST_DEGRADED = 'degraded'
HOST_DRAINING = 'draining'
HOST_QUARANTINED = 'quarantined'
HOST_STATES = (HOST_HEALTHY, HOST_DEGRADED, HOST_DRAINING, HOST_QUARANTINED)


class FleetController:
    """Per-host health state machine: decides, per task assignment,
    whether a host should receive fresh work.

    Inputs are two fault streams per host key: **strandings** (tasks the
    ledger re-issued because this host's endpoint detached or missed its
    deadline) and **soft faults** (failovers the host's heartbeats
    report). Every host starts ``healthy``; all windows slide:

    * ``healthy -> degraded``: at least ``degrade_after`` signals of either
      kind within ``health_window`` seconds (it still gets tasks);
    * ``degraded -> healthy``: a quiet ``health_window``;
    * ``healthy/degraded -> draining``: at least ``quarantine_after``
      strandings within the window. No fresh tasks; booked ones may land;
    * ``draining -> quarantined``: its outstanding book is empty;
    * ``quarantined -> healthy``: ``quarantine_period`` seconds later, with
      a cleared fault history.

    ``admits(host)`` is the server's assignment gate; transitions are
    journaled for ``drain_transitions``."""

    def __init__(self, degrade_after: int = 1, quarantine_after: int = 3,
                 health_window: float = 120.0,
                 quarantine_period: float = 60.0, clock=time.time):
        self.degrade_after = max(1, int(degrade_after))
        self.quarantine_after = max(1, int(quarantine_after))
        self.health_window = float(health_window)
        self.quarantine_period = float(quarantine_period)
        self._clock = clock
        self._state: Dict[str, str] = {}
        self._strands: Dict[str, deque] = defaultdict(deque)   # event times
        self._softs: Dict[str, deque] = defaultdict(deque)
        self._until: Dict[str, float] = {}          # quarantine expiry
        self._transitions: deque = deque(maxlen=4096)
        self.stats: Dict[str, int] = {
            'degraded': 0, 'quarantined': 0, 'readmitted': 0, 'withheld': 0}

    # -- queries --

    def observe(self, host: str) -> bool:
        """Register ``host`` (idempotent); True the first time."""
        if host in self._state:
            return False
        self._state[host] = HOST_HEALTHY
        return True

    def state(self, host: str) -> str:
        return self._state.get(host, HOST_HEALTHY)

    def admits(self, host: str) -> bool:
        """May ``host`` receive fresh task assignments right now?"""
        return self.state(host) in (HOST_HEALTHY, HOST_DEGRADED)

    def snapshot(self) -> Dict[str, str]:
        return dict(self._state)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in HOST_STATES}
        for state in self._state.values():
            out[state] += 1
        return out

    def drain_transitions(self):
        """Consume the (host, from_state, to_state, time) journal."""
        events = list(self._transitions)
        self._transitions.clear()
        return events

    # -- operator actions (the serving resolver) --

    def force_drain(self, host: str):
        """Deliberately drain ``host`` (an autoscaler scale-down or an
        operator's drain): no fresh work now, quarantined once its book is
        empty."""
        self.observe(host)
        if self.state(host) in (HOST_HEALTHY, HOST_DEGRADED):
            self._set(host, HOST_DRAINING)

    def readmit(self, host: str):
        """Re-admit ``host`` at once with a cleared fault history: a
        replica that re-registered with the resolver has recovered before
        its quarantine ran out."""
        self.observe(host)
        self._strands[host].clear()
        self._softs[host].clear()
        self._until.pop(host, None)
        if self.state(host) != HOST_HEALTHY:
            self._set(host, HOST_HEALTHY)
            self.stats['readmitted'] += 1

    def forget(self, host: str):
        """Drop ``host`` from the book (a replica deliberately retired)."""
        self._state.pop(host, None)
        self._strands.pop(host, None)
        self._softs.pop(host, None)
        self._until.pop(host, None)

    # -- fault feeds --

    def record_stranding(self, host: str, n: int = 1):
        now = self._clock()
        self._strands[host].extend([now] * max(1, int(n)))
        self._reassess(host, now)

    def record_soft_fault(self, host: str, n: int = 1):
        now = self._clock()
        self._softs[host].extend([now] * max(1, int(n)))
        self._reassess(host, now)

    # -- transitions --

    def _set(self, host: str, state: str):
        prev = self._state.get(host, HOST_HEALTHY)
        if prev != state:
            self._state[host] = state
            self._transitions.append((host, prev, state, self._clock()))
            telemetry.record_event('transition', host, **{
                'from': prev, 'to': state})

    def _prune(self, host: str, now: float):
        horizon = now - self.health_window
        for dq in (self._strands[host], self._softs[host]):
            while dq and dq[0] < horizon:
                dq.popleft()

    def _reassess(self, host: str, now: float):
        self.observe(host)
        self._prune(host, now)
        state = self.state(host)
        strands = len(self._strands[host])
        faults = strands + len(self._softs[host])
        if (state in (HOST_HEALTHY, HOST_DEGRADED)
                and strands >= self.quarantine_after):
            self._set(host, HOST_DRAINING)
        elif state == HOST_HEALTHY and faults >= self.degrade_after:
            self._set(host, HOST_DEGRADED)
            self.stats['degraded'] += 1

    def tick(self, outstanding: Optional[Dict[str, int]] = None):
        """Time- and drain-driven transitions; ``outstanding`` maps host
        key -> open ledger tasks (a draining host quarantines at 0)."""
        now = self._clock()
        outstanding = outstanding or {}
        for host, state in list(self._state.items()):
            if state == HOST_DRAINING:
                if outstanding.get(host, 0) <= 0:
                    self._until[host] = now + self.quarantine_period
                    self._set(host, HOST_QUARANTINED)
                    self.stats['quarantined'] += 1
            elif state == HOST_QUARANTINED:
                if now >= self._until.get(host, 0.0):
                    self._strands[host].clear()
                    self._softs[host].clear()
                    self._set(host, HOST_HEALTHY)
                    self.stats['readmitted'] += 1
            elif state == HOST_DEGRADED:
                self._prune(host, now)
                if not self._strands[host] and not self._softs[host]:
                    self._set(host, HOST_HEALTHY)


class SessionLedger:
    """The match gateway's session-affinity book: which replica each open
    session's plies go to, so that a session's consecutive plies meet in
    one engine's batch.

    The gateway keeps the hidden-state cache itself; this book holds only
    the affinity and the strandings. ``fail_replica`` strands every
    session booked on a dead or draining replica and returns them; the
    gateway then hands each off (its cached state rides the next request
    to a survivor) or rebuilds it from the session's journal."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._sessions: Dict[Any, Any] = {}          # sid -> replica
        self._by_replica: Dict[Any, set] = defaultdict(set)
        self._strandings: deque = deque(maxlen=4096)  # (sid, replica, why, t)
        self.stats: Dict[str, int] = {
            'booked': 0, 'moved': 0, 'released': 0,
            'stranded': 0, 'replica_failures': 0,
        }

    def book(self, sid, replica) -> None:
        """Bind a fresh session to the replica that served its first ply."""
        self.release(sid)
        self._sessions[sid] = replica
        self._by_replica[replica].add(sid)
        self.stats['booked'] += 1

    def move(self, sid, replica) -> Optional[Any]:
        """Re-pin ``sid`` (a handoff or a rebuild landed elsewhere); the
        previous replica, or None for a session not booked."""
        prev = self._sessions.get(sid)
        if prev == replica:
            return prev
        if prev is not None:
            self._unbook(sid, prev)
            self.stats['moved'] += 1
        else:
            self.stats['booked'] += 1
        self._sessions[sid] = replica
        self._by_replica[replica].add(sid)
        return prev

    def release(self, sid) -> bool:
        """Close the book on a finished or abandoned session."""
        replica = self._sessions.pop(sid, None)
        if replica is None:
            return False
        self._unbook(sid, replica)
        self.stats['released'] += 1
        return True

    def _unbook(self, sid, replica) -> None:
        owners = self._by_replica.get(replica)
        if owners is not None:
            owners.discard(sid)
            if not owners:
                self._by_replica.pop(replica, None)

    def replica_of(self, sid) -> Optional[Any]:
        return self._sessions.get(sid)

    def sessions_on(self, replica) -> list:
        return sorted(self._by_replica.get(replica, ()))

    def fail_replica(self, replica, reason: str = 'detach') -> list:
        """Strand every session pinned to a dead or draining replica; the
        caller hands each off or rebuilds it."""
        sids = self.sessions_on(replica)
        now = self._clock()
        for sid in sids:
            self._sessions.pop(sid, None)
            self._strandings.append((sid, replica, reason, now))
            telemetry.record_event('session_stranding', str(replica),
                                   reason=reason, session=str(sid))
        self._by_replica.pop(replica, None)
        self.stats['stranded'] += len(sids)
        if sids:
            self.stats['replica_failures'] += 1
        return sids

    def outstanding(self) -> int:
        return len(self._sessions)

    def outstanding_by_replica(self) -> Dict[Any, int]:
        return {rep: len(sids) for rep, sids in self._by_replica.items()
                if sids}

    def drain_stranding_events(self):
        """Consume the (sid, replica, reason, time) stranding journal."""
        events = list(self._strandings)
        self._strandings.clear()
        return events


def parse_chaos(spec: Optional[str] = None) -> Dict[str, float]:
    """Parse ``HANDYRL_TPU_CHAOS`` (or an explicit spec string) into a dict
    of float knobs; empty/unset means chaos off. Malformed entries are
    ignored rather than crashing a production run."""
    if spec is None:
        spec = os.environ.get('HANDYRL_TPU_CHAOS', '')
    out: Dict[str, float] = {}
    for part in (spec or '').split(','):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition('=')
        try:
            out[key.strip()] = float(value)
        except ValueError:
            print('ignoring malformed HANDYRL_TPU_CHAOS entry %r' % part)
    return out
