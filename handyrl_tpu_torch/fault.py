"""Fault-tolerance primitives of the learner-worker plane (the subset of
``handyrl_tpu/fault.py`` the port runs):

* :class:`Backoff`: exponential reconnect delays with jitter.
* :class:`TaskLedger`: the learner's book of outstanding tasks. Tasks
  stranded by a detached endpoint or a missed deadline are re-issued ahead
  of fresh work, and late duplicate uploads are dropped once, so episode
  accounting converges while actors come and go.
* :class:`FleetController`: the per-host health states (healthy,
  degraded, draining, quarantined) that decide whether a host gets fresh
  tasks.
* :func:`parse_chaos`: the ``HANDYRL_TPU_CHAOS`` drills
  (``kill_gather=<mean s>`` and ``kill_worker=<mean s>`` with
  ``max_kills``/``seed`` on the worker plane; ``preempt``, ``nanstep`` and
  friends in the learner).

Both classes are pure Python on an injectable clock.
"""

from __future__ import annotations

import copy
import os
import random
import time
from collections import defaultdict, deque
from typing import Any, Dict, Optional


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
    is why it bypasses the fresh-task path. The JAX package's book also
    screens streamed chunks and journals itself to disk; those parts wait
    for the port's streaming and durability planes."""

    def __init__(self, deadline: float = 300.0, clock=time.time):
        self.deadline = float(deadline)
        self._clock = clock
        self._tasks: Dict[int, tuple] = {}          # tid -> (endpoint, base, expires)
        self._by_endpoint: Dict[Any, set] = defaultdict(set)
        self._reissue: deque = deque()
        self._strandings: deque = deque(maxlen=4096)  # (endpoint, reason, t)
        self._next_tid = 0
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
        return True

    def admit(self, items):
        """Filter an upload batch through the book (see the class
        docstring). A None item (a failed episode) passes: its task's
        deadline re-issues it."""
        out = []
        for item in items:
            if item is None:
                out.append(item)
                continue
            tid = (item.get('args') or {}).get('task_id')
            if tid is None or self.complete(tid):
                out.append(item)
        return out

    # -- loss handling --

    def _strand(self, tid, reason: str = 'detach'):
        endpoint, base, _expires = self._unbook(tid)
        self._reissue.append(base)
        self._strandings.append((endpoint, reason, self._clock()))
        self.stats['reissued'] += 1

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
        return self._reissue.popleft() if self._reissue else None

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
