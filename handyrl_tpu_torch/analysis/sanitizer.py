"""Runtime concurrency sanitizer: lock-order-inversion detection and
thread accounting (``HANDYRL_TPU_SANITIZE=1``); a copy of
``handyrl_tpu/analysis/sanitizer.py`` with the same report text.

The Hub, gather, engine, resolver and gateway threads share mutable state
under ``# guarded-by:`` lock conventions; this module checks what a static
reading cannot see: the ORDER in which locks are actually taken at run
time. It installs thin wrappers over ``threading.Lock`` and
``threading.RLock`` (so every lock the package, or anything else in the
process, creates afterwards is instrumented) and over
``threading.Thread.start``:

* **Lock-order graph.** Each wrapper remembers its allocation site
  (file:line of construction: the stable identity that generalizes across
  instances, e.g. every ``Hub._lock`` is one node). Per-thread held-lock
  stacks feed a global edge set ``A -> B`` ("B acquired while A held");
  the first time the REVERSE edge is observed the pair is recorded as an
  inversion with both stacks: the classic ABBA deadlock, detected without
  ever deadlocking. Same-site pairs (two locks from one construction line,
  e.g. a list comprehension of per-endpoint locks) carry no order
  information and are skipped.

* **Thread accounting.** Every ``Thread.start`` records (name, daemon,
  site). ``thread_report`` flags anonymous threads (default ``Thread-N``
  names) and live non-daemon threads (leak candidates: they outlive the
  component that started them).

``Condition`` objects built after install wrap an instrumented RLock; the
wrapper implements ``_release_save`` / ``_acquire_restore`` / ``_is_owned``
so a ``cv.wait()`` correctly pops and re-pushes the held stack: waiting
must not leave phantom held locks that would fabricate edges.

Enabled via env: ``HANDYRL_TPU_SANITIZE=1`` installs at
``handyrl_tpu_torch`` import and prints a one-line report (plus inversion
details) on stderr at process exit. Unlike the JAX copy, a wrapper also
has ``_at_fork_reinit``, which ``concurrent.futures`` and ``logging``
read from a lock at import: the port installs before torch is imported,
which imports ``concurrent.futures.thread``. The API (``install`` / ``uninstall``
/ ``lock_report`` / ``thread_report`` / ``assert_clean``) serves the unit
tests directly. Overhead is a dict update per acquire: fine for chaos
runs and smokes, not for throughput runs. Set it only in the environment
of the processes whose report is read: a spawned child inherits it.
"""

from __future__ import annotations

import atexit
import os
import re
import sys
import threading
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

_raw_allocate = threading._allocate_lock          # the real C lock factory

_ENV_VAR = 'HANDYRL_TPU_SANITIZE'
_ANON_THREAD_RE = re.compile(r'^Thread-\d+')


def enabled_by_env() -> bool:
    return os.environ.get(_ENV_VAR, '').strip().lower() \
        not in ('', '0', 'false', 'off')


class _State:
    def __init__(self):
        self.meta = _raw_allocate()               # guards edges/inversions
        self.edges: Dict[Tuple[str, str], List[str]] = {}
        self.inversions: List[Dict[str, Any]] = []
        self.tls = threading.local()              # .held: list[(site, wrapper)]
        self.threads: List[Dict[str, Any]] = []
        self.installed = False
        self.orig_lock = None
        self.orig_rlock = None
        self.orig_start = None


_S = _State()


def _alloc_site() -> str:
    """file:line of the frame that constructed the lock (first frame
    outside this module and the threading module)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if not fn.endswith(('sanitizer.py', 'threading.py')):
            return '%s:%d' % (fn, f.f_lineno)
        f = f.f_back
    return '<unknown>'


def _held_stack() -> list:
    held = getattr(_S.tls, 'held', None)
    if held is None:
        held = _S.tls.held = []
    return held


def _note_acquired(wrapper):
    held = _held_stack()
    site = wrapper._site
    for prev_site, _prev in held:
        if prev_site == site:
            continue                      # same allocation site: unordered
        edge = (prev_site, site)
        back = (site, prev_site)
        with _S.meta:
            if edge not in _S.edges:
                _S.edges[edge] = traceback.format_stack()[:-2]
            if back in _S.edges:
                key = tuple(sorted((prev_site, site)))
                if not any(i['pair'] == key for i in _S.inversions):
                    _S.inversions.append({
                        'pair': key,
                        'first_order': back,
                        'second_order': edge,
                        'stack_then': _S.edges[back],
                        'stack_now': traceback.format_stack()[:-2],
                    })
    held.append((site, wrapper))


def _note_released(wrapper):
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][1] is wrapper:
            del held[i]
            return


class _SanitizedLock:
    """Wrapper over a raw lock; order-checks on acquire."""

    _reentrant = False

    def __init__(self):
        self._lock = self._make()
        self._site = _alloc_site()
        self._count = 0                   # reentrancy depth (RLock)

    @staticmethod
    def _make():
        return _raw_allocate()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            if not (self._reentrant and self._count > 0
                    and self._owned_by_me()):
                _note_acquired(self)
            self._count += 1
        return got

    def release(self):
        self._count = max(0, self._count - 1)
        if self._count == 0:
            _note_released(self)
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        # dispatches through the subclass override (a bare
        # ``__enter__ = acquire`` would freeze the base implementation)
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def _owned_by_me(self):
        return True                       # refined by the RLock subclass

    def _at_fork_reinit(self):
        # the stdlib re-initialises its module locks in a forked child
        # (concurrent.futures, logging), and reads the method at import
        self._lock._at_fork_reinit()
        self._count = 0

    def __repr__(self):
        return '<sanitized %s site=%s>' % (type(self).__name__, self._site)


class _SanitizedRLock(_SanitizedLock):
    _reentrant = True

    def __init__(self):
        super().__init__()
        self._owner: Optional[int] = None

    @staticmethod
    def _make():
        return threading._CRLock() if threading._CRLock is not None \
            else threading._PyRLock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            me = threading.get_ident()
            if self._owner != me:
                self._owner = me
                _note_acquired(self)
                self._count = 1
            else:
                self._count += 1
        return got

    def release(self):
        if self._count <= 1:
            self._count = 0
            self._owner = None
            _note_released(self)
        else:
            self._count -= 1
        self._lock.release()

    def _owned_by_me(self):
        return self._owner == threading.get_ident()

    def _at_fork_reinit(self):
        super()._at_fork_reinit()
        self._owner = None

    # Condition integration: wait() must fully release (popping the held
    # stack) and reacquire (pushing it back) through the bookkeeping.
    def _release_save(self):
        count, owner = self._count, self._owner
        self._count, self._owner = 0, None
        _note_released(self)
        if hasattr(self._lock, '_release_save'):
            state = self._lock._release_save()
        else:
            state = count
            for _ in range(count):
                self._lock.release()
        return (state, count, owner)

    def _acquire_restore(self, saved):
        state, count, owner = saved
        if hasattr(self._lock, '_acquire_restore'):
            self._lock._acquire_restore(state)
        else:
            for _ in range(count):
                self._lock.acquire()
        self._count, self._owner = count, threading.get_ident()
        _note_acquired(self)

    def _is_owned(self):
        return self._owner == threading.get_ident()


def _sanitized_lock_factory():
    return _SanitizedLock()


def _sanitized_rlock_factory():
    return _SanitizedRLock()


# ---------------------------------------------------------------------------
# thread accounting


def _recording_start(self, *a, **kw):
    _S.threads.append({
        'ref': weakref.ref(self),
        'name': self.name,
        'named': not _ANON_THREAD_RE.match(self.name or ''),
        'daemon': self.daemon,
        'site': _alloc_site(),
    })
    return _S.orig_start(self, *a, **kw)


# ---------------------------------------------------------------------------
# lifecycle + reports


def install():
    """Idempotent. Locks created BEFORE install stay uninstrumented (import
    order matters: the env-gated install in the package's ``__init__`` runs
    before any of its locks exists)."""
    if _S.installed:
        return
    _S.orig_lock = threading.Lock
    _S.orig_rlock = threading.RLock
    _S.orig_start = threading.Thread.start
    threading.Lock = _sanitized_lock_factory
    threading.RLock = _sanitized_rlock_factory
    threading.Thread.start = _recording_start
    _S.installed = True


def uninstall():
    if not _S.installed:
        return
    threading.Lock = _S.orig_lock
    threading.RLock = _S.orig_rlock
    threading.Thread.start = _S.orig_start
    _S.installed = False


def reset():
    """Clear collected state (tests)."""
    with _S.meta:
        _S.edges.clear()
        _S.inversions.clear()
    _S.threads = []


def lock_report() -> Dict[str, Any]:
    with _S.meta:
        return {'edges': len(_S.edges),
                'inversions': [dict(i) for i in _S.inversions]}


def thread_report() -> Dict[str, Any]:
    unnamed, leaked = [], []
    for rec in _S.threads:
        t = rec['ref']()
        alive = t is not None and t.is_alive()
        if not rec['named']:
            unnamed.append({'name': rec['name'], 'site': rec['site'],
                            'alive': alive})
        if alive and not rec['daemon'] \
                and t is not threading.current_thread():
            leaked.append({'name': rec['name'], 'site': rec['site']})
    return {'started': len(_S.threads), 'unnamed': unnamed, 'leaked': leaked}


def assert_clean():
    locks = lock_report()
    threads = thread_report()
    problems = []
    for inv in locks['inversions']:
        problems.append('lock-order inversion between %s and %s'
                        % inv['pair'])
    for t in threads['leaked']:
        problems.append('leaked non-daemon thread %r (started at %s)'
                        % (t['name'], t['site']))
    if problems:
        raise AssertionError('sanitizer: ' + '; '.join(problems))


def _exit_report():
    locks = lock_report()
    threads = thread_report()
    line = ('graftlint-sanitizer: %d lock-order inversion(s), '
            '%d unnamed thread(s), %d leaked non-daemon thread(s) '
            '[%d lock edges, %d threads started]'
            % (len(locks['inversions']), len(threads['unnamed']),
               len(threads['leaked']), locks['edges'], threads['started']))
    print(line, file=sys.stderr, flush=True)
    for inv in locks['inversions']:
        print('graftlint-sanitizer: INVERSION %s <-> %s\n'
              '  first seen order %s -> %s:\n%s\n  reversed here:\n%s'
              % (inv['pair'][0], inv['pair'][1], *inv['first_order'],
                 ''.join(inv['stack_then'][-6:]),
                 ''.join(inv['stack_now'][-6:])),
              file=sys.stderr, flush=True)
    for t in threads['unnamed']:
        print('graftlint-sanitizer: UNNAMED thread %r started at %s'
              % (t['name'], t['site']), file=sys.stderr, flush=True)


def install_from_env() -> bool:
    """Called from the package's ``__init__``: install and register the
    atexit report when HANDYRL_TPU_SANITIZE is set. Returns whether
    installed."""
    if not enabled_by_env():
        return False
    install()
    atexit.register(_exit_report)
    return True
