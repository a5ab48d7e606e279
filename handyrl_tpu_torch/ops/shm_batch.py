"""Batcher processes and their shared-memory batch arenas.

The port of ``handyrl_tpu/ops/shm_batch.py`` and of the JAX learner's
child entry points (``_batcher_process``, ``_batcher_process_shm``,
handyrl_tpu/train.py:94-185). With ``batcher_processes`` the learner keeps
window selection and sends each batch's selected episodes to spawned
children, which build the ``(B, T, P, ...)`` batch with
``ops.batch.make_batch``. Without ``batcher_shared_memory`` the batch
comes back pickled over the pipe. With it, each child owns a ring of
``multiprocessing.shared_memory`` slots, builds batches in place
(``make_batch(..., out=slot views)``) and sends only a slot descriptor; the
trainer maps the same pages (:class:`ArenaMap`) and hands the views to its
staging copy.

This module imports no ``torch``: the children import only it,
``ops.batch``, ``utils.tree`` and ``telemetry``, so they start in well
under a second and cannot open a CUDA context.

Layout: one SharedMemory segment per slot, leaves packed at 64-byte-aligned
offsets in spec order. The spec (leaf paths, shapes, dtypes, offsets) is
derived from the first batch a child builds and rides in its first
descriptor; later descriptors carry only the slot.

Flow control: a child marks a slot busy when it sends the descriptor and
reuses it only after the trainer's ``('__free__', slot)`` message comes
back (sent once the batch was copied into the trainer's pinned staging
buffers), so at most ``_SHM_SLOTS`` batches a child are in flight. A
``None`` job tells a child to exit; it unlinks its segments on every exit.
"""

from __future__ import annotations

import atexit
import signal
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import telemetry
from .batch import make_batch, make_block_cache

_ALIGN = 64      # leaf offsets cache-line aligned (also keeps dtypes aligned)
_SHM_SLOTS = 4   # in-flight shared-memory batches per batcher child

_LOG = telemetry.get_logger('batcher')

# the train_args a child's make_batch reads (the job's args)
JOB_ARG_KEYS = ('turn_based_training', 'observation', 'forward_steps',
                'burn_in_steps', 'compress_steps', 'maximum_episodes',
                'decode_cache_blocks')


# ---------------------------------------------------------------------------
# spec: a picklable description of a batch's memory layout


def _walk_leaves(prefix: Tuple, x, out: List[Tuple[Tuple, np.ndarray]]):
    if isinstance(x, dict):
        for k in x:
            _walk_leaves(prefix + (k,), x[k], out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk_leaves(prefix + (i,), v, out)
    else:
        out.append((prefix, np.asarray(x)))


def batch_spec(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Describe ``batch``'s leaves (path, shape, dtype, 64-byte-aligned
    offset) and the total bytes."""
    leaves: List[Tuple[Tuple, np.ndarray]] = []
    _walk_leaves((), batch, leaves)
    entries = []
    offset = 0
    for path, arr in leaves:
        offset = (offset + _ALIGN - 1) // _ALIGN * _ALIGN
        entries.append({'path': list(path), 'shape': list(arr.shape),
                        'dtype': arr.dtype.str, 'offset': offset})
        offset += arr.nbytes
    return {'entries': entries, 'nbytes': max(offset, 1)}


def _set_path(root: Dict[str, Any], path: List, value):
    """Insert ``value`` at ``path``, creating nested dicts/lists on the way
    (integer components are list indices, filled in ascending order)."""
    node = root
    for key, nxt in zip(path[:-1], path[1:]):
        container = [] if isinstance(nxt, int) else {}
        if isinstance(node, list):
            if key == len(node):
                node.append(container)
            node = node[key]
        else:
            node = node.setdefault(key, container)
    last = path[-1]
    if isinstance(node, list):
        if last != len(node):
            raise ValueError('list leaves out of order in the spec: %r'
                             % (path,))
        node.append(value)
    else:
        node[last] = value


def map_batch(buf, spec: Dict[str, Any]) -> Dict[str, Any]:
    """The batch structure as numpy views over ``buf`` (no copy)."""
    root: Dict[str, Any] = {}
    for e in spec['entries']:
        arr = np.ndarray(tuple(e['shape']), dtype=np.dtype(e['dtype']),
                         buffer=buf, offset=e['offset'])
        _set_path(root, list(e['path']), arr)
    return root


def copy_into(views: Dict[str, Any], batch: Dict[str, Any]):
    """Leaf-wise copy of ``batch`` into mapped ``views`` (once, for the
    first batch, built before the spec existed)."""
    src: List[Tuple[Tuple, np.ndarray]] = []
    _walk_leaves((), batch, src)
    dst: List[Tuple[Tuple, np.ndarray]] = []
    _walk_leaves((), views, dst)
    for (ps, s), (pd, d) in zip(src, dst):
        if ps != pd:
            raise ValueError('batch leaf %r does not match the arena\'s %r'
                             % (ps, pd))
        np.copyto(d, s)


# ---------------------------------------------------------------------------
# child side


class ArenaRing:
    """A batcher child's ring of shared-memory batch slots; the child owns
    (and unlinks) the segments."""

    def __init__(self, spec: Dict[str, Any], slots: int = _SHM_SLOTS):
        self.spec = spec
        self.shms = [shared_memory.SharedMemory(create=True,
                                                size=spec['nbytes'])
                     for _ in range(slots)]
        self.views = [map_batch(shm.buf, spec) for shm in self.shms]
        self.free: List[int] = list(range(slots))
        self._slots = slots
        # slots in flight toward the trainer: pinned at the ring size, the
        # trainer is the bottleneck
        self._m_in_use = telemetry.gauge('shm_slots_in_use')
        self._closed = False
        # unlink on any interpreter exit that bypasses the builder loop's
        # finally; close() is idempotent, so both may fire
        atexit.register(self.close)

    @property
    def names(self) -> List[str]:
        return [shm.name for shm in self.shms]

    def acquire(self) -> Optional[int]:
        slot = self.free.pop(0) if self.free else None
        self._m_in_use.set(self._slots - len(self.free))
        return slot

    def release(self, slot: int):
        self.free.append(slot)
        self._m_in_use.set(self._slots - len(self.free))

    def close(self):
        if self._closed:
            return
        self._closed = True
        shms, self.shms, self.views, self.free = self.shms, [], [], []
        for shm in shms:
            try:
                shm.close()
            except BufferError:
                # a live numpy view pins the mapping; the OS drops it at
                # exit. What must not leak is the name, unlinked below
                pass
            try:
                shm.unlink()
            except FileNotFoundError:
                pass   # already unlinked (the resource tracker won)


def selected_trace_ids(selected) -> List[str]:
    """The sorted, deduplicated and sampled trace ids of the episodes a
    batch's windows were selected from (recency bias repeats
    episodes)."""
    out = set()
    for sel in selected:
        tid = telemetry.episode_trace_id(sel.get('args') or {})
        if tid and telemetry.trace_sampled(tid):
            out.add(tid)
    return sorted(out)


def _exit_on_sigterm(signum, frame):
    raise SystemExit(0)   # through the builder's finally, which unlinks


def _is_free_msg(msg) -> bool:
    return (isinstance(msg, tuple) and len(msg) == 2
            and msg[0] == '__free__')


def batcher_process(conn, bid: int):
    """A batcher child (``batcher_processes``): receive ``(selected,
    job_args)``, send the built batch back pickled; exit on ``None`` or a
    closed pipe."""
    _LOG.info('started batcher process %d', bid)
    cache, have_cache = None, False
    while True:
        try:
            job = conn.recv()
        except EOFError:
            return
        if job is None:
            return
        selected, args = job
        if not have_cache:
            cache, have_cache = make_block_cache(args), True
        conn.send(make_batch(selected, args, cache=cache))


def batcher_process_shm(conn, bid: int):
    """A batcher child writing into shared-memory slots (``batcher_processes``
    and ``batcher_shared_memory``). The first batch bootstraps the layout:
    built in private memory, sized into the ring (spec and segment names
    ride its descriptor) and copied in once; later batches are built in
    place. A slot is reused only after the trainer's ``('__free__', slot)``
    message. Sends ``{'bid', 'slot'[, 'spec', 'names']}``."""
    _LOG.info('started shm batcher process %d', bid)
    # a parent that exits without closing the pool terminates its daemonic
    # children: unlink on that too
    signal.signal(signal.SIGTERM, _exit_on_sigterm)
    ring: Optional[ArenaRing] = None
    cache, have_cache = None, False

    def recv():
        """The next job, releasing slots on the way; None to exit."""
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                return None
            if not _is_free_msg(msg):
                return msg
            ring.release(msg[1])

    def acquire_slot() -> Optional[int]:
        slot = ring.acquire()
        while slot is None:   # every slot in flight: wait for a free message
            try:
                msg = conn.recv()
            except EOFError:
                return None
            if msg is None:
                return None
            if not _is_free_msg(msg):
                raise RuntimeError('expected a slot-free message, got %r'
                                   % (msg,))
            ring.release(msg[1])
            slot = ring.acquire()
        return slot

    try:
        while True:
            job = recv()
            if job is None:
                return
            selected, args = job
            desc: Dict[str, Any] = {'bid': bid}
            if not have_cache:
                cache, have_cache = make_block_cache(args), True
            if ring is None:
                batch = make_batch(selected, args, cache=cache)
                ring = ArenaRing(batch_spec(batch))
                slot = ring.acquire()
                copy_into(ring.views[slot], batch)
                desc['spec'] = ring.spec
                desc['names'] = ring.names
            else:
                slot = acquire_slot()
                if slot is None:
                    return
                make_batch(selected, args, out=ring.views[slot], cache=cache)
            desc['slot'] = slot
            if telemetry.trace_enabled():
                # the sampled episode trace ids of the slot's windows: the
                # trainer's train_step trace event links back through them
                desc['trace'] = selected_trace_ids(selected)
            conn.send(desc)
    finally:
        # this process owns the segments: unlink them on any exit
        if ring is not None:
            ring.close()


# ---------------------------------------------------------------------------
# trainer side


class ArenaMap:
    """The trainer's lazily attached view of every child's slot segments.
    It never unlinks: the children own the names."""

    def __init__(self):
        self._segs: Dict[str, shared_memory.SharedMemory] = {}
        self._views: Dict[str, Dict[str, Any]] = {}

    def attach(self, name: str, spec: Dict[str, Any]) -> Dict[str, Any]:
        if name not in self._views:
            seg = shared_memory.SharedMemory(name=name)
            self._segs[name] = seg
            self._views[name] = map_batch(seg.buf, spec)
        return self._views[name]

    def close(self):
        self._views.clear()
        for seg in self._segs.values():
            try:
                seg.close()
            except BufferError:
                pass   # a live view pins the mapping until exit
        self._segs.clear()


class SharedBatch:
    """A built batch, the sampled episode trace ids of its windows (None
    while tracing is off) and, for a batch mapped from a child's slot, the
    callback that frees the slot (None for a batcher thread's batch).

    The consumer calls :meth:`release` once the data has been read (the
    trainer: after the copy into its pinned staging buffers, or after the
    step on the CPU); further calls do nothing. The child never overwrites
    a slot that has not been released."""

    __slots__ = ('batch', '_release', 'trace_ids')

    def __init__(self, batch: Dict[str, Any], release_fn, trace_ids=None):
        self.batch = batch
        self._release = release_fn
        self.trace_ids = trace_ids

    def release(self):
        fn, self._release = self._release, None
        if fn is not None:
            fn()
