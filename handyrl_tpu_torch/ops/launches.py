"""Kernel launch counts, by path, and the lock that makes a CUDA graph's
capture exclusive.

Every wrapper of a CUDA kernel calls :func:`count` where it launches its
kernel, and nowhere else. A count goes to the *path* of the calling thread
(:func:`path`, a context manager; 'main' outside one). The learner runs
generation, evaluation and training under their own names, so K1's serving
form and its training form are told apart by where they ran, and a graph
capture takes back only what its own path launched. Autograd runs a CUDA
backward on a thread of its own, so an autograd function keeps the path of
its forward for its backward (``geese_trunk.TrunkFunction``). The counts
are guarded by one lock: the generator and the trainer thread launch
concurrently.

:data:`capture_lock` is held by a CUDA graph's capture and by every
forward that launches on the card outside a graph
(``ModelWrapper.batch_inference``): under CUDA's global capture mode a
synchronising call of another thread (a ``.cpu()``, an allocation) during
the capture aborts it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Mapping, Optional

KERNELS = ('geese_trunk', 'geese_trunk_bwd', 'td_lambda', 'upgo', 'vtrace')
DEFAULT_PATH = 'main'

capture_lock = threading.Lock()

_lock = threading.Lock()
_by_path: Dict[str, Dict[str, int]] = {}
_local = threading.local()


def _zeros() -> Dict[str, int]:
    return {k: 0 for k in KERNELS}


def current_path() -> str:
    """The launch path of the calling thread."""
    return getattr(_local, 'path', DEFAULT_PATH)


def add(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (by kernel name; negative to take back) to the
    calling thread's path."""
    unknown = set(counts) - set(KERNELS)
    if unknown:
        raise KeyError('unknown kernels %s' % sorted(unknown))
    path_name = current_path()
    with _lock:
        row = _by_path.setdefault(path_name, _zeros())
        for name, n in counts.items():
            row[name] += n


def count(name: str) -> None:
    """One launch of kernel ``name`` on the calling thread's path."""
    add({name: 1})


@contextlib.contextmanager
def path(name: str) -> Iterator[None]:
    """Count this thread's launches under ``name`` inside the block."""
    before = current_path()
    _local.path = name
    try:
        yield
    finally:
        _local.path = before


def totals(of_path: Optional[str] = None) -> Dict[str, int]:
    """Launches of every kernel: of one path, or summed over all."""
    with _lock:
        rows = ([_by_path.get(of_path, _zeros())] if of_path is not None
                else list(_by_path.values()))
        return {k: sum(r[k] for r in rows) for k in KERNELS}


def by_path() -> Dict[str, Dict[str, int]]:
    """``{path: {kernel: launches}}`` for every path that counted."""
    with _lock:
        return {p: dict(r) for p, r in _by_path.items()}


def reset() -> None:
    """Every path's counts to 0."""
    with _lock:
        _by_path.clear()
