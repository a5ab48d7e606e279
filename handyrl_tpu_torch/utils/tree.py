"""Small host-side pytree helpers.

Copy of ``handyrl_tpu/utils/tree.py``. They cover nested lists, tuples and
dicts of numpy arrays where ``None`` is a meaningful leaf (a player who did
not observe a step).
"""

from __future__ import annotations

import numpy as np


def map_structure(fn, x):
    """Recursively apply ``fn`` to every non-container leaf, keeping None-leaves
    visible to ``fn``."""
    if isinstance(x, (list, tuple)):
        return type(x)(map_structure(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_structure(fn, v) for k, v in x.items()}
    return fn(x)


def stack_structure(items, axis=0):
    """Stack a list of identically-shaped structures leaf-wise into arrays."""
    head = items[0]
    if isinstance(head, (list, tuple)):
        return type(head)(stack_structure([it[i] for it in items], axis)
                          for i in range(len(head)))
    if isinstance(head, dict):
        return {k: stack_structure([it[k] for it in items], axis) for k in head}
    return np.stack([np.asarray(it) for it in items], axis=axis)


def batch_structure(x):
    """Add a leading batch dim of 1 to every leaf (None passes through)."""
    return map_structure(lambda v: None if v is None else np.asarray(v)[None], x)


def unbatch_structure(x):
    """Drop the leading batch dim from every leaf (None passes through)."""
    return map_structure(lambda v: None if v is None else np.asarray(v)[0], x)


def softmax(x: np.ndarray) -> np.ndarray:
    """Numerically stable softmax over the last axis (host numpy)."""
    e = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)
