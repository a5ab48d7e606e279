"""The ('data', 'model') mesh over the job's ranks, and batch staging.

The port of ``handyrl_tpu/parallel/mesh.py``. There the batch is sharded
along 'data' over a named device mesh and XLA inserts the gradient
all-reduce; here a device is a rank of the torch.distributed job
(``parallel/multihost.py``), each rank holds its own 1/W slice of the
batch, and the update step sums its gradients with :meth:`Mesh.all_reduce_`
(``ops/train_step.py``). The 'model' axis is kept, 1 wide: tensor
parallelism is ROADMAP.md section 1 item 5b.

``shard_batch`` stages this rank's slice of a host batch, and counts the
host bytes it staged on the ``mesh_shard_bytes_total`` counter (the JAX
package's name), so the 1/W-per-device transfer contract is observable.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .. import telemetry
from ..utils.tree import map_structure
from . import multihost

DATA_AXIS = 'data'
MODEL_AXIS = 'model'

# host bytes staged by shard_batch on this rank (1/W of a batch's bytes;
# a replicated leaf counts whole)
_SHARD_BYTES = telemetry.counter('mesh_shard_bytes_total')


class PartitionSpec(tuple):
    """The port's PartitionSpec: one mesh axis name (or None) a dim;
    ``PartitionSpec()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return 'PartitionSpec%s' % (tuple.__repr__(self),)


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec over a mesh, as a descriptor (nothing is placed by it)."""
    mesh: 'Mesh'
    spec: PartitionSpec


class Mesh:
    """The job's ranks as a ('data', 'model') mesh: ``shape`` is
    ``{'data': W, 'model': 1}``, ``index`` this rank's place on 'data'.
    :meth:`all_reduce_` sums a tensor over the ranks in place (the update
    step's one collective a step), on the backend
    ``multihost.select_backend`` chose, and keeps its times: the host
    clock of every call and, on a card, CUDA events around it."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, data: int, model: int = 1, index: int = 0):
        self.shape: Dict[str, int] = {DATA_AXIS: int(data),
                                      MODEL_AXIS: int(model)}
        self.index = int(index)
        self.backend = multihost.collective_backend()
        self._group = multihost.collective_group()
        self._staging: Optional[torch.Tensor] = None
        self.collectives = 0
        self.collective_bytes = 0
        self.collective_seconds = 0.0
        self._events: deque = deque(maxlen=256)

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def all_reduce_(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over the ranks, in place: NCCL on the card's
        tensor; gloo on a host tensor, or on a card's tensor staged
        through a pinned host buffer (ranks sharing a card)."""
        dist = multihost._dist()
        t0 = time.perf_counter()
        on_card = flat.device.type == 'cuda'
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        if on_card and self.backend != 'nccl':
            if self._staging is None or self._staging.shape != flat.shape:
                self._staging = torch.empty(flat.shape, dtype=flat.dtype,
                                            pin_memory=True)
            self._staging.copy_(flat)      # waits for the step's stream
            dist.all_reduce(self._staging)
            flat.copy_(self._staging)
        else:
            dist.all_reduce(flat, group=self._group)
        if on_card:
            end.record()
            self._events.append((start, end))
        self.collectives += 1
        self.collective_bytes += flat.numel() * flat.element_size()
        self.collective_seconds += time.perf_counter() - t0
        return flat

    def collective_stats(self) -> Dict[str, Any]:
        """The collective's count, bytes a call, host ms a call and, on a
        card, the mean CUDA-event ms of its last (up to 256) calls."""
        n = self.collectives
        cuda_ms = None
        if self._events:
            self._events[-1][1].synchronize()
            cuda_ms = (sum(s.elapsed_time(e) for s, e in self._events)
                       / len(self._events))
        return {'backend': self.backend, 'count': n,
                'bytes_per_call': self.collective_bytes // n if n else 0,
                'host_ms_per_call': (1e3 * self.collective_seconds / n
                                     if n else None),
                'cuda_ms_per_call': cuda_ms}


def make_mesh(model_parallel: int = 1) -> Mesh:
    """(W/model_parallel, model_parallel) mesh over the job's W ranks; a
    1x1 mesh outside a job. ``model_parallel`` above 1 is tensor
    parallelism, ROADMAP.md section 1 item 5b."""
    n = multihost.process_count()
    assert n % model_parallel == 0, (n, model_parallel)
    if model_parallel != 1:
        raise NotImplementedError(
            'a model axis of %d is tensor parallelism, ROADMAP.md section 1 '
            'item 5b' % model_parallel)
    return Mesh(n // model_parallel, model_parallel,
                index=multihost.process_index())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading (batch) dim split across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh, batch):
    """This rank's 1/W slice of every leaf of ``batch`` (dicts, lists and
    tuples of arrays) along dim 0 ('data'); a scalar replicates. Host
    (numpy) leaves become host tensors, their staged bytes counted; tensor
    leaves are sliced where they are."""
    w, r = mesh.shape[DATA_AXIS], mesh.index

    def place(x):
        arr = x if isinstance(x, torch.Tensor) else np.asarray(x)
        if arr.ndim:
            n = arr.shape[0]
            assert n % w == 0, 'a batch of %d does not divide over %d ' \
                'ranks' % (n, w)
            arr = arr[r * n // w:(r + 1) * n // w]
        if isinstance(arr, torch.Tensor):
            return arr.clone()
        arr = np.ascontiguousarray(arr)
        if telemetry.enabled():
            _SHARD_BYTES.inc(arr.nbytes)
        return torch.from_numpy(arr)

    return map_structure(place, batch)


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k
