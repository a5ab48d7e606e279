"""The data-parallel job: one process a card, joined by torch.distributed.

The port of ``handyrl_tpu/parallel/multihost.py``. The JAX package starts
``jax.distributed`` so that ``jax.devices()`` sees every process's devices;
PyTorch's idiom is one process a card, so here the job's devices are its
ranks: the 'data' axis of ``parallel/mesh.py`` is the ranks of the process
group, the device count is the world size, and the coordinator is rank 0.
A world of 1 is the single-device path (no mesh, no collective), as the
JAX learner builds a mesh only over more than one device.

Typical launch (one learner process a card, the JAX package's variables):

    JAX_COORDINATOR_ADDRESS=localhost:8476 JAX_NUM_PROCESSES=2 \\
    JAX_PROCESS_ID=0 python -m handyrl_tpu_torch.train --config c.json &
    JAX_COORDINATOR_ADDRESS=localhost:8476 JAX_NUM_PROCESSES=2 \\
    JAX_PROCESS_ID=1 python -m handyrl_tpu_torch.train --config c.json

or the same three keys under ``train_args.distributed``.

:func:`initialize` joins the default group over gloo: the host's group,
which carries the learner's agreements (when to stop, the packed fetch's
gather). :func:`select_backend` then picks the group of the update step's
collective for the rank's device, with no quiet fallback: gloo for CPU
tensors; NCCL for CUDA tensors when every rank has a card of its own;
gloo, staged through the host, when ranks share a card (NCCL refuses two
ranks on one device), decided from the ranks' device UUIDs exchanged
over the host group.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

# the process group's timeout: a rank stranded in a collective raises
# after it (a peer that exits closes its connections sooner)
TIMEOUT_S = 600.0

# the collective backend of the update step, set by select_backend
_STATE = {'backend': None, 'group': None, 'reason': ''}


def _dist():
    import torch.distributed as dist
    return dist


def _init_method(address: str) -> str:
    """'host:port' (the JAX form) or a URL as torch takes it."""
    return address if '://' in address else 'tcp://' + address


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join the torch.distributed job when one is configured; returns True
    when distributed mode was activated.

    The arguments, else ``JAX_COORDINATOR_ADDRESS`` (or
    ``COORDINATOR_ADDRESS``), ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``;
    with no address it is a no-op that returns False, as the JAX
    package's. torch has no cluster autodetection, so an address without
    the process count and this process's id raises."""
    if coordinator_address is None:
        # NB: MEGASCALE_COORDINATOR_ADDRESS is deliberately NOT consulted,
        # as in the JAX package: it names libtpu's DCN transport endpoint
        coordinator_address = next(
            (os.environ[k] for k in
             ('JAX_COORDINATOR_ADDRESS', 'COORDINATOR_ADDRESS')
             if os.environ.get(k)), None)
        if coordinator_address is None:
            return False
    if num_processes is None and os.environ.get('JAX_NUM_PROCESSES'):
        num_processes = int(os.environ['JAX_NUM_PROCESSES'])
    if process_id is None and os.environ.get('JAX_PROCESS_ID'):
        process_id = int(os.environ['JAX_PROCESS_ID'])
    if num_processes is None or process_id is None:
        raise ValueError(
            'a distributed job at %s needs num_processes and process_id '
            '(train_args.distributed or JAX_NUM_PROCESSES/JAX_PROCESS_ID): '
            'torch.distributed detects no cluster' % coordinator_address)
    dist = _dist()
    if dist.is_initialized():
        return True
    dist.init_process_group(
        'gloo', init_method=_init_method(str(coordinator_address)),
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def active() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The job's processes (its devices: one a rank); 1 outside a job."""
    return _dist().get_world_size() if active() else 1


def process_index() -> int:
    return _dist().get_rank() if active() else 0


def is_coordinator() -> bool:
    return process_index() == 0


def global_mesh(model_parallel: int = 1):
    """The mesh over every rank of the job."""
    from .mesh import make_mesh
    return make_mesh(model_parallel=model_parallel)


def rank_device(device) -> torch.device:
    """The device this rank runs on: 'cuda' is card ``process_id %
    device_count``, an explicit 'cuda:i' wins, 'cpu' stays (every rank on
    the host, over gloo). Raises, as ``model.resolve_device``, for a card
    torch cannot see."""
    from ..model import resolve_device
    dev = resolve_device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', process_index() % torch.cuda.device_count())
    return dev


def select_backend(device: torch.device) -> str:
    """Pick (and remember) the group of the update step's collective for
    ``device``'s tensors: 'gloo' on the host, 'nccl' when every rank has
    a card of its own, 'gloo' staged through the host when ranks share a
    card. A collective call with the ranks' device UUIDs over the host
    group (every rank must call it). Returns the backend's name."""
    dist = _dist()
    if device.type != 'cuda':
        _STATE.update(backend='gloo', group=None, reason='host tensors')
        return 'gloo'
    uuid = str(torch.cuda.get_device_properties(device).uuid)
    uuids: List[Optional[str]] = [None] * process_count()
    dist.all_gather_object(uuids, uuid)
    if len(set(uuids)) == len(uuids):
        _STATE.update(backend='nccl', group=dist.new_group(backend='nccl'),
                      reason='a card a rank')
    else:
        _STATE.update(backend='gloo', group=None,
                      reason='ranks share a card: staged through the host')
    return _STATE['backend']


def collective_backend() -> str:
    """The backend :func:`select_backend` chose ('gloo' before it ran)."""
    return _STATE['backend'] or 'gloo'


def collective_group():
    """The process group of the update step's collective (None: the
    default, host group)."""
    return _STATE['group']


def backend_reason() -> str:
    return _STATE['reason']


def agree_any(flags: Sequence[bool]) -> List[bool]:
    """Each flag ORed over the ranks (one collective on the host group):
    how the ranks take a decision that ends or pauses their loop at the
    same dispatch. The flags unchanged outside a job."""
    if process_count() <= 1:
        return [bool(f) for f in flags]
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32)
    _dist().all_reduce(t, op=_dist().ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def all_gather_host(arr: np.ndarray) -> List[np.ndarray]:
    """Every rank's ``arr`` (one shape and dtype on every rank), in rank
    order, over the host group."""
    if process_count() <= 1:
        return [arr]
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(process_count())]
    _dist().all_gather(out, t)
    return [o.numpy() for o in out]


def all_gather_object(obj) -> list:
    """Every rank's picklable ``obj``, in rank order, over the host group."""
    if process_count() <= 1:
        return [obj]
    out = [None] * process_count()
    _dist().all_gather_object(out, obj)
    return out


def broadcast_object(obj=None, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled, over the host
    group)."""
    if process_count() <= 1:
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


def shutdown() -> None:
    """Leave the job (every exit path of a learner calls it)."""
    _STATE.update(backend=None, group=None, reason='')
    if active():
        _dist().destroy_process_group()
