"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``geese_trunk``: K1 and K2; ``targets``: K3-K5), their nvcc build
(``cuda_build``), and the code around them on the update step (``losses``,
``train_step``).

:func:`kernel_launches` is the one place that reads every kernel's launch
count; :func:`reset_kernel_launches` sets them all to 0, and
:func:`add_kernel_launches` adds to them (a CUDA graph's replays, which
launch kernels without their wrappers)."""

from typing import Dict, Mapping

from . import geese_trunk, targets


def kernel_launches() -> Dict[str, int]:
    """Launches of each CUDA kernel of the port in this process, by name."""
    return {'geese_trunk': geese_trunk.launches,
            'geese_trunk_bwd': geese_trunk.backward_launches,
            **targets.launches}


def reset_kernel_launches() -> None:
    geese_trunk.launches = 0
    geese_trunk.backward_launches = 0
    for name in targets.launches:
        targets.launches[name] = 0


def add_kernel_launches(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (by the names :func:`kernel_launches` gives) to the
    kernels' launch counts."""
    for name, n in counts.items():
        if name == 'geese_trunk':
            geese_trunk.launches += n
        elif name == 'geese_trunk_bwd':
            geese_trunk.backward_launches += n
        else:
            targets.launches[name] += n
