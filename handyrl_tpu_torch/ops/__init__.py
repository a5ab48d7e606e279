"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``geese_trunk``: K1 and K2; ``targets``: K3-K5), their nvcc build
(``cuda_build``), the launch counts (``launches``), and the code around
them on the update step (``losses``, ``train_step``).

:func:`kernel_launches` reads every kernel's launch count, summed over the
paths (``launches.path``) or of one; :func:`reset_kernel_launches` sets them
all to 0, and :func:`add_kernel_launches` adds to the calling thread's path
(a CUDA graph's replays, which launch kernels without their wrappers)."""

from typing import Dict, Mapping, Optional

from . import launches


def kernel_launches(path: Optional[str] = None) -> Dict[str, int]:
    """Launches of each CUDA kernel of the port in this process, by name:
    summed over every path, or of ``path`` alone."""
    return launches.totals(path)


def reset_kernel_launches() -> None:
    launches.reset()


def add_kernel_launches(counts: Mapping[str, int]) -> None:
    """Add ``counts`` (by the names :func:`kernel_launches` gives) to the
    calling thread's path."""
    launches.add(counts)
