"""handyrl_tpu_torch: the PyTorch and CUDA port of handyrl_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and nothing of ``jax``, ``flax`` or ``handyrl_tpu``; where it needs
code from the JAX package it keeps its own copy. Module names mirror
``handyrl_tpu`` so each counterpart is easy to find. Ported so far: serving
Hungry Geese moves from GeeseNet (``python -m handyrl_tpu_torch.serving``),
GeeseNet's update step (``ops/losses.py``, ``ops/train_step.py``, timed by
``python -m handyrl_tpu_torch.bench``), the local learner that trains
it, or TicTacToe's ``SimpleConv2dModel`` and ConnectX's ``ConnectFourNet``
turn-based, or Hungry Geese's recurrent ``GeeseNetLSTM`` with burn-in, by
self-play (``python -m handyrl_tpu_torch.train``: the host learner, the
device loops, the worker plane), and the offline tournament of a
checkpoint (``python -m handyrl_tpu_torch.evaluation``). The trunk's forward and backward and the
target recursions are hand-written CUDA kernels (``ops/`` wrappers,
``csrc/`` sources). Entry points run on the CUDA device unless the caller
passes ``device='cpu'``.
"""

__version__ = "0.1.0"

# Runtime concurrency sanitizer (analysis/sanitizer.py): opt-in via
# HANDYRL_TPU_SANITIZE=1. It must install BEFORE any lock or thread of the
# package exists, which is import time; unset (the default) this is one
# env check and the package import stays free of side effects.
import os as _os
if _os.environ.get('HANDYRL_TPU_SANITIZE', '').strip().lower() \
        not in ('', '0', 'false', 'off'):
    from .analysis import sanitizer as _sanitizer
    _sanitizer.install_from_env()
