"""handyrl_tpu_torch: the PyTorch and CUDA port of handyrl_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and nothing of ``jax``, ``flax`` or ``handyrl_tpu``; where it needs
code from the JAX package it keeps its own copy. Module names mirror
``handyrl_tpu`` so each counterpart is easy to find. Ported so far: serving
Hungry Geese moves from GeeseNet (``python -m handyrl_tpu_torch.serving``),
GeeseNet's update step (``ops/losses.py``, ``ops/train_step.py``, timed by
``python -m handyrl_tpu_torch.bench``), and the local learner that trains
it by batched self-play (``python -m handyrl_tpu_torch.train``). The
trunk's forward and backward and the target recursions are hand-written
CUDA kernels (``ops/`` wrappers, ``csrc/`` sources). Entry points run on the CUDA device unless the caller
passes ``device='cpu'``.
"""

__version__ = "0.1.0"
