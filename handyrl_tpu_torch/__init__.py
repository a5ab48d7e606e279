"""handyrl_tpu_torch: the PyTorch and CUDA port of handyrl_tpu.

A second package beside the JAX one, which stays the reference. It imports
``torch`` and nothing of ``jax``, ``flax`` or ``handyrl_tpu``; where it needs
code from the JAX package it keeps its own copy. Module names mirror
``handyrl_tpu`` so each counterpart is easy to find. The slice ported so far
serves Hungry Geese moves from GeeseNet (``python -m
handyrl_tpu_torch.serving``), with the trunk's forward as a hand-written
CUDA kernel (``ops/geese_trunk.py``, ``csrc/geese_trunk.cu``). Entry points
run on the CUDA device unless the caller passes ``device='cpu'``.
"""

__version__ = "0.1.0"
