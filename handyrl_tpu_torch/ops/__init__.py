"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``geese_trunk``), and their nvcc build (``cuda_build``)."""
