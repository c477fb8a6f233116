"""Hand-written CUDA kernels for Hopper, their build, and their plain
PyTorch versions."""
