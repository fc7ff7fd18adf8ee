"""Hand-written CUDA kernels, their builder and their plain PyTorch versions."""
