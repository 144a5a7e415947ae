"""Hand-written CUDA kernels of the port, their builds and their drivers."""
