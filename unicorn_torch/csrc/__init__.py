"""Hand-written CUDA kernels of the port and their nvcc builder."""
