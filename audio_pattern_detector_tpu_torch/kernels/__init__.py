"""Hand-written CUDA kernels of the port: build, load and bind."""
