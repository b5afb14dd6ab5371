"""Hand-written CUDA kernels for the CMM hot task (ADDMUL) and their plain
PyTorch versions."""
