"""PyTorch/CUDA port of the CMM engine (the JAX package ``repro`` is its
reference): lazy ``ClusteredMatrix`` expressions planned on the host and
executed on one CUDA device, with the ADDMUL tiles in a hand-written
kernel (``kernels/csrc/addmul.cu``)."""
