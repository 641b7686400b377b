"""Hand-written CUDA wire kernels, their plain PyTorch versions, and the
device dispatch between them (``ops``)."""
