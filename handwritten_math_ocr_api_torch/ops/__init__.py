"""Hand-written CUDA kernels of the port, each beside its plain version.

Every wrapper launches its kernel for CUDA tensors and counts the launch in
its ``launches`` attribute; for CPU tensors it runs the plain PyTorch
version. The kernels are built from ``csrc/`` at first use (``_build``).
"""
