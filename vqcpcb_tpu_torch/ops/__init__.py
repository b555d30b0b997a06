"""Ops of the port: plain PyTorch modules and the wrappers of the CUDA kernels."""
