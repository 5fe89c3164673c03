"""Ops of the port: plain PyTorch versions for CPU tensors, hand-written CUDA
kernels (``csrc/``) for CUDA tensors where the JAX package had a Pallas
kernel."""
