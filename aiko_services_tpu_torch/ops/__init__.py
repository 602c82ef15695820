"""Ops with hand-written CUDA kernels for Hopper and their plain PyTorch
versions (the CPU path and the oracles the kernels are held against)."""
