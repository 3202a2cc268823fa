"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers.

Each wrapper takes the plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (never falling back). ``_build`` compiles the
sources at first use and keeps the launch counts.
"""
