"""Hand-written CUDA kernels for Hopper (``csrc/``) and their wrappers.

Each wrapper takes CUDA tensors only and launches its kernel; given a CPU
tensor it raises ``ValueError`` before the library is built. The choice
between a kernel and its plain PyTorch version is made above this layer,
once per stage (``backend="torch"`` runs the plain versions). ``_build``
compiles the sources at first launch and keeps the launch counts.
"""
