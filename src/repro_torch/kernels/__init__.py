"""Attention kernels of the serving path: hand-written CUDA for Hopper,
each beside its plain PyTorch version (see :mod:`repro_torch.kernels.ops`).

Importing this package loads no library and calls no compiler: a kernel
is built from ``csrc/`` the first time it launches.
"""
