"""Kernels of the port: hand-written CUDA for Hopper, each beside its
plain PyTorch version (see :mod:`repro_torch.kernels.ops`): the paged
attention kernels of the serving path, and the kernel-level entry points
``matmul`` (the AMU matmul), dense ``flash_attention`` and dense
``decode_attention``, ``paged_decode_attention``, the chunked linear
recurrences ``wkv6`` (RWKV-6) and ``ssd`` (Mamba2), and the indexed row
gather ``gather_rows`` (with ``moe_gather.gather_blocks``), as the JAX
package exports them.

Importing this package loads no library and calls no compiler: a kernel
is built from ``csrc/`` the first time it launches.
"""

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (decode_attention, flash_attention,
                                     gather_rows, matmul,
                                     paged_decode_attention, ssd, wkv6)

__all__ = ["ops", "ref", "matmul", "flash_attention", "decode_attention",
           "paged_decode_attention", "wkv6", "ssd", "gather_rows"]
