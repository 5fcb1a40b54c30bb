"""Build and bind the port's hand-written CUDA kernels.

Each source in ``csrc/`` exports plain C entry points.  It is compiled
with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) the
first time a wrapper launches it, and loaded with ``ctypes``.  The file
name carries a digest of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header builds anew and an
unchanged one is reused.  A source may export several entry points (one
per pool element type), each its own :class:`CudaKernel` over the one
library.  :func:`build_all` starts one ``nvcc`` per source at once and
waits for all of them.

Importing this module runs nothing: no compiler, no CUDA call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

__all__ = ["CudaKernel", "build_all", "check_operand", "kernel_per_dtype",
           "dense_kernels", "check_dense", "check_heads", "scale_pointers",
           "kernel_chunk", "state_slice", "BUILD_DIR", "NVCC_FLAGS",
           "POOL_DTYPES", "DENSE_DTYPES", "HEAD_DIMS"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use")
    return str(path)


class CudaKernel:
    """One C entry point of one ``csrc/*.cu`` source.

    ``launch(*args)`` calls the entry point, raises if it returns a CUDA
    error, and only then adds one to ``launches`` — the count a run reads
    to show that its main path went through this kernel.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._lib = None

    @property
    def name(self) -> str:
        return self.symbol

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        digest = h.hexdigest()
        return BUILD_DIR / f"{self.source.stem}-{digest[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this source unless its library exists."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.tmp_path = tmp            # renamed into place by finish_build
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} "
                f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(proc.tmp_path, self.library_path())

    def _entry(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err_str = lib.repro_cuda_error_string
            err_str.argtypes = [ctypes.c_int]
            err_str.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        err = self._entry()(*args)
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def build_all(kernels: Iterable[CudaKernel]) -> float:
    """Build every kernel's library in parallel (one ``nvcc`` per
    source, all started together; entry points of one source share its
    build and its log); return the wall seconds taken."""
    t0 = time.perf_counter()
    kernels = list(kernels)
    started: Dict[Path, Tuple[CudaKernel, Optional[subprocess.Popen]]] = {}
    for k in kernels:
        path = k.library_path()
        if path not in started:
            started[path] = (k, k.start_build())
    for k, proc in started.values():
        k.finish_build(proc)
    for k in kernels:
        k.build_log = started[k.library_path()][0].build_log
    return time.perf_counter() - t0


#: pool element types with an entry point: bf16, and the int8 / fp8
#: (e4m3) frames of a quantized pool
POOL_DTYPES = (torch.bfloat16, torch.int8, torch.float8_e4m3fn)
_SUFFIX = {torch.bfloat16: "bf16", torch.int8: "int8",
           torch.float8_e4m3fn: "fp8"}


def kernel_per_dtype(source: str, stem: str,
                     argtypes: Sequence) -> Dict[torch.dtype, CudaKernel]:
    """One :class:`CudaKernel` per pool dtype over ``source``'s entry
    points ``{stem}_bf16``, ``_int8`` and ``_fp8``.  ``argtypes`` are the
    bf16 entry point's; the quantized ones take two more pointers,
    ``k_scales`` and ``v_scales``, after the first three (q, k_pages,
    v_pages)."""
    p = ctypes.c_void_p
    scaled = list(argtypes[:3]) + [p, p] + list(argtypes[3:])
    return {dt: CudaKernel(source, f"{stem}_{sfx}",
                           argtypes if dt == torch.bfloat16 else scaled)
            for dt, sfx in _SUFFIX.items()}


#: operand types of the dense kernels (AMU matmul, dense flash and
#: decode attention), one entry point each
DENSE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def dense_kernels(source: str, stem: str,
                  argtypes: Sequence) -> Dict[torch.dtype, CudaKernel]:
    """One :class:`CudaKernel` per dense dtype over ``source``'s entry
    points ``{stem}_f32`` and ``{stem}_bf16``, which take the same
    arguments."""
    return {dt: CudaKernel(source, f"{stem}_{sfx}", argtypes)
            for dt, sfx in DENSE_DTYPES.items()}


def check_dense(name: str, q, k, v) -> None:
    """Raise unless q, k and v are contiguous CUDA tensors of one dense
    dtype, q (B, ..., D) and k, v (B, Skv, Hkv, D) of its batch and
    head dim — what the dense attention kernels take."""
    if not q.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if q.dtype not in DENSE_DTYPES:
        raise TypeError(f"q has dtype {q.dtype}, expected one of "
                        f"{tuple(DENSE_DTYPES)}")
    check_operand("q", q, q.dtype, q.dim(), q.device)
    check_operand("k", k, q.dtype, 4, q.device)
    check_operand("v", v, q.dtype, 4, q.device)
    if v.shape != k.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[-1]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")


#: head dims with an instance in every attention kernel (paged decode,
#: prefill and verify, dense flash and decode): those of the registered
#: configs, full and SMOKE
HEAD_DIMS = (16, 32, 64, 80, 128)


def check_heads(num_heads: int, num_kv_heads: int, head_dim: int) -> None:
    """Raise unless the attention kernels take these heads: query heads
    in equal groups over the KV heads (any group size G), and a head dim
    in :data:`HEAD_DIMS`."""
    if num_kv_heads <= 0 or num_heads % num_kv_heads:
        raise ValueError(f"{num_heads} query heads do not form equal groups "
                         f"over {num_kv_heads} KV heads")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"unsupported head_dim {head_dim} (head_dim "
                         f"{HEAD_DIMS})")


def kernel_chunk(name: str, T: int, chunk: int) -> int:
    """The chunk a recurrence kernel (wkv6, ssd) runs, ``min(chunk, T)``;
    ValueError unless it divides T, as the TPU kernels assert (the plain
    versions pad instead)."""
    c = min(chunk, T)
    if c <= 0 or T % c:
        raise ValueError(f"{name} kernel: T = {T} is not a multiple of the "
                         f"chunk {c} (the plain version pads)")
    return c


def state_slice(cols: int, blocks: int, sms: int, least: int = 16) -> int:
    """State columns per block of a recurrence kernel: ``cols`` over the
    most slices (powers of two, each at least ``least`` columns wide) that
    keep ``blocks * slices`` within one wave of ``sms`` SMs."""
    n = 1
    while blocks * 2 * n <= sms and cols % (2 * n) == 0 \
            and cols // (2 * n) >= least:
        n *= 2
    return cols // n


def scale_pointers(k_scales, v_scales, device) -> tuple:
    """The pointers of the (N, Hkv) f32 scale operands of a quantized
    pool, checked as :func:`check_operand` does; () for a bf16 pool."""
    if k_scales is None:
        return ()
    check_operand("k_scales", k_scales, torch.float32, 2, device)
    check_operand("v_scales", v_scales, torch.float32, 2, device)
    return k_scales.data_ptr(), v_scales.data_ptr()


def check_operand(name: str, t, dtype, ndim: int, device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-d ``dtype`` tensor on
    ``device`` — what a kernel's raw pointer arithmetic assumes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
