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
from typing import (Callable, Dict, Iterable, Mapping, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import torch

__all__ = ["CudaKernel", "build_all", "check_operand", "check_aligned",
           "kernel_per_dtype", "dense_kernels", "check_dense", "check_heads",
           "scale_pointers", "kernel_chunk", "recurrence_plan",
           "RecurrencePlan", "resolve_impl",
           "BUILD_DIR", "NVCC_FLAGS", "POOL_DTYPES", "DENSE_DTYPES",
           "HEAD_DIMS", "IMPLS"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


#: a wrapper's ``impl``: the kernel, the plain version, or by device
IMPLS = ("auto", "torch", "cuda")


def resolve_impl(impl: str, x) -> str:
    """``impl`` itself, or for ``"auto"`` the kernel (``"cuda"``) when
    ``x`` lies on a CUDA device and the plain version (``"torch"``)
    otherwise; ValueError for an unknown name."""
    if impl not in IMPLS:
        raise ValueError(f"unknown kernel impl {impl!r}; expected {IMPLS}")
    if impl != "auto":
        return impl
    return "cuda" if x.is_cuda else "torch"


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
        self._check(self.symbol, self._entry()(*args))
        self.launches += 1

    def query(self, symbol: str, argtypes: Sequence, *args) -> None:
        """Call another C function of this kernel's library, one that
        launches nothing (an occupancy query, say): nothing is counted;
        raises on a CUDA error as :meth:`launch` does."""
        self._entry()
        fn = getattr(self._lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        self._check(symbol, fn(*args))

    def _check(self, symbol: str, err: int) -> None:
        if err != 0:
            msg = self._lib.repro_cuda_error_string(err).decode()
            raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")


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


def _source_of(source: Union[str, Mapping[torch.dtype, str]],
               dt: torch.dtype) -> str:
    return source if isinstance(source, str) else source[dt]


def kernel_per_dtype(source: Union[str, Mapping[torch.dtype, str]],
                     stem: str,
                     argtypes: Sequence) -> Dict[torch.dtype, CudaKernel]:
    """One :class:`CudaKernel` per pool dtype over the entry points
    ``{stem}_bf16``, ``_int8`` and ``_fp8`` of ``source``, one file or a
    file per dtype.  ``argtypes`` are the bf16 entry point's; the
    quantized ones take two more pointers, ``k_scales`` and
    ``v_scales``, after the first three (q, k_pages, v_pages)."""
    p = ctypes.c_void_p
    scaled = list(argtypes[:3]) + [p, p] + list(argtypes[3:])
    return {dt: CudaKernel(_source_of(source, dt), f"{stem}_{sfx}",
                           argtypes if dt == torch.bfloat16 else scaled)
            for dt, sfx in _SUFFIX.items()}


#: operand types of the dense kernels (AMU matmul, dense flash and
#: decode attention), one entry point each
DENSE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def dense_kernels(source: Union[str, Mapping[torch.dtype, str]], stem: str,
                  argtypes: Sequence) -> Dict[torch.dtype, CudaKernel]:
    """One :class:`CudaKernel` per dense dtype over the entry points
    ``{stem}_f32`` and ``{stem}_bf16`` of ``source``, one file or a file
    per dtype; both take the same arguments."""
    return {dt: CudaKernel(_source_of(source, dt), f"{stem}_{sfx}", argtypes)
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


#: the recurrence kernels (csrc/ssm_chunks.cuh): rows of a sub-chunk
#: (the mma's M), the most rows of a piece, threads of the state scan
SUB_ROWS, MAX_PIECE_ROWS, SCAN_THREADS = 16, 128, 256
#: an H100's shared memory: what a block may opt in to, and an SM's (each
#: resident block reserves 1 KiB of it)
SMEM_OPTIN, SMEM_SM, SMEM_RESERVED = 232448, 233472, 1024
#: an H100's L2, and the share of it a recurrence's workspace keeps to
L2_BYTES = 50 * 2**20
WORKSPACE_BUDGET = 3 * L2_BYTES // 4
#: waves of (C) blocks, two an SM, a recurrence plan keeps where it can
#: (``tools/ssm_sweep.py``: fewer blocks of longer segments were faster
#: down to about 1.5 waves at rwkv6-7b's and zamba2-1.2b's widths)
PLAN_WAVES = 1.5


class RecurrencePlan(NamedTuple):
    """How a recurrence kernel (wkv6, ssd) cuts its sequence: pieces of
    ``rows`` rows (the chunk or a divisor of it) in sub-chunks of ``sub``,
    segments of ``seg`` pieces; the blocks of its three kernels, (A) the
    segments' states (and ssd's C B^T blocks), (B) the state scan, (C)
    the outputs; its workspace; the shared memory of its largest block."""
    sub: int
    rows: int
    seg: int
    segments: int
    blocks: Tuple[int, int, int]
    workspace_bytes: int
    smem_bytes: int


def _round16(n: int) -> int:
    return -(-n // SUB_ROWS) * SUB_ROWS


def recurrence_plan(name: str, T: int, c: int, bh: int, sms: int,
                    smem_of: Callable[[int, bool, bool], int],
                    state: Tuple[int, int, int],
                    extra: Callable[[int], Tuple[int, int]],
                    *, smem_limit: int = SMEM_OPTIN,
                    rows: Optional[int] = None,
                    seg: Optional[int] = None) -> RecurrencePlan:
    """The plan of a recurrence kernel over T rows in chunks of ``c``
    (``kernel_chunk``) for ``bh`` (batch row, head) pairs on ``sms`` SMs.
    ``smem_of(cp, outputs, update)`` is a block's shared memory at cp
    padded rows (the source's ``Layout``): of (C) with ``outputs``, of
    (A) without; ``update``: the block carries the state past a piece.
    ``state``: a segment's state per pair, (rows, columns, log decays);
    ``extra(rows)``: workspace floats and (A) blocks that do not depend
    on the segments (ssd's C B^T).  Pieces: c, c/2, c/4, ... (at most
    :data:`MAX_PIECE_ROWS`) whose (C) block leaves room for two on an SM
    (else one that fits ``smem_limit``): the longest whose (C) blocks
    number :data:`PLAN_WAVES` times two an SM, else the shortest of 32
    rows or more (a short sequence: shorter pieces, more blocks).
    Segments: the most pieces a segment that still give that many (C)
    blocks, within :data:`WORKSPACE_BUDGET`, else the fewest that fit it.
    ``rows`` / ``seg`` force either; ValueError where nothing fits."""
    half = SMEM_SM // 2 - SMEM_RESERVED
    enough = PLAN_WAVES * 2 * sms
    if rows is None:
        cands = [c >> m for m in range(c.bit_length())
                 if c % (1 << m) == 0 and (c >> m) <= MAX_PIECE_ROWS
                 and ((c >> m) >= SUB_ROWS or m == 0)]
        fits = [r for r in cands
                if smem_of(_round16(r), True, False) <= smem_limit]
        two = [r for r in fits if smem_of(_round16(r), True, False) <= half]
        if not fits:
            raise ValueError(f"{name} kernel: no piece of the chunk {c} "
                             f"fits {smem_limit} bytes of shared memory")
        fits = two or fits
        full = [r for r in fits if bh * (T // r) >= enough]
        rows = (full[0] if full
                else min((r for r in fits if r >= 32), default=fits[-1]))
    if rows <= 0 or rows > MAX_PIECE_ROWS or c % rows:
        raise ValueError(f"{name} kernel: {rows} rows a piece do not "
                         f"divide the chunk {c}")
    pieces = T // rows
    extra_floats, extra_blocks = extra(rows)
    state_floats = state[0] * state[1] + state[2]

    def workspace(s: int) -> int:
        return 4 * (extra_floats + bh * (pieces // s - 1) * state_floats)

    if seg is None:
        splits = [1 << m for m in range(pieces.bit_length())
                  if pieces % (1 << m) == 0]
        within = [s for s in splits if workspace(s) <= WORKSPACE_BUDGET]
        seg = max((s for s in within if bh * (pieces // s) >= enough),
                  default=within[0] if within else pieces)
    if seg <= 0 or pieces % seg:
        raise ValueError(f"{name} kernel: {seg} pieces a segment do not "
                         f"divide the {pieces} pieces")
    segments = pieces // seg
    cp = _round16(rows)
    smem = smem_of(cp, True, seg > 1)
    if segments > 1:
        smem = max(smem, smem_of(cp, False, True))
    if smem > smem_limit:
        raise ValueError(f"{name} kernel: a piece of {rows} rows needs "
                         f"{smem} bytes of shared memory")
    scan = -(-bh * state[0] * state[1] // 4 // SCAN_THREADS)
    return RecurrencePlan(
        sub=SUB_ROWS, rows=rows, seg=seg, segments=segments,
        blocks=(extra_blocks + bh * (segments - 1),
                scan if segments > 1 else 0, bh * segments),
        workspace_bytes=workspace(seg), smem_bytes=smem)


def scale_pointers(k_scales, v_scales, device) -> tuple:
    """The pointers of the (N, Hkv) f32 scale operands of a quantized
    pool, checked as :func:`check_operand` does; () for a bf16 pool."""
    if k_scales is None:
        return ()
    check_operand("k_scales", k_scales, torch.float32, 2, device)
    check_operand("v_scales", v_scales, torch.float32, 2, device)
    return k_scales.data_ptr(), v_scales.data_ptr()


def check_aligned(**tensors) -> None:
    """Raise ValueError unless every tensor's data starts on a 16-byte
    boundary, as a TMA tensor map's base and a 16-byte copy need."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


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
