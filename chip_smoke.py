"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ``repro_torch`` only (nothing of JAX or of the ``repro`` package):

1. builds the three CUDA kernels of the serving path (paged decode,
   paged prefill, paged verify), each with its three entry points (bf16
   pool, int8 and fp8 frames of the quantized pool), and the five of
   the kernel-level entry points (AMU matmul, dense flash attention,
   dense decode attention, and the RWKV-6 and Mamba2 recurrences wkv6
   and ssd), each with an f32 and a bf16 entry point,
   from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for ``sm_90a``,
   one compiler per source, started together, and prints each source's
   registers and spills per element type (``-Xptxas -v``);
2. holds each instance against its plain PyTorch version on the card at
   the main path's shapes (H=24, Hkv=8, D=128, page 16; a bf16 pool, then
   int8 and fp8 pools quantized from the same kind of normal draw with
   per-(frame, KV head) absmax scales): decode at B=8 with ragged lengths
   1..2048, prefill at C=2, T=256 with ragged offsets and lengths, verify
   at B=8, S=5 (K=4) with per-row lengths 1..2048 that straddle pages.
   Every element must agree within atol 4e-3 + rtol 1e-2 (one bf16 step
   at any magnitude, four times the largest error measured on an H100),
   and every output row of D values within a relative L2 error of 1e-2,
   which a skipped or repeated page of even the longest row exceeds
   several times.  It times kernel and plain version with CUDA events
   (and, for bf16, ``scaled_dot_product_attention`` on the gathered view,
   a yardstick only; no single library call takes a quantized pool with
   its scales), and computes each instance's bound from these inputs
   (1-byte K/V and the scales read for a quantized pool).  Verify row s
   must be bitwise the decode kernel of the same element type at
   ``lengths[:, s]`` (both are one template);
2d. holds each kernel-level entry point (``ops.matmul``,
   ``ops.flash_attention``, ``ops.decode_attention``, ``ops.wkv6``,
   ``ops.ssd``, f32 and bf16) against its plain version on the card: in
   bf16 at phi4-mini-3.8b's full-width shapes — the MLP's gate/up
   (512 x 3072 @ 3072 x 8192, two 256-token prefill chunks) and down
   (512 x 8192 @ 8192 x 3072) products, causal attention over one
   2048-token prompt (24/8 heads of 128) and over a 256-token chunk at
   offset 1792, decode of 8 sequences over 2000 of 2048 cached positions
   — within the bars of phase 2; in f32 at the quickstart's product
   (256 x 512 @ 512 x 256, 128^3 tiles) and the reference benchmark's
   attention shapes (``benchmarks/run.py:490-499``) within the
   reference's own bar, max |err| / max |ref| < 5e-6.  Then the shapes
   that only the repaired wrappers and kernels take: f32 1024^3 with no
   tiles (the reference's plan, run as sub-tiles), and the attention
   kernels at the heads of other registered configs — dense flash and
   decode, paged decode and verify at G = 5 (llama4, 40/8), G = 12
   (command-r-plus, 96/8) and D = 80 (h2o-danube, 32/8), paged prefill
   at D = 80 — at the phase-2 bars, verify row s bitwise the decode
   kernel.  Then wkv6 and ssd at the reference benchmark's f32 shapes
   (``benchmarks/run.py:500-511``: B1 T256 H2 K64, and P64 N64, chunk
   64) within its kernel-vs-chunked bar, < 1e-5, and within 1e-4 of the
   sequential oracles (``tests/test_kernels.py:117-158``), and in bf16
   at rwkv6-7b's full width (64 heads of K = V = 64, T = 2048, chunk 64)
   and zamba2-1.2b's Mamba2 layer (64 heads of P = 64, N = 64, T = 2048,
   chunk 128), decay inputs in f32, within the bars of phase 2.  It
   times kernel, plain version and a library yardstick where one
   PyTorch call computes the function (``torch.matmul``,
   ``scaled_dot_product_attention``; none computes WKV6 or SSD) and
   computes each case's bound (f32 operations at the card's FP32
   CUDA-core rate: TF32 is off);
3. serves 12 requests (prompts of 512-1536 tokens, 32 new tokens each)
   on ``phi4-mini-3.8b`` at full width with random weights from a seeded
   generator, through the port's ``Engine``: FUSED role, paging and
   chunked prefill on, watermark policy, and a device pool of 448 pages,
   under half of ``max_batch * pages_per_seq``, so the pager parks and
   resumes pages.
   It asserts that every request finishes with its token count, that
   the decode and prefill kernels launched in that run, that the pager
   preempted and resumed, and that a run whose pool needs no preemption
   gives the same tokens; it prints throughput, TTFT, memory and a
   sha256 of the tokens;
3q. serves the same requests with the quantized pool (``kv_quant`` int8,
   then fp8) on the same 448 frames: every request finishes with its
   token count, the decode and prefill instances of the pool's element
   type launched, the pager preempted and resumed, and the bytes it
   parked are the frames it wrote back times the quantized frame's
   bytes; an int8 run on a roomy pool must give the preempting int8
   run's tokens.  It prints throughput, TTFT, peak memory, pool bytes and
   the share of tokens equal to phase 3's, and runs int8 once more on
   the frames that the bf16 pool's bytes buy (894), printing its
   preemptions beside phase 3's;
4. serves the same requests twice more with speculative verify-K decode
   (K=4) on the same pool: (a) with an oracle proposer that drafts the
   run of phase 3's own tokens, (b) with a proposer whose drafts never
   match, so every verify step rolls back.  Each run must finish every
   request with its token count, balance its speculation counters,
   pass ``check_invariants`` and launch the verify kernel; (b) must
   accept nothing.  It prints throughput, TTFT, step counts, and the
   share of tokens equal to phase 3's (for (a), the oracle drafts that
   were rejected mark where verify and decode logits chose another
   argmax); then it serves phase 3's configuration once more, warm, for
   a throughput free of the process's warm-up;
4q. serves the never-matching drafts on the int8 and the fp8 pool: the
   counters balance, the pool's verify instance launched, the pager
   preempted and resumed;
5. checks one prefill chunk, one decode step and one verify step at full
   width over 8 rows (the engine's batch): kernels against plain
   versions on the same cache, finite logits of the right shape within
   a relative error; verify row s against the s-th of five sequential
   decode steps (relative error, and the same argmax wherever the
   decode step's top-2 margin exceeds twice their largest difference);
   and, for the pieces of a layer, the largest difference between 40
   rows and 8 rows of the same input;
6. runs the kernel-level entry points as a user calls them: the port's
   quickstart (``repro_torch.launch.quickstart``) on the card — part 1's
   runtime-AMU counts must equal a CPU run's, part 2 must go through the
   f32 AMU matmul kernel within 5e-6 of ``x @ w`` — then each case of
   phase 2d once through ``ops`` with the default ``impl``, whose output
   must be bitwise phase 2d's kernel output.  Every kernel-level entry
   point (the ten of matmul, flash, decode, wkv6 and ssd) must launch in
   this phase.

It prints the card's name and power limit first, then the lines of each
phase, then ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero before any result.

``--profile-out PATH`` adds one more engine run of phase 3, one of
phase 4's oracle run and one of phase 3q's int8 run under
``torch.profiler`` and prints where their device time went (attention
kernels, matrix products, copies, the rest) and the device's busy share
of the profiled wall time; the per-kernel tables go to PATH and to PATH
with ``-spec`` and ``-int8`` added to its stem, sorted by device time
and then by host time.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import amu_matmul as mm_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.kv_quant import KVQuantConfig, quantize  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.models.layers import (dense, rms_norm, swiglu,  # noqa: E402
                                       unembed)
from repro_torch.models.model import (cast_params, decode_step,  # noqa: E402
                                      init_paged_cache, init_params,
                                      prefill_chunk, verify_step)
from repro_torch.serve.config import (ChunkingConfig, EngineConfig,  # noqa: E402
                                      PagingConfig, SchedulerConfig,
                                      SpeculationConfig)
from repro_torch.serve.engine import Engine  # noqa: E402

# the kernel modules by name: the package's attributes of these names are
# the ops entry points, as in the JAX package
dec_mod = import_module("repro_torch.kernels.decode_attention")
pre_mod = import_module("repro_torch.kernels.flash_attention")

H, HKV, D, PAGE = 24, 8, 128, 16
ATOL, RTOL = 4e-3, 1e-2          # per element, on bf16 outputs
ROW_TOL = 1e-2                   # relative L2 error of each output row
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor rate
FP32_FLOPS = 67e12               # H100 SXM f32 on the CUDA cores (no TF32)
F32_TOL = 5e-6                   # max |err| / max |ref|, the reference's bar
ARCH = "phi4-mini-3.8b"
# 448 of the 8 * 128 pages a roomy pool would need (0.875 GiB of bf16 KV):
# at 512 this load preempted once, at 448 four times (CPU rehearsal at
# the smoke width with full-width page bytes; scheduling does not depend
# on the model's numbers)
ENGINE = dict(max_batch=8, max_len=2048, page_size=16, device_pages=448,
              chunk_tokens=256, chunk_slots=2)
N_REQUESTS, PROMPT_RANGE, NEW_TOKENS = 12, (512, 1536), 32
SPECULATE_K = 4
SEED = 0
#: pool element types: bf16 ("none") and the quantized pool's frames
MODES = ("none", "int8", "fp8")
QUANT_MODES = ("int8", "fp8")


def require(ok, msg: str) -> None:
    """A failed check ends the run with an error (unlike ``assert``,
    this survives ``python -O``)."""
    if not ok:
        raise RuntimeError(msg)


def tokens_digest(out) -> str:
    """sha256 of an engine run's tokens, ``{rid: [token, ...]}``: phase
    3 prints it, so the bf16 path of two trees can be compared."""
    flat = json.dumps({str(r): [int(t) for t in v]
                       for r, v in sorted(out.items())})
    return hashlib.sha256(flat.encode()).hexdigest()


def reset_peak() -> None:
    """Start a peak-memory reading: engines hold reference cycles, so
    collect the ones already dropped before the allocator's peak is
    reset to what is live."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` CUDA-event runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def agree(what: str, out, ref):
    """Hold a kernel's output against its plain version's (rows of D
    along the last axis); return (max abs error, max row error)."""
    o, r = out.float(), ref.float()
    require(torch.isfinite(o).all(), f"{what}: non-finite")
    err = (o - r).abs()
    require(torch.all(err <= ATOL + RTOL * r.abs()),
            f"{what} disagrees with plain version: max err {float(err.max())}")
    row = (o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)
    require(torch.all(row <= ROW_TOL),
            f"{what} disagrees with plain version: row error "
            f"{float(row.max())}")
    return float(err.max()), float(row.max())


def bound(nbytes: float, flops: float, dtype=torch.bfloat16):
    """The least time for the work in ms, and what sets it: bytes at the
    HBM rate, or operations at the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if dtype == torch.float32
                     else BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_frames(rng, n_frames, counts):
    """Disjoint random frame ids, ``counts[i]`` of them for row i."""
    perm = rng.permutation(n_frames)
    out, at = [], 0
    for n in counts:
        out.append(perm[at:at + n])
        at += n
    return out


def gathered(pool, table, heads=H):
    """(rows, pages * page, heads, D) view of the pool, KV heads repeated
    to the query heads — the operand SDPA needs."""
    rows, (_, _, hkv, d) = table.shape[0], pool.shape
    x = pool[table.long()].reshape(rows, -1, hkv, d)
    return x.repeat_interleave(heads // hkv, dim=2).transpose(1, 2)


def make_pools(n_frames, mode, dev):
    """Random K and V pools of ``n_frames`` frames: bf16, or int8 / fp8
    frames quantized from the same normal draw with per-(frame, KV head)
    absmax scales.  Returns (k_pages, v_pages, scale keywords)."""
    if mode == "none":
        kp = torch.randn(n_frames, PAGE, HKV, D, device=dev).bfloat16()
        vp = torch.randn(n_frames, PAGE, HKV, D, device=dev).bfloat16()
        return kp, vp, {}
    qcfg = KVQuantConfig(mode)
    pools, scales = [], []
    for _ in range(2):
        x = torch.randn(n_frames, PAGE, HKV, D, device=dev)
        s = x.abs().amax(dim=(1, 3)) * qcfg.inv_qmax           # (N, Hkv)
        pools.append(quantize(x, s[:, None, :, None], qcfg))
        scales.append(s.contiguous())
    return pools[0], pools[1], {"k_scales": scales[0],
                                "v_scales": scales[1]}


def kv_bytes(positions: int, frames: int, mode: str) -> int:
    """Bytes of K and V that ``positions`` pool rows of every KV head in
    ``frames`` distinct frames take: 2-byte elements for bf16, 1-byte
    ones and a scale pair per (frame, KV head) for a quantized pool."""
    if mode == "none":
        return 2 * positions * HKV * D * 2
    return 2 * positions * HKV * D + 2 * frames * HKV * 4


def kernel_row(kind: str, mode: str, **fields):
    """One entry of the ``{"kernels": [...]}`` line; bf16 instances keep
    the names of earlier slices."""
    src = {"decode": ("paged_decode", "decode_attention.py:254"),
           "prefill": ("paged_prefill", "flash_attention.py:279"),
           "verify": ("paged_verify", "decode_attention.py:395")}[kind]
    name = f"{src[0]}_attention" + ("" if mode == "none" else f"_{mode}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src[0]}.cu",
            "replaces": f"src/repro/kernels/{src[1]}", "launches": None,
            **fields}


def check_decode(dev, rng, mode="none"):
    lengths = np.array([1, 16, 17, 255, 640, 1000, 1537, 2048], np.int32)
    B, pps = len(lengths), 2048 // PAGE
    n_frames = B * pps + 1
    table = np.full((B, pps), n_frames - 1, np.int32)
    for b, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-n // PAGE) for n in lengths])):
        table[b, :len(fr)] = fr
    kp, vp, kw = make_pools(n_frames, mode, dev)
    q = torch.randn(B, H, D, device=dev).bfloat16()
    pt = torch.from_numpy(table).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, pt, ln)
    out = ops.paged_decode_attention(*args, impl="cuda", **kw)
    ref = ops.paged_decode_attention(*args, impl="torch", **kw)
    err, row_err = agree(f"decode kernel ({mode})", out, ref)
    total = int(lengths.sum())
    frames = sum(-(-int(n) // PAGE) for n in lengths)
    nbytes = (q.numel() * 2 * 2 + pt.numel() * 4 + ln.numel() * 4
              + kv_bytes(total, frames, mode))
    flops = 4 * total * H * D
    b_ms, b_by = bound(nbytes, flops)
    lib_ms = None
    if mode == "none":      # SDPA takes no quantized pool with scales
        kg, vg = gathered(kp, pt), gathered(vp, pt)
        mask = (torch.arange(pps * PAGE, device=dev)[None, :]
                < ln[:, None])[:, None, None, :]
        qs = q[:, :, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    return kernel_row(
        "decode", mode, max_abs_err=err, row_err=row_err,
        ms=time_ms(lambda: ops.paged_decode_attention(*args, impl="cuda",
                                                      **kw)),
        plain_ms=time_ms(lambda: ops.paged_decode_attention(
            *args, impl="torch", **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_prefill(dev, rng, mode="none"):
    offset = np.array([512, 1283], np.int32)
    length = np.array([256, 131], np.int32)
    C, T, pps = 2, 256, 2048 // PAGE
    valid = offset + length
    n_frames = int(sum(-(-v // PAGE) for v in valid)) + 1
    rows = np.full((C, pps), n_frames - 1, np.int32)
    for c, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-v // PAGE) for v in valid])):
        rows[c, :len(fr)] = fr
    kp, vp, kw = make_pools(n_frames, mode, dev)
    q = torch.randn(C, T, H, D, device=dev).bfloat16()
    pr = torch.from_numpy(rows).to(dev)
    off = torch.from_numpy(offset).to(dev)
    ln = torch.from_numpy(length).to(dev)
    args = (q, kp, vp, pr, off, ln)
    out = ops.paged_prefill_attention(*args, impl="cuda", **kw)
    ref = ops.paged_prefill_attention(*args, impl="torch", **kw)
    errs = [agree(f"prefill kernel ({mode})", out[c, :length[c]],
                  ref[c, :length[c]]) for c in range(C)]
    # work of the valid query rows: query t sees offset + t + 1 keys
    attended = sum(int(length[c]) * int(offset[c])
                   + int(length[c]) * (int(length[c]) + 1) // 2
                   for c in range(C))
    nbytes = (2 * 2 * int(length.sum()) * H * D + rows.size * 4 + 2 * C * 4
              + kv_bytes(int(valid.sum()), n_frames - 1, mode))
    flops = 4 * attended * H * D
    b_ms, b_by = bound(nbytes, flops)
    lib_ms = None
    if mode == "none":
        kg, vg = gathered(kp, pr), gathered(vp, pr)
        q_pos = off[:, None] + torch.arange(T, device=dev)[None, :]
        kv_pos = torch.arange(pps * PAGE, device=dev)
        mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        qs = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    return kernel_row(
        "prefill", mode, max_abs_err=max(e for e, _ in errs),
        row_err=max(r for _, r in errs),
        ms=time_ms(lambda: ops.paged_prefill_attention(*args, impl="cuda",
                                                       **kw)),
        plain_ms=time_ms(lambda: ops.paged_prefill_attention(
            *args, impl="torch", **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


def check_verify(dev, rng, mode="none"):
    """The verify kernel at K=4: against its plain version, and row s
    against the decode kernel of the same element type at
    ``lengths[:, s]``, bitwise."""
    S = SPECULATE_K + 1
    starts = np.array([1, 12, 16, 255, 640, 1000, 1537, 2044], np.int32)
    lengths = np.minimum(starts[:, None] + np.arange(S)[None, :],
                         2048).astype(np.int32)    # 1..5, 16, 17, .., 2048
    B, pps = len(starts), 2048 // PAGE
    longest = lengths.max(axis=1)
    n_frames = B * pps + 1
    table = np.full((B, pps), n_frames - 1, np.int32)
    for b, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-n // PAGE) for n in longest])):
        table[b, :len(fr)] = fr
    kp, vp, kw = make_pools(n_frames, mode, dev)
    q = torch.randn(B, S, H, D, device=dev).bfloat16()
    pt = torch.from_numpy(table).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, pt, ln)
    out = ops.paged_verify_attention(*args, impl="cuda", **kw)
    ref = ops.paged_verify_attention(*args, impl="torch", **kw)
    err, row_err = agree(f"verify kernel ({mode})", out, ref)
    vs_decode = max(
        float((out[:, s].float() - ops.paged_decode_attention(
            q[:, s].contiguous(), kp, vp, pt, ln[:, s].contiguous(),
            impl="cuda", **kw).float()).abs().max()) for s in range(S))
    print(f"[kernel] verify ({mode}) row s vs decode kernel at "
          f"lengths[:, s]: max diff {vs_decode:.3e} "
          f"({'bitwise' if vs_decode == 0 else 'not bitwise'})")
    require(vs_decode == 0, f"verify ({mode}) row s is not bitwise the "
            "decode kernel at lengths[:, s]")
    # K/V rows up to each sequence's longest row, read once
    frames = sum(-(-int(n) // PAGE) for n in longest)
    nbytes = (q.numel() * 2 * 2 + pt.numel() * 4 + ln.numel() * 4
              + kv_bytes(int(longest.sum()), frames, mode))
    flops = 4 * int(lengths.sum()) * H * D
    b_ms, b_by = bound(nbytes, flops)
    lib_ms = None
    if mode == "none":
        kg, vg = gathered(kp, pt), gathered(vp, pt)
        mask = (torch.arange(pps * PAGE, device=dev)[None, None, :]
                < ln[:, :, None])[:, None]             # (B, 1, S, L)
        qs = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    return kernel_row(
        "verify", mode, max_abs_err=err, row_err=row_err,
        ms=time_ms(lambda: ops.paged_verify_attention(*args, impl="cuda",
                                                      **kw)),
        plain_ms=time_ms(lambda: ops.paged_verify_attention(
            *args, impl="torch", **kw)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


#: phase 2d: (entry point, dtype, what the case is, shapes); bf16 at
#: phi4-mini-3.8b's full width, f32 at the quickstart's and the reference
#: benchmark's shapes; then the shapes the attention kernels and the f32
#: matmul took only after their repair (other configs' heads, f32 with
#: no tiles), and the linear recurrences at the reference benchmark's f32
#: shapes and at rwkv6-7b's and zamba2-1.2b's full width in bf16.  The
#: first case of an entry point heads its row; the paged kernels' cases
#: join phase 2's rows.
DENSE_CASES = (
    ("matmul", torch.bfloat16, "MLP gate/up, 2 chunks of 256 tokens",
     dict(M=512, K=3072, N=8192)),
    ("matmul", torch.bfloat16, "MLP down, 2 chunks of 256 tokens",
     dict(M=512, K=8192, N=3072)),
    ("matmul", torch.float32, "quickstart, 128^3 tiles",
     dict(M=256, K=512, N=256, bm=128, bk=128, bn=128)),
    ("flash", torch.bfloat16, "causal 2048-token prompt",
     dict(B=1, H=24, Hkv=8, Sq=2048, Skv=2048, D=128, q_offset=0,
          kv_valid=2048)),
    ("flash", torch.bfloat16, "256-token chunk at 1792",
     dict(B=1, H=24, Hkv=8, Sq=256, Skv=2048, D=128, q_offset=1792,
          kv_valid=2048)),
    ("flash", torch.float32, "bench_kernels B1 H4/2 S256 D64",
     dict(B=1, H=4, Hkv=2, Sq=256, Skv=256, D=64, q_offset=0,
          kv_valid=256)),
    ("decode", torch.bfloat16, "8 sequences, 2000 of 2048 positions",
     dict(B=8, H=24, Hkv=8, Skv=2048, D=128, valid=2000, bkv=256)),
    ("decode", torch.float32, "bench_kernels B2 H8/2 cache 1024",
     dict(B=2, H=8, Hkv=2, Skv=1024, D=64, valid=1000, bkv=256)),
    ("matmul", torch.float32, "1024^3, no tiles (the reference's plan)",
     dict(M=1024, K=1024, N=1024)),
    ("flash", torch.bfloat16, "h2o-danube 32/8 heads of 80, causal 2048",
     dict(B=1, H=32, Hkv=8, Sq=2048, Skv=2048, D=80, q_offset=0,
          kv_valid=2048)),
    ("decode", torch.bfloat16, "llama4 G=5 (40/8 of 128), 8 x 2000",
     dict(B=8, H=40, Hkv=8, Skv=2048, D=128, valid=2000, bkv=256)),
    ("decode", torch.bfloat16, "command-r-plus G=12 (96/8 of 128), 8 x 2000",
     dict(B=8, H=96, Hkv=8, Skv=2048, D=128, valid=2000, bkv=256)),
    ("decode", torch.bfloat16, "h2o-danube 32/8 heads of 80, 8 x 2000",
     dict(B=8, H=32, Hkv=8, Skv=2048, D=80, valid=2000, bkv=256)),
    ("paged_decode", torch.bfloat16, "llama4 G=5 (40/8 of 128)",
     dict(H=40, Hkv=8, D=128)),
    ("paged_decode", torch.bfloat16, "command-r-plus G=12 (96/8 of 128)",
     dict(H=96, Hkv=8, D=128)),
    ("paged_decode", torch.bfloat16, "h2o-danube 32/8 heads of 80",
     dict(H=32, Hkv=8, D=80)),
    ("paged_verify", torch.bfloat16, "llama4 G=5 (40/8 of 128), K=4",
     dict(H=40, Hkv=8, D=128)),
    ("paged_verify", torch.bfloat16, "command-r-plus G=12 (96/8 of 128), K=4",
     dict(H=96, Hkv=8, D=128)),
    ("paged_verify", torch.bfloat16, "h2o-danube 32/8 heads of 80, K=4",
     dict(H=32, Hkv=8, D=80)),
    ("paged_prefill", torch.bfloat16, "h2o-danube 32/8 heads of 80",
     dict(H=32, Hkv=8, D=80)),
    ("wkv6", torch.float32, "bench_kernels B1 T256 H2 K64",
     dict(B=1, T=256, H=2, K=64, chunk=64)),
    ("wkv6", torch.bfloat16, "rwkv6-7b B1 T2048 H64 K64 (w, u f32)",
     dict(B=1, T=2048, H=64, K=64, chunk=64)),
    ("ssd", torch.float32, "bench_kernels B1 T256 H2 P64 N64",
     dict(B=1, T=256, H=2, P=64, N=64, chunk=64)),
    ("ssd", torch.bfloat16,
     "zamba2-1.2b B1 T2048 H64 P64 N64 (dt, A, D f32)",
     dict(B=1, T=2048, H=64, P=64, N=64, chunk=128)),
)
_DENSE_SOURCE = {"matmul": ("amu_matmul", "amu_matmul.py:117"),
                 "flash": ("flash_attention", "flash_attention.py:114"),
                 "decode": ("decode_attention", "decode_attention.py:109"),
                 "wkv6": ("wkv6", "rwkv6.py:93"),
                 "ssd": ("ssd", "mamba2.py:93")}
#: the paged kernels' cases join these rows of phase 2
_PAGED_ROW = {"paged_decode": "paged_decode_attention",
              "paged_verify": "paged_verify_attention",
              "paged_prefill": "paged_prefill_attention"}
#: the reference's bars for the f32 recurrences (tests/test_kernels.py:
#: 117-158): kernel vs chunked form, and vs the sequential oracle
SSM_TOL, SSM_SEQ_TOL = 1e-5, 1e-4
_NO_LIBRARY = {"wkv6": "no single PyTorch call computes WKV6",
               "ssd": "no single PyTorch call computes SSD"}


def paged_inputs(kind: str, c: dict, i: int, dev):
    """A paged case of :data:`DENSE_CASES` at phase 2's lengths and page
    size with the case's heads: (call, library call, bytes, flops, and
    the verify case's decode call per row or the prefill rows' lengths)."""
    heads, hkv, d = c["H"], c["Hkv"], c["D"]
    rng = np.random.default_rng(SEED + 100 + i)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
    pps = 2048 // PAGE
    if kind == "paged_prefill":
        offset = np.array([512, 1283], np.int32)
        length = np.array([256, 131], np.int32)
        longest, rows_q = offset + length, (2, 256)
    elif kind == "paged_verify":
        S = SPECULATE_K + 1
        starts = np.array([1, 12, 16, 255, 640, 1000, 1537, 2044], np.int32)
        length = np.minimum(starts[:, None] + np.arange(S)[None, :],
                            2048).astype(np.int32)
        longest, rows_q = length.max(axis=1), (len(starts), S)
    else:
        length = np.array([1, 16, 17, 255, 640, 1000, 1537, 2048], np.int32)
        longest, rows_q = length, (len(length),)
    n_frames = len(longest) * pps + 1
    table = np.full((len(longest), pps), n_frames - 1, np.int32)
    for b, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-n // PAGE) for n in longest])):
        table[b, :len(fr)] = fr
    kp, vp = (torch.randn(n_frames, PAGE, hkv, d, generator=gen,
                          device=dev).bfloat16() for _ in range(2))
    q = torch.randn(*rows_q, heads, d, generator=gen, device=dev).bfloat16()
    pt = torch.from_numpy(table).to(dev)
    ln = torch.from_numpy(length).to(dev)
    kg, vg = gathered(kp, pt, heads), gathered(vp, pt, heads)
    kv_pos = torch.arange(pps * PAGE, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    frames = sum(-(-int(n) // PAGE) for n in longest)
    kv = 2 * int(longest.sum()) * hkv * d * 2 + pt.numel() * 4
    decode_rows = None
    if kind == "paged_prefill":
        off = torch.from_numpy(offset).to(dev)
        call = (lambda impl="auto": ops.paged_prefill_attention(
            q, kp, vp, pt, off, ln, impl=impl))
        q_pos = off[:, None] + torch.arange(rows_q[1], device=dev)[None, :]
        mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
        qs = q.transpose(1, 2)
        attended = sum(int(n) * int(o) + int(n) * (int(n) + 1) // 2
                       for o, n in zip(offset, length))
        return (call, lambda: sdpa(qs, kg, vg, attn_mask=mask),
                2 * 2 * int(length.sum()) * heads * d + kv + 2 * 2 * 4,
                4 * attended * heads * d, [int(n) for n in length])
    if kind == "paged_verify":
        call = (lambda impl="auto": ops.paged_verify_attention(
            q, kp, vp, pt, ln, impl=impl))
        mask = (kv_pos[None, None, :] < ln[:, :, None])[:, None]
        qs = q.transpose(1, 2)
        decode_rows = [
            (lambda s=s: ops.paged_decode_attention(
                q[:, s].contiguous(), kp, vp, pt, ln[:, s].contiguous()))
            for s in range(rows_q[1])]
    else:
        call = (lambda impl="auto": ops.paged_decode_attention(
            q, kp, vp, pt, ln, impl=impl))
        mask = (kv_pos[None, :] < ln[:, None])[:, None, None, :]
        qs = q[:, :, None]
    return (call, lambda: sdpa(qs, kg, vg, attn_mask=mask),
            q.numel() * 2 * 2 + ln.numel() * 4 + kv,
            4 * int(length.sum()) * heads * d, decode_rows)


def ssm_inputs(kind: str, c: dict, dt, rand):
    """A recurrence case of :data:`DENSE_CASES`, drawn as the reference's
    test draws it, the decay path in f32: (call, sequential oracle or
    None, bytes, flops).  The flops are the chunked form's products."""
    el = torch.tensor([], dtype=dt).element_size()
    B, T, H, n = c["B"], c["T"], c["H"], c["chunk"]
    chunks, cc = T // min(n, T), min(n, T)
    if kind == "wkv6":
        K = V = c["K"]
        r, k, v = (rand(B, T, H, K).to(dt) for _ in range(3))
        w = -torch.exp(rand(B, T, H, K) - 2)
        u = rand(H, K) * 0.1
        per_chunk = (2 * cc * K * V + cc * (cc - 1) // 2 * K
                     + cc * (cc + 1) // 2 * V + cc * K)
        return ((lambda impl="auto": ops.wkv6(r, k, v, w, u, impl=impl,
                                              chunk=n)),
                (lambda: kref.wkv6_ref(r, k, v, w, u)) if T <= 256 else None,
                el * B * T * H * (2 * K + 2 * V) + 4 * (B * T * H * K + H * K),
                2 * B * H * chunks * per_chunk)
    P, N = c["P"], c["N"]
    x = rand(B, T, H, P).to(dt)
    dts = torch.nn.functional.softplus(rand(B, T, H))
    A = torch.linspace(0.5, 4.0, H, device=x.device)
    Bm, Cm = (rand(B, T, N).to(dt) for _ in range(2))
    Dh = rand(H)
    per_chunk = (2 * cc * N * P + cc * (cc + 1) // 2 * (N + P)) * 2 + cc * P
    return ((lambda impl="auto": ops.ssd(x, dts, A, Bm, Cm, Dh, impl=impl,
                                         chunk=n)),
            (lambda: kref.ssd_ref(x, dts, A, Bm, Cm, Dh)) if T <= 256
            else None,
            el * (2 * B * T * H * P + 2 * B * T * N) + 4 * (B * T * H + 2 * H),
            B * H * chunks * per_chunk)


def dense_inputs(i: int, dev):
    """Case ``i`` of :data:`DENSE_CASES`: (call, library call or None,
    bytes, flops, extra), where ``call(impl)`` runs the ops entry point
    on inputs drawn from generators seeded by ``i`` (phase 6 draws them
    again) and ``extra`` is the sequential oracle of a recurrence, the
    per-row decode calls of a verify case or a prefill case's lengths."""
    kind, dt, _, c = DENSE_CASES[i]
    if kind in _PAGED_ROW:
        return paged_inputs(kind, c, i, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    if kind in _NO_LIBRARY:
        call, seq, nbytes, flops = ssm_inputs(
            kind, c, dt, lambda *shape: torch.randn(
                *shape, generator=gen, device=dev))
        return call, None, nbytes, flops, seq
    el = torch.tensor([], dtype=dt).element_size()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kind == "matmul":
        M, K, N = c["M"], c["K"], c["N"]
        x, w = rand(M, K), rand(K, N)
        tiles = {t: c[t] for t in ("bm", "bk", "bn") if t in c}
        return ((lambda impl="auto": ops.matmul(x, w, impl=impl, **tiles)),
                (lambda: torch.matmul(x, w)), (M * K + K * N + M * N) * el,
                2 * M * K * N, None)
    if kind == "flash":
        B, H, Hkv, Sq, Skv, D = (c[n] for n in ("B", "H", "Hkv", "Sq",
                                                 "Skv", "D"))
        off, kvv = c["q_offset"], c["kv_valid"]
        q, k, v = rand(B, Sq, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
        qs = q.transpose(1, 2).contiguous()
        ks, vs = (t[:, :kvv].repeat_interleave(H // Hkv, dim=2)
                  .transpose(1, 2).contiguous() for t in (k, v))
        q_pos = off + torch.arange(Sq, device=dev)
        mask = torch.arange(kvv, device=dev)[None, :] <= q_pos[:, None]
        lib = ((lambda: sdpa(qs, ks, vs, is_causal=True)) if off == 0
               and Sq == kvv else (lambda: sdpa(qs, ks, vs, attn_mask=mask)))
        pairs = sum(min(off + t + 1, kvv) for t in range(Sq))
        return ((lambda impl="auto": ops.flash_attention(
                    q, k, v, causal=True, impl=impl, q_offset=off,
                    kv_valid=kvv)), lib,
                (2 * B * Sq * H * D + 2 * B * kvv * Hkv * D) * el,
                4 * B * H * D * pairs, None)
    B, H, Hkv, Skv, D, valid = (c[n] for n in ("B", "H", "Hkv", "Skv", "D",
                                                "valid"))
    q, k, v = rand(B, H, D), rand(B, Skv, Hkv, D), rand(B, Skv, Hkv, D)
    qs = q[:, :, None]
    ks, vs = (t[:, :valid].repeat_interleave(H // Hkv, dim=2)
              .transpose(1, 2).contiguous() for t in (k, v))
    return ((lambda impl="auto": ops.decode_attention(
                q, k, v, valid_len=valid, impl=impl, bkv=c["bkv"])),
            (lambda: sdpa(qs, ks, vs)),
            (2 * B * H * D + 2 * B * valid * Hkv * D) * el,
            4 * B * H * valid * D, None)


def _rel(out, ref) -> tuple:
    """(max |err|, max |err| / max |ref|) of two outputs, in f32."""
    o, r = out.float(), ref.float()
    err = float((o - r).abs().max())
    return err, err / float(r.abs().max())


def check_case(i: int, dev):
    """Case ``i``: kernel against plain version at its bar (and a verify
    case's rows against the decode kernel, bitwise; an f32 recurrence
    against its sequential oracle too), timed; returns (the case's
    numbers, the kernel output on the host)."""
    kind, dt, label, shape = DENSE_CASES[i]
    call, lib, nbytes, flops, extra = dense_inputs(i, dev)
    out, ref = call("cuda"), call("torch")
    torch.cuda.synchronize()
    what = f"{kind} {label} ({dt})"
    require(torch.isfinite(out.float()).all(), f"{what}: non-finite")
    if kind == "paged_prefill":          # rows past lengths: don't-care
        errs = [agree(what, out[c, :m], ref[c, :m])
                for c, m in enumerate(extra)]
        err, acc = max(e for e, _ in errs), {"row_err": max(
            r for _, r in errs)}
    elif dt == torch.bfloat16:
        err, row_err = agree(what, out, ref)
        acc = {"row_err": row_err}
    else:
        err, rel = _rel(out, ref)
        tol = SSM_TOL if kind in _NO_LIBRARY else F32_TOL
        require(rel < tol, f"{what} disagrees with plain version: max err "
                f"/ max ref {rel:.3e} (bar {tol})")
        acc = {"rel_err": rel}
    if kind in _NO_LIBRARY and dt == torch.float32 and extra is not None:
        seq_rel = _rel(out, extra())[1]
        require(seq_rel < SSM_SEQ_TOL, f"{what} disagrees with the "
                f"sequential oracle: {seq_rel:.3e} (bar {SSM_SEQ_TOL})")
        acc["seq_rel_err"] = seq_rel
    if kind == "paged_verify":
        diff = max(float((out[:, s].float() - one().float()).abs().max())
                   for s, one in enumerate(extra))
        require(diff == 0, f"{what}: row s is not bitwise the decode "
                "kernel at lengths[:, s]")
        acc["vs_decode"] = diff
    b_ms, b_by = bound(nbytes, flops, dt)
    case = {"case": label, **shape, "max_abs_err": err, **acc,
            "ms": time_ms(lambda: call("cuda")),
            "plain_ms": time_ms(lambda: call("torch"),
                                reps=3 if kind in _NO_LIBRARY else 10),
            "library_ms": None if lib is None else time_ms(lib),
            "bound_ms": b_ms, "bound_by": b_by}
    if kind in _NO_LIBRARY:
        case["library"] = _NO_LIBRARY[kind]
    lib_txt = (_NO_LIBRARY.get(kind, "n/a") if case["library_ms"] is None
               else f"{case['library_ms']:.4f}")
    print(f"[dense] {what}: kernel_ms {case['ms']:.4f} plain_ms "
          f"{case['plain_ms']:.4f} library_ms {lib_txt} bound_ms "
          f"{b_ms:.4f} ({b_by}) max_abs_err {err:.3e} "
          + " ".join(f"{k} {v:.3e}" for k, v in acc.items()))
    return case, out.cpu()


def check_dense(dev):
    """Phase 2d: every case of :data:`DENSE_CASES`, kernel against plain
    version; returns one ``{"kernels": [...]}`` row per kernel-level entry
    point (its first case's numbers, every case under ``cases``), the
    paged kernels' cases by phase 2's row name, and each case's kernel
    output, on the host, for phase 6."""
    rows, paged, outs = {}, {}, []
    for i, (kind, dt, _, _) in enumerate(DENSE_CASES):
        case, out = check_case(i, dev)
        outs.append(out)
        if kind in _PAGED_ROW:
            paged.setdefault(_PAGED_ROW[kind], []).append(case)
            continue
        src, replaces = _DENSE_SOURCE[kind]
        name = f"{src}_{'f32' if dt == torch.float32 else 'bf16'}"
        if name not in rows:
            rows[name] = {
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}.cu",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": None,
                **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                "cases": []}
            if "library" in case:
                rows[name]["library"] = case["library"]
        rows[name]["cases"].append(case)
    return list(rows.values()), paged, outs


def run_dense_path(dev, outs) -> dict:
    """Phase 6: the quickstart on the card, then every case of phase 2d
    once through ``ops`` as a user calls it; returns the launch counts
    of the kernel-level entry points in this run."""
    entry_points = (*ops.DENSE_KERNELS, *ops.SSM_KERNELS)
    cpu = quickstart.main(["--device", "cpu"])
    for k in entry_points:
        k.launches = 0
    card = quickstart.main([])
    require(mm_mod.KERNELS[torch.float32].launches > 0,
            "the quickstart did not launch the f32 AMU matmul kernel")
    require(card["runtime"] == cpu["runtime"],
            f"quickstart part 1 on the card {card['runtime']} differs from "
            f"the CPU run {cpu['runtime']}")
    require(card["kernel"]["rel_err"] < F32_TOL,
            f"quickstart matmul error {card['kernel']['rel_err']:.3e}")
    print(f"[quickstart] part 1 as on the CPU: {card['runtime']}; part 2 "
          f"max err {card['kernel']['max_err']:.3e} (relative "
          f"{card['kernel']['rel_err']:.3e})")
    for i, (kind, dt, label, _) in enumerate(DENSE_CASES):
        out = dense_inputs(i, dev)[0]()
        torch.cuda.synchronize()
        require(torch.equal(out.cpu(), outs[i]),
                f"{kind} {label} ({dt}): the default impl's output is not "
                "phase 2d's kernel output")
    launches = {k.name: k.launches for k in entry_points}
    print(f"[dense] entry-point launches in phase 6: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on its path")
    return launches


class OracleProposer:
    """Drafts the continuation a plain run emitted: right wherever the
    verify step's argmax equals the decode step's."""

    def __init__(self, refs, prompt_lens, k):
        self.refs, self.prompt_lens, self.k = refs, prompt_lens, k

    def propose(self, rid, history):
        n = len(history) - self.prompt_lens[rid]
        return list(self.refs[rid][n:n + self.k])

    def drop(self, rid):
        pass


class WrongProposer(OracleProposer):
    """The plain run's tokens plus one: rejected at row 0 on every
    verify step that follows the plain stream."""

    def __init__(self, refs, prompt_lens, k, vocab):
        super().__init__(refs, prompt_lens, k)
        self.vocab = vocab

    def propose(self, rid, history):
        return [(t + 1) % self.vocab for t in super().propose(rid, history)]


def engine_config(device, device_pages, clock=None,
                  proposer_factory=None, kv_quant="none") -> EngineConfig:
    e = ENGINE
    return EngineConfig(
        max_batch=e["max_batch"], max_len=e["max_len"], device=device,
        paging=PagingConfig(page_size=e["page_size"],
                            device_pages=device_pages, kv_quant=kv_quant),
        chunking=ChunkingConfig(chunk_tokens=e["chunk_tokens"],
                                chunk_slots=e["chunk_slots"]),
        scheduler=SchedulerConfig(policy="watermark", clock=clock),
        speculation=SpeculationConfig(
            speculate_k=SPECULATE_K if proposer_factory else 0,
            proposer_factory=proposer_factory))


def prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lo, hi = PROMPT_RANGE
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(N_REQUESTS)]


def serve(cfg, params, device, device_pages, clock=None,
          proposer_factory=None, kv_quant="none"):
    """Serve the smoke requests; returns (engine, outputs, wall seconds)."""
    eng = Engine(cfg, params, engine_config(device, device_pages, clock,
                                            proposer_factory, kv_quant))
    for p in prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    t0 = time.perf_counter()
    out = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, out, time.perf_counter() - t0


def check_steps(cfg, params, dev):
    """One prefill chunk of the engine's batch of rows, then one decode
    step and one verify step over the pool it filled, at full width:
    kernels vs plain versions on identical fresh caches; then verify row
    s vs the s-th of S sequential decode steps, through the kernels."""
    rng = np.random.default_rng(SEED + 1)
    B, T, S = ENGINE["max_batch"], 256, SPECULATE_K + 1
    per_row = -(-(T + S) // PAGE)            # pages for the chunk + S tokens
    n_frames = B * per_row + 1
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    vtoks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(dev)
    full = torch.full((B,), S, dtype=torch.int32, device=dev)
    rows = torch.full((B, 32), n_frames - 1, dtype=torch.int32, device=dev)
    rows[:, :per_row] = torch.arange(B * per_row, dtype=torch.int32,
                                     device=dev).reshape(B, per_row)
    chunk = {"tokens": toks, "page_rows": rows,
             "offset": torch.zeros(B, dtype=torch.int32, device=dev),
             "length": torch.tensor([256, 217, 256, 100, 1, 256, 180, 33],
                                    dtype=torch.int32, device=dev)}

    def prefilled(impl):
        cache = init_paged_cache(cfg, B, 512, n_frames, PAGE, device=dev)
        cl, cache = prefill_chunk(params, cfg, cache, chunk, impl=impl)
        cache.kv["page_table"].copy_(rows)
        return cl, cache._replace(pos=chunk["length"].clone())

    res = {}
    for impl in ("cuda", "torch"):
        cl, cache = prefilled(impl)
        kv = {k: t.clone() for k, t in cache.kv.items()}
        dl, _ = decode_step(params, cfg, cache, toks[:, -1:], impl=impl)
        vl, _ = verify_step(params, cfg, cache._replace(kv=kv), vtoks, full,
                            impl=impl)
        res[impl] = (cl.float(), dl.float(), vl.float())
    shapes = ((B, cfg.padded_vocab), (B, cfg.padded_vocab),
              (B, S, cfg.padded_vocab))
    for i, name in enumerate(("chunk", "decode", "verify")):
        a, b = res["cuda"][i], res["torch"][i]
        require(a.shape == shapes[i], f"{name}: {a.shape}")
        require(torch.isfinite(a).all(), f"{name} logits: non-finite")
        rel = float((a - b).norm() / b.norm())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"[steps] {name} logits kernels vs plain: rel err {rel:.3e}, "
              f"argmax agreement {same:.2f}")
        require(rel < 0.05, f"{name} logits rel err {rel}")

    vl = res["cuda"][2]
    _, cache = prefilled("cuda")
    for s in range(S):
        dl, cache = decode_step(params, cfg, cache, vtoks[:, s:s + 1],
                                impl="cuda")
        dl = dl.float()
        diff = (vl[:, s] - dl).abs().max(-1).values          # (B,)
        rel = float((vl[:, s] - dl).norm() / dl.norm())
        # rows whose top-2 margin no perturbation within diff can close
        top2 = dl.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
        agree_rows = vl[:, s].argmax(-1) == dl.argmax(-1)
        print(f"[steps] verify row {s} vs sequential decode step {s}: rel "
              f"err {rel:.3e}, max abs diff {float(diff.max()):.3e}, argmax "
              f"agreement {float(agree_rows.float().mean()):.2f} "
              f"({int(decided.sum())} of {B} rows decided by the margin)")
        require(rel < 0.05, f"verify row {s} vs decode: rel err {rel}")
        require(bool(agree_rows[decided].all()),
                f"verify row {s} chose another argmax than decode where "
                "the top-2 margin exceeds their difference")

    # where the rows part: each piece of a layer on B * S rows vs B rows
    layers = params["layers"]
    mlp = {k: {"w": v["w"][0]} for k, v in layers["mlp"].items()}
    q_proj = {"w": layers["attn"]["q"]["w"][0]}
    norm = {"scale": layers["attn_norm"]["scale"][0]}
    x = torch.randn(B, S, cfg.d_model, device=dev).bfloat16()
    pieces = {
        "rms_norm": lambda h: rms_norm(norm, h, cfg.norm_eps),
        "q projection": lambda h: dense(q_proj, h, torch.bfloat16),
        "swiglu mlp": lambda h: swiglu(mlp, h, torch.bfloat16),
        "unembed": lambda h: unembed(params["embed"], h,
                                     compute_dtype=torch.bfloat16)}
    for name, fn in pieces.items():
        d = float((fn(x)[:, :1].float() - fn(x[:, :1].contiguous()).float())
                  .abs().max())
        print(f"[steps] {name} on {B * S} rows vs {B} rows: max diff "
              f"{d:.3e}{' (bitwise)' if d == 0 else ''}")


_ELEM = re.compile(r"kernelI(13__nv_bfloat16|13__nv_fp8_e4m3|a|f)[LE]")
_ELEM_NAME = {"13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "fp8",
              "a": "int8", "f": "f32"}


def ptxas_summary(log: str):
    """Per element type of one library's ``nvcc -Xptxas -v`` log:
    (instantiations, fewest and most registers, largest spill store in
    bytes, instantiations that spill)."""
    out, elem = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            found = _ELEM.search(m.group(1))
            elem = _ELEM_NAME[found.group(1)] if found else "?"
            out.setdefault(elem, {"n": 0, "regs": [], "spill": []})
            out[elem]["n"] += 1
            continue
        if elem is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out[elem]["spill"].append(int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[elem]["regs"].append(int(m.group(1)))
    return {e: (v["n"], min(v["regs"], default=0), max(v["regs"], default=0),
                max(v["spill"], default=0), sum(x > 0 for x in v["spill"]))
            for e, v in out.items()}


def _kind(name: str) -> str:
    if "paged_attention_kernel" in name or "paged_prefill_kernel" in name:
        return "attention kernels"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies"
    return "other kernels"


def profile_engine(cfg, params, path: str, spec_factory) -> None:
    """One more (warm) run of phase 3, of phase 4's oracle run and of
    phase 3q's int8 run under ``torch.profiler``: device time by kind of
    kernel, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    for tag, factory, kv_quant, table in (
            ("plain", None, "none", out),
            ("spec:oracle", spec_factory, "none",
             out.with_name(f"{out.stem}-spec{out.suffix}")),
            ("quant:int8", None, "int8",
             out.with_name(f"{out.stem}-int8{out.suffix}"))):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = serve(cfg, params, "cuda", ENGINE["device_pages"],
                               proposer_factory=factory, kv_quant=kv_quant)
        kinds = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                k = _kind(ev.name)
                kinds[k] = kinds.get(k, 0.0) + ev.time_range.elapsed_us() / 1e3
        busy = sum(kinds.values())
        print(f"[profile:{tag}] profiled run: {wall:.3f}s wall, device busy "
              f"{busy / 1e3:.3f}s ({busy / (wall * 1e3):.3f} of wall)")
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
            print(f"[profile:{tag}] {k}: {ms / 1e3:.3f}s ({ms / busy:.3f} of "
                  f"device time)" if busy else f"[profile:{tag}] {k}: 0")
        avg = prof.key_averages()
        table.write_text(avg.table(sort_by="self_cuda_time_total",
                                   row_limit=60) + "\n\n"
                         + avg.table(sort_by="self_cpu_time_total",
                                     row_limit=40))
        print(f"[profile:{tag}] per-kernel table written to {table}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-out", metavar="PATH", default=None,
                    help="also profile one engine run; table to PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    every = (*ops.KERNELS, *ops.DENSE_KERNELS, *ops.SSM_KERNELS)
    secs = build_all(every)
    sources = {k.source.name: k.build_log for k in every}
    print(f"[build] {len(every)} entry points from {len(sources)} "
          f"sources in {secs:.1f}s")
    for name, log in sources.items():
        for elem, (n, lo, hi, spill, n_spill) in ptxas_summary(log).items():
            print(f"[build] {name} {elem}: {n} instantiations, registers "
                  f"{lo}-{hi}, largest spill store {spill} B "
                  f"({n_spill} spilling)")

    # 2. kernels vs plain versions, every element type of the pool
    rng = np.random.default_rng(SEED)
    rows = []
    for mode in MODES:
        rows += [check_decode(dev, rng, mode), check_prefill(dev, rng, mode),
                 check_verify(dev, rng, mode)]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"[kernel] {r['name']}: kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} library_ms {lib} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err {r['max_abs_err']:.3e} "
              f"row_err {r.pop('row_err'):.3e}")

    # 2d. the kernel-level entry points vs their plain versions, and the
    #     paged kernels at the other configs' heads
    dense_rows, paged_cases, dense_outs = check_dense(dev)
    for r in rows:
        r["cases"] = paged_cases.get(r["name"], [])

    # 3. the engine at full width
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, gen, dev), torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[engine] {ARCH} params ready in {time.perf_counter() - t0:.3f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    reset_peak()
    for k in ops.KERNELS:
        k.launches = 0
    eng, out, wall = serve(cfg, params, "cuda", ENGINE["device_pages"],
                           clock=time.perf_counter)
    launches = {k.name: k.launches for k in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(v) for v in out.values())
    ttft = [r.ttft for r in eng.finished.values()]
    pool = sum(t.numel() * t.element_size() for key, t in eng.cache.kv.items()
               if key != "page_table")
    print(f"[engine] {len(out)} requests, {n_tok} tokens in {wall:.2f}s "
          f"({n_tok / wall:.1f} tok/s), mean TTFT {np.mean(ttft):.3f}s, "
          f"steps {eng.stats['steps']} (mixed {eng.stats['mixed_steps']}), "
          f"peak memory {peak:.2f} GiB, pool {pool / 2**30:.3f} GiB")
    print(f"[engine] preemptions {eng.stats['preemptions']} resumes "
          f"{eng.stats['resumes']} prefill_preempts "
          f"{eng.stats['prefill_preempts']} chunks {eng.stats['chunks']}; "
          f"pager {dict(eng.pager.stats)}")
    print(f"[engine] kernel launches {launches}")
    require(len(out) == N_REQUESTS, f"{len(out)} of {N_REQUESTS} finished")
    require(all(len(v) == NEW_TOKENS for v in out.values()), "token counts")
    require(all(0 <= t < cfg.padded_vocab for v in out.values() for t in v),
            "token ids out of the vocabulary")
    for k in (dec_mod.KERNEL, pre_mod.KERNEL):
        require(launches[k.name] > 0,
                f"kernel {k.name} never launched on the main path")
    require(eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0,
            "the pool never preempted/resumed")
    print(f"[engine] tokens digest {tokens_digest(out)}")
    pps = ENGINE["max_len"] // ENGINE["page_size"]
    roomy, rout, r_wall = serve(cfg, params, "cuda",
                                ENGINE["max_batch"] * pps)
    same = sum(a == b for r in out for a, b in zip(out[r], rout[r]))
    print(f"[engine] roomy pool: preemptions {roomy.stats['preemptions']}, "
          f"steps {roomy.stats['steps']}, {n_tok / r_wall:.1f} tok/s; "
          f"tokens equal to the preempting run: {same}/{n_tok} "
          f"({same / n_tok:.3f})")
    require(same == n_tok, "the roomy pool's tokens differ from the "
            "preempting run's")
    bf16_preempts = eng.stats["preemptions"]
    del eng, roomy

    # 3q. the quantized pool: int8, then fp8 frames, same requests, pool
    #     of 448 frames and policy; then int8 with a roomy pool and with
    #     the bf16 pool's byte budget
    L, hkv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    bf16_frame = 2 * L * PAGE * hkv * hd * 2
    quant_frame = 2 * L * PAGE * hkv * hd + 2 * L * hkv * 4
    print(f"[quant] frame bytes: bf16 {bf16_frame}, int8/fp8 {quant_frame} "
          f"(pool of {ENGINE['device_pages']} frames: "
          f"{ENGINE['device_pages'] * bf16_frame / 2**30:.3f} GiB bf16, "
          f"{ENGINE['device_pages'] * quant_frame / 2**30:.3f} GiB quantized)")
    qruns = {}
    for mode in QUANT_MODES:
        dt = KVQuantConfig(mode).dtype
        reset_peak()
        for k in ops.KERNELS:
            k.launches = 0
        qeng, qout, q_wall = serve(cfg, params, "cuda",
                                   ENGINE["device_pages"],
                                   clock=time.perf_counter, kv_quant=mode)
        qlaunch = {k.name: k.launches for k in ops.KERNELS}
        qpeak = torch.cuda.max_memory_allocated() / 2**30
        kv = qeng.cache.kv
        pool = sum(t.numel() * t.element_size() for key, t in kv.items()
                   if key != "page_table")
        st, ps = qeng.stats, qeng.pager.stats
        q_tok = sum(len(v) for v in qout.values())
        same = sum(a == b for r in out for a, b in zip(out[r], qout[r]))
        print(f"[quant:{mode}] {len(qout)} requests, {q_tok} tokens in "
              f"{q_wall:.2f}s ({q_tok / q_wall:.1f} tok/s), mean TTFT "
              f"{np.mean([r.ttft for r in qeng.finished.values()]):.3f}s, "
              f"steps {st['steps']} (mixed {st['mixed_steps']}), peak memory "
              f"{qpeak:.2f} GiB, pool {pool / 2**30:.3f} GiB "
              f"({kv['k_pages'].dtype})")
        print(f"[quant:{mode}] preemptions {st['preemptions']} resumes "
              f"{st['resumes']}; pager {dict(ps)}; tokens equal to the bf16 "
              f"run: {same}/{n_tok} ({same / n_tok:.3f}); kernel launches "
              f"{qlaunch}")
        require(len(qout) == N_REQUESTS,
                f"{mode}: {len(qout)} of {N_REQUESTS} finished")
        require(all(len(v) == NEW_TOKENS for v in qout.values()),
                f"{mode}: token counts")
        require(all(0 <= t < cfg.padded_vocab for v in qout.values()
                    for t in v), f"{mode}: token ids out of the vocabulary")
        require(kv["k_pages"].dtype == dt, f"{mode}: pool dtype")
        for k in (dec_mod.KERNELS[dt], pre_mod.KERNELS[dt]):
            require(qlaunch[k.name] > 0,
                    f"kernel {k.name} never launched on the {mode} path")
        require(st["preemptions"] > 0 and st["resumes"] > 0,
                f"{mode}: the pool never preempted/resumed")
        require(qeng.pager.page_nbytes == quant_frame,
                f"{mode}: page_nbytes {qeng.pager.page_nbytes}")
        require(ps["writeback"] > 0 and ps["bytes_moved_bulk"]
                == ps["writeback"] * quant_frame,
                f"{mode}: bytes parked {ps['bytes_moved_bulk']} != "
                f"{ps['writeback']} frames x {quant_frame}")
        qruns[mode] = {"out": qout, "plain": qlaunch}
        del qeng, kv          # the pool too, before the next peak reading
    roomy, rout, r_wall = serve(cfg, params, "cuda",
                                ENGINE["max_batch"] * pps, kv_quant="int8")
    qout = qruns["int8"]["out"]
    same = sum(a == b for r in qout for a, b in zip(qout[r], rout[r]))
    print(f"[quant:int8] roomy pool: preemptions "
          f"{roomy.stats['preemptions']}, {n_tok / r_wall:.1f} tok/s; tokens "
          f"equal to the preempting int8 run: {same}/{n_tok}")
    require(same == n_tok, "the roomy int8 pool's tokens differ from the "
            "preempting int8 run's")
    del roomy
    budget = ENGINE["device_pages"] * bf16_frame // quant_frame
    beng, bout, b_wall = serve(cfg, params, "cuda", budget,
                               clock=time.perf_counter, kv_quant="int8")
    print(f"[quant:int8] at the bf16 pool's byte budget ({budget} frames): "
          f"{n_tok / b_wall:.1f} tok/s, mean TTFT "
          f"{np.mean([r.ttft for r in beng.finished.values()]):.3f}s, "
          f"steps {beng.stats['steps']}, preemptions "
          f"{beng.stats['preemptions']} (bf16 at {ENGINE['device_pages']} "
          f"frames: {bf16_preempts})")
    require(all(len(v) == NEW_TOKENS for v in bout.values())
            and len(bout) == N_REQUESTS, "int8 at the byte budget: tokens")
    del beng

    # 4. speculative verify-K decode on the same pool
    lens = {i: len(p) for i, p in enumerate(prompts(cfg.vocab_size))}
    oracle = lambda n, k: OracleProposer(out, lens, k)  # noqa: E731
    spec_launches = {}
    for tag, factory in (
            ("oracle", oracle),
            ("wrong", lambda n, k: WrongProposer(out, lens, k,
                                                 cfg.padded_vocab))):
        for k in ops.KERNELS:
            k.launches = 0
        seng, sout, s_wall = serve(cfg, params, "cuda",
                                   ENGINE["device_pages"],
                                   clock=time.perf_counter,
                                   proposer_factory=factory)
        spec_launches[tag] = {k.name: k.launches for k in ops.KERNELS}
        st = seng.stats
        s_tok = sum(len(v) for v in sout.values())
        same = sum(a == b for r in out for a, b in zip(out[r], sout[r]))
        print(f"[spec:{tag}] {len(sout)} requests, {s_tok} tokens in "
              f"{s_wall:.2f}s ({s_tok / s_wall:.1f} tok/s), mean TTFT "
              f"{np.mean([r.ttft for r in seng.finished.values()]):.3f}s, "
              f"steps {st['steps']} (spec {st['spec_steps']}, mixed "
              f"{st['mixed_steps']}), preemptions {st['preemptions']} "
              f"resumes {st['resumes']}")
        print(f"[spec:{tag}] drafted {st['drafted']} accepted "
              f"{st['accepted']} rejected {st['rejected']}; tokens equal "
              f"to the plain run: {same}/{n_tok} ({same / n_tok:.3f}); "
              f"kernel launches {spec_launches[tag]}")
        require(len(sout) == N_REQUESTS,
                f"spec {tag}: {len(sout)} of {N_REQUESTS} finished")
        require(all(len(v) == NEW_TOKENS for v in sout.values()),
                f"spec {tag}: token counts")
        require(st["accepted"] + st["rejected"] == st["drafted"],
                f"spec {tag}: counters do not balance")
        seng.check_invariants()
        require(st["spec_steps"] > 0, f"spec {tag}: no verify step ran")
        require(spec_launches[tag][dec_mod.VERIFY_KERNEL.name] > 0,
                f"spec {tag}: the verify kernel never launched")
        if tag == "wrong":
            require(st["accepted"] == 0 and st["rejected"] == st["drafted"],
                    "spec wrong: a never-matching draft was accepted")
        del seng
    # the first engine run of the process also pays the warm-up: run the
    # plain configuration once more for a like-for-like throughput
    warm, wout, w_wall = serve(cfg, params, "cuda", ENGINE["device_pages"],
                               clock=time.perf_counter)
    print(f"[engine] plain run again, warm: {n_tok / w_wall:.1f} tok/s, "
          f"mean TTFT {np.mean([r.ttft for r in warm.finished.values()]):.3f}s"
          f", steps {warm.stats['steps']}")
    require(wout == out, "the warm plain run's tokens differ")
    del warm

    # 4q. never-matching drafts on the quantized pools: every verify step
    #     rolls back, scales stay where the rejected drafts raised them
    for mode in QUANT_MODES:
        dt = KVQuantConfig(mode).dtype
        for k in ops.KERNELS:
            k.launches = 0
        seng, sout, s_wall = serve(
            cfg, params, "cuda", ENGINE["device_pages"],
            clock=time.perf_counter, kv_quant=mode,
            proposer_factory=lambda n, k, r=qruns[mode]["out"]: WrongProposer(
                r, lens, k, cfg.padded_vocab))
        slaunch = {k.name: k.launches for k in ops.KERNELS}
        st = seng.stats
        s_tok = sum(len(v) for v in sout.values())
        print(f"[quant:{mode}:spec:wrong] {s_tok} tokens in {s_wall:.2f}s "
              f"({s_tok / s_wall:.1f} tok/s), steps {st['steps']} (spec "
              f"{st['spec_steps']}), drafted {st['drafted']} accepted "
              f"{st['accepted']} rejected {st['rejected']}, preemptions "
              f"{st['preemptions']} resumes {st['resumes']}; kernel "
              f"launches {slaunch}")
        require(len(sout) == N_REQUESTS
                and all(len(v) == NEW_TOKENS for v in sout.values()),
                f"{mode} spec wrong: token counts")
        require(st["accepted"] + st["rejected"] == st["drafted"],
                f"{mode} spec wrong: counters do not balance")
        seng.check_invariants()
        require(slaunch[dec_mod.VERIFY_KERNELS[dt].name] > 0,
                f"{mode} spec wrong: the {mode} verify kernel never launched")
        require(st["preemptions"] > 0 and st["resumes"] > 0,
                f"{mode} spec wrong: the pool never preempted/resumed")
        qruns[mode]["spec"] = slaunch
        del seng

    # 5. full-width step check against the plain versions
    check_steps(cfg, params, dev)
    if args.profile_out:
        profile_engine(cfg, params, args.profile_out, oracle)

    # 6. the kernel-level entry points as a user calls them
    dense_launches = run_dense_path(dev, dense_outs)
    for r in dense_rows:
        r["launches"] = dense_launches[r["name"]]

    # launches of each instance in the run that drives its path: decode
    # and prefill from the plain runs, verify from a speculative run
    for i, mode in enumerate(MODES):
        dt = KVQuantConfig(mode).dtype
        plain = launches if mode == "none" else qruns[mode]["plain"]
        spec = spec_launches["oracle"] if mode == "none" \
            else qruns[mode]["spec"]
        rows[3 * i]["launches"] = plain[dec_mod.KERNELS[dt].name]
        rows[3 * i + 1]["launches"] = plain[pre_mod.KERNELS[dt].name]
        rows[3 * i + 2]["launches"] = spec[dec_mod.VERIFY_KERNELS[dt].name]
    print(json.dumps({"kernels": rows + dense_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
