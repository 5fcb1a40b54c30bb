"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ``repro_torch`` only (nothing of JAX or of the ``repro`` package):

1. builds the three CUDA kernels of the serving path (paged decode,
   paged prefill, paged verify), each with its three entry points (bf16
   pool, int8 and fp8 frames of the quantized pool), the five of
   the kernel-level entry points (AMU matmul, dense flash attention,
   dense decode attention, and the RWKV-6 and Mamba2 recurrences wkv6
   and ssd), each with an f32 and a bf16 entry point (three bf16
   instances are sources of their own on TMA, mbarriers and wgmma: the
   matmul, ``amu_matmul_sm90.cu``, the dense flash attention,
   ``flash_attention_sm90.cu``, and the bf16 pool's paged prefill,
   ``paged_prefill_sm90.cu``), and the two indexed gathers of
   ``moe_gather.cu`` (gather_rows, gather_blocks, f32 and bf16; one
   kernel) — 23 entry points from 12 sources — from
   ``src/repro_torch/kernels/csrc``
   with ``nvcc`` for ``sm_90a``, one compiler per source, started
   together, and prints each source's registers and spills per element
   type (``-Xptxas -v``); the three sm90 libraries must spill nowhere,
   and their SASS (``cuobjdump``) must hold tensor-core products
   (``HGMMA``) and TMA loads (``UTMALDG``); nor may the f32 matmul's, the
   dense decode's and the paged decode's and verify's (``amu_matmul.cu``,
   ``decode_attention.cu``, ``paged_decode.cu``, ``paged_verify.cu``),
   nor the f32 dense flash's and the gathers' (``flash_attention.cu``,
   ``moe_gather.cu``), nor the int8 / fp8 paged prefill's
   (``paged_prefill.cu``, on the sm90 block), whose SASS must hold
   ``HGMMA``, ``UTMALDG`` (q) and ``LDGSTS`` (its 1-byte rows), counted
   with its byte permutes and conversions, nor the recurrences'
   (``wkv6.cu``, ``ssd.cu``, chunk-parallel since their redesign), whose
   SASS must hold TF32 tensor-core products (``HMMA.1688.F32.TF32``);
   the paged ones' SASS must
   hold their ring's
   ``cp.async`` copies (``LDGSTS``, counted), the f32 flash's its TF32
   tensor-core products (``HMMA.1688.F32.TF32``) and ``LDGSTS``, the
   gathers' 16-byte loads and stores (``LDG.E.128``, ``STG.E.128``), all
   counted;
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
   its scales); the prefill, decode and verify instances of every pool
   type are also timed cold, as phase 2g times the gathers (bf16: kernel
   and SDPA alike; the one-call times beside), and each
   decode and verify case prints the range length and count its wrapper
   cut it into (``decode_attention.paged_split_positions``).  It computes
   each instance's bound from these inputs (1-byte K/V and the scales
   read for a quantized pool).  Verify row s must be bitwise the decode
   kernel of the same element type at ``lengths[:, s]`` (both are one
   template, split over the same ranges);
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
   reference's own bar, max |err| / max |ref| < 5e-6, and the f32 dense
   flash also at phi4's full width (the causal 2048-token prompt and the
   chunk at 1792, appended last), cold beside SDPA, with its plan
   (``flash_attention.f32_flash_plan``), SDPA's kernel names from the
   profiler, and its bound at both rates (CUDA cores, and three TF32
   products on the tensor cores: the least is the row's).  Then the shapes
   that only the repaired wrappers and kernels take: f32 1024^3 with no
   tiles (the reference's plan, validated, then the card's tile), and
   8 x 1024 x 1024 (M = 8: predicated rows), and the attention
   kernels at the heads of other registered configs — dense flash and
   decode, paged decode and verify at G = 5 (llama4, 40/8), G = 12
   (command-r-plus, 96/8) and D = 80 (h2o-danube, 32/8), paged prefill
   at D = 80 (bf16, and, appended last, int8 and fp8) — at the phase-2
   bars, verify row s bitwise the decode kernel.  Then wkv6 and ssd at
   the reference benchmark's f32 shapes
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
   CUDA-core rate: TF32 is off).  The bf16 matmul cases must also give
   x's columns exactly through a selection matrix w, and are timed as
   phase 2g times the gathers (``cold_ms``), kernel and ``torch.matmul``
   alike, with the one-call times beside them; so are the f32 matmul
   cases, the bf16 dense flash and paged prefill cases, every dense
   decode case and the paged decode and verify cases, kernel and SDPA
   alike, and the int8 / fp8 prefill, wkv6 and ssd cases, which no
   library call computes, the kernel alone (a wkv6 or ssd call enqueues
   three kernels, so ``cold_ms`` queues fewer calls a batch).  It prints
   each wkv6 and ssd case's plan (``rwkv6.wkv6_plan``,
   ``mamba2.ssd_plan``: pieces, segments, blocks, workspace), the f32
   matmul's tile (``f32_tiles``), every tile's
   cold time on each f32 matmul case (each bitwise the wrapper's output),
   each dense decode case's split count (``decode_splits``), each paged
   decode and verify case's range length and count, and a sha256 of the
   f32 matmul cases' outputs, which the tile must not move;
2g. holds each gather entry point against its plain version
   (``index_select``) bitwise, the reference's bar: f32 at the
   reference's test shapes, bf16 at olmoe-1b-7b's full width with the
   indices its MoE block computes from a normal draw (dispatch into the
   capacity slots of 8 rows of one token and of two 256-token chunks,
   the combine of those chunks and, appended last, of the 8 tokens),
   and ``gather_blocks`` at the paged-KV fetch (128 of 448 frames of 16
   rows of 8 x 128), each with its plan (``moe_gather.gather_plan``:
   route, piece, blocks; a block gather's over its blocks as rows, the
   view it runs on); it times the kernel
   and ``index_select`` (the plain version, and the one PyTorch call
   that computes the function) on inputs out of L2, the calls queued
   back to back behind a device sleep (a call's host cost exceeds these
   gathers' device time), and holds both to each case's byte bound
   (distinct source rows read, output rows written, indices);
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
   must be bitwise phase 2d's kernel output, and each case of phase 2g
   through ``ops.gather_rows`` / ``moe_gather.gather_blocks``, bitwise
   phase 2g's.  Every kernel-level entry point (the ten of matmul,
   flash, decode, wkv6 and ssd, the four gathers) must launch in this
   phase;
7. frees phi4's weights and serves phase 3's 12 requests with the same
   engine settings on ``olmoe-1b-7b`` at full width (16 layers, d_model
   2048, 16 heads of 128, 64 experts top-8 of d_ff 1024 on every layer,
   vocab 50304; random bf16 weights from the seed): every request
   finishes with its token count, paged decode, paged prefill and the
   bf16 row gather (the MoE dispatch and combine) launched, the pager
   preempted and resumed, and a roomy pool gives the same tokens (the
   combine sums each token's experts in a fixed order); it prints
   throughput, TTFT, peak memory and a sha256 of the tokens;
7s. checks one olmoe prefill chunk and one decode step over 8 rows,
   kernels against plain versions on the same cache (finite logits
   within phase 5's relative error), and one layer's MoE block with its
   gathers on the kernel against the same block with them plain,
   bitwise, at a decode step's and a chunk's shapes.  Phase 5's "verify
   row s == decode step s" is not asked of MoE: the expert capacity
   depends on the rows a step routes, as in the reference.

It prints the card's name and power limit first, then the lines of each
phase, then ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero before any result.

``--profile-out PATH`` adds one more engine run of phase 3, one of
phase 4's oracle run, one of phase 3q's int8 run and one of phase 7's
olmoe run under ``torch.profiler`` and prints where their device time
went (attention kernels with the split-KV combine, gather kernels,
matrix products, copies, the rest), the device seconds and launches of
each paged decode, verify and prefill instance, of the combine and of
each gather kernel, and the
device's busy share of the profiled wall time; the
per-kernel tables go to PATH and to PATH with ``-spec``, ``-int8`` and
``-olmoe`` added to its stem, sorted by device time and then by host
time.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from importlib import import_module
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import amu_matmul as mm_mod  # noqa: E402
from repro_torch.kernels import mamba2, moe_gather, rwkv6  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.kernels.kv_quant import KVQuantConfig, quantize  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.models import moe  # noqa: E402
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
L2_BYTES = 50 * 2**20            # H100 SXM L2, published
ROTATE_BYTES = 4 * L2_BYTES      # what cold_ms flushes and cycles through
MAX_SETS = 512                   # input sets (and calls) a cold_ms batch
SLEEP_CYCLES_PER_CALL = 400_000  # ~0.2 ms of device sleep per queued call
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor rate
FP32_FLOPS = 67e12               # H100 SXM f32 on the CUDA cores (no TF32)
TF32_FLOPS = 495e12              # H100 SXM dense TF32 tensor rate
#: an f32 product in 3xTF32 (csrc/flash_attention.cu) is three TF32 ones
TF32_PRODUCTS = 3
F32_TOL = 5e-6                   # max |err| / max |ref|, the reference's bar
ARCH = "phi4-mini-3.8b"
MOE_ARCH = "olmoe-1b-7b"
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


def cold_ms(fn, sets, calls: int = 50, reps: int = 5,
            launches: int = 1) -> float:
    """Median device time of one ``fn(*inputs)`` in ms, on inputs out of
    L2, for work shorter than its own host call.  Each batch first
    reads :data:`ROTATE_BYTES` to flush L2, then runs
    ``max(calls, len(sets))`` calls that cycle through ``sets`` (copies
    of the inputs), so every set is read once after the flush, or again
    only after the others' bytes, at least :data:`ROTATE_BYTES` less
    one set, have evicted it; every output stays alive, so each call
    writes fresh memory (an untimed batch first leaves the allocator
    holding their blocks).  The stream sleeps on the device while the host
    enqueues the batch, so the events time the calls back to back, not
    the host's pace.  A batch the host outran (its enqueue took longer
    than the sleep, so its calls did not run back to back) is not
    timed but taken again; raises once ``reps`` batches have been
    outrun.  ``launches``: the kernels one call enqueues; a batch queues
    at most :data:`MAX_SETS` of them (more fill the launch queue, and the
    host then waits out the sleep)."""
    n = min(max(calls, len(sets)), MAX_SETS // launches)
    flush = torch.zeros(ROTATE_BYTES // 4, dtype=torch.int32, device="cuda")
    # warm up with a whole batch, so the allocator holds the blocks of a
    # batch's outputs and no allocation waits on the device in the batch
    outs = [fn(*sets[j % len(sets)]) for j in range(n)]
    del outs
    times, outrun = [], 0
    while len(times) < reps:
        flush.sum()
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(n * SLEEP_CYCLES_PER_CALL)
        start.record()
        t0 = time.perf_counter()
        outs = [fn(*sets[j % len(sets)]) for j in range(n)]
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        del outs
        if host_ms < slept.elapsed_time(start):
            times.append(start.elapsed_time(end) / n)
            continue
        outrun += 1
        require(outrun < reps, f"cold_ms: the host outran the device's "
                f"sleep in {outrun} batches (the last took {host_ms:.1f} ms "
                f"to enqueue {n} calls)")
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


def bound(nbytes: float, flops: float, dtype=torch.bfloat16,
          rate: float = None):
    """The least time for the work in ms, and what sets it: bytes at the
    HBM rate, or operations at ``rate`` (default the peak rate of their
    type: bf16 tensor cores, f32 CUDA cores)."""
    if rate is None:
        rate = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def case_bound(kind: str, nbytes: float, flops: float, dtype) -> tuple:
    """A phase-2d case's bound: :func:`bound` at its type's rate, and for
    the f32 flash kernel, whose products run on the tensor cores in
    3xTF32, the least of that and the same work as three TF32 products
    at :data:`TF32_FLOPS`; returns (ms, by, every route's ms or None)."""
    b_ms, b_by = bound(nbytes, flops, dtype)
    if kind != "flash" or dtype != torch.float32:
        return b_ms, b_by, None
    t_ms, t_by = bound(nbytes, flops, dtype,
                       rate=TF32_FLOPS / TF32_PRODUCTS)
    routes = {"cuda_cores_ms": b_ms, "tf32x3_ms": t_ms}
    return (t_ms, t_by, routes) if t_ms < b_ms else (b_ms, b_by, routes)


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


def make_pools(n_frames, mode, dev, hkv=HKV, d=D, gen=None):
    """Random K and V pools of ``n_frames`` frames of ``hkv`` heads of
    ``d``: bf16, or int8 / fp8 frames quantized from the same normal draw
    with per-(frame, KV head) absmax scales (from ``gen``, else torch's
    default generator).  Returns (k_pages, v_pages, scale keywords)."""
    if mode == "none":
        kp = torch.randn(n_frames, PAGE, hkv, d, generator=gen,
                         device=dev).bfloat16()
        vp = torch.randn(n_frames, PAGE, hkv, d, generator=gen,
                         device=dev).bfloat16()
        return kp, vp, {}
    qcfg = KVQuantConfig(mode)
    pools, scales = [], []
    for _ in range(2):
        x = torch.randn(n_frames, PAGE, hkv, d, generator=gen, device=dev)
        s = x.abs().amax(dim=(1, 3)) * qcfg.inv_qmax           # (N, Hkv)
        pools.append(quantize(x, s[:, None, :, None], qcfg))
        scales.append(s.contiguous())
    return pools[0], pools[1], {"k_scales": scales[0],
                                "v_scales": scales[1]}


def kv_bytes(positions: int, frames: int, mode: str, hkv=HKV, d=D) -> int:
    """Bytes of K and V that ``positions`` pool rows of every KV head in
    ``frames`` distinct frames take: 2-byte elements for bf16, 1-byte
    ones and a scale pair per (frame, KV head) for a quantized pool."""
    if mode == "none":
        return 2 * positions * hkv * d * 2
    return 2 * positions * hkv * d + 2 * frames * hkv * 4


def kernel_row(kind: str, mode: str, **fields):
    """One entry of the ``{"kernels": [...]}`` line; bf16 instances keep
    the names of earlier slices, and each row names its instance's
    source."""
    stem, replaces, kernels = {
        "decode": ("paged_decode", "decode_attention.py:254",
                   dec_mod.KERNELS),
        "prefill": ("paged_prefill", "flash_attention.py:279",
                    pre_mod.KERNELS),
        "verify": ("paged_verify", "decode_attention.py:395",
                   dec_mod.VERIFY_KERNELS)}[kind]
    source = kernels[KVQuantConfig(mode).dtype].source
    name = f"{stem}_attention" + ("" if mode == "none" else f"_{mode}")
    return {"name": name, "route": "cuda",
            "source": str(source.relative_to(ROOT)),
            "replaces": f"src/repro/kernels/{replaces}", "launches": None,
            **fields}


#: phase 2's ragged lengths: decode rows, and the first verify row of
#: each sequence (row s adds s, capped at the table's 2048)
DECODE_LENGTHS = (1, 16, 17, 255, 640, 1000, 1537, 2048)
VERIFY_STARTS = (1, 12, 16, 255, 640, 1000, 1537, 2044)


def paged_operands(kind: str, mode: str, rng, dev, heads=H, hkv=HKV, d=D,
                   gen=None):
    """Phase 2's decode (``kind`` "decode") or verify (K = 4) inputs at
    ``heads`` / ``hkv`` heads of ``d``: 8 sequences, a 2048-position
    table of page 16 over disjoint random frames (numpy ``rng``), the
    rest on the trash frame, pools of ``mode`` and q from ``gen``.
    Returns ((q, k_pages, v_pages, page_table, lengths), scale keywords,
    each sequence's longest length)."""
    if kind == "verify":
        lengths = np.minimum(np.array(VERIFY_STARTS, np.int32)[:, None]
                             + np.arange(SPECULATE_K + 1)[None, :],
                             2048).astype(np.int32)
        longest = lengths.max(axis=1)
    else:
        lengths = longest = np.array(DECODE_LENGTHS, np.int32)
    B, pps = len(longest), 2048 // PAGE
    n_frames = B * pps + 1
    table = np.full((B, pps), n_frames - 1, np.int32)
    for b, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-n // PAGE) for n in longest])):
        table[b, :len(fr)] = fr
    kp, vp, kw = make_pools(n_frames, mode, dev, hkv, d, gen)
    q = torch.randn(*lengths.shape, heads, d, generator=gen,
                    device=dev).bfloat16()
    return ((q, kp, vp, torch.from_numpy(table).to(dev),
             torch.from_numpy(lengths).to(dev)), kw, longest)


def paged_call(kind: str):
    """``ops.paged_decode_attention`` or ``ops.paged_verify_attention``."""
    return (ops.paged_verify_attention if kind == "verify"
            else ops.paged_decode_attention)


def paged_sdpa(kind: str, args, heads=H):
    """SDPA on the gathered view of a bf16 case's pool, each row masked by
    its length: (the call, its operands) — a yardstick only."""
    q, kp, vp, pt, ln = args
    kv_pos = torch.arange(pt.shape[1] * PAGE, device=q.device)
    kg, vg = gathered(kp, pt, heads), gathered(vp, pt, heads)
    if kind == "verify":
        mask = (kv_pos[None, None, :] < ln[:, :, None])[:, None]
        qs = q.transpose(1, 2)
    else:
        mask = (kv_pos[None, :] < ln[:, None])[:, None, None, :]
        qs = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (lambda *a: sdpa(*a[:3], attn_mask=a[3])), (qs, kg, vg, mask)


def paged_cold(kind: str, args, kw) -> tuple:
    """(kernel, operands) of a paged case for :func:`cold_ms`: the scales
    of a quantized pool ride in the operands, so their copies rotate
    too."""
    call, names = paged_call(kind), tuple(kw)
    return ((lambda *a: call(*a[:5], impl="cuda", **dict(zip(names, a[5:])))),
            tuple(args) + tuple(kw.values()))


def paged_split(args) -> dict:
    """The range length and count the wrapper cuts a paged case into."""
    q, kp, _, pt, _ = args
    span, n, _ = dec_mod.paged_split_plan(
        tuple(q.shape), tuple(kp.shape), pt.shape[1],
        dec_mod.sm_count(q.device))
    return {"split_positions": span, "ranges": n}


def paged_times(kind: str, mode: str, args, kw, heads=H) -> dict:
    """A paged case timed cold (:func:`cold_ms`) beside its one call:
    the bf16 instances with SDPA alike (:func:`cold_times`), the int8 /
    fp8 ones alone (no library call takes the pool with its scales)."""
    kernel, operands = paged_cold(kind, args, kw)
    if mode == "none":
        return cold_times(kernel, operands, *paged_sdpa(kind, args, heads))
    return cold_times(kernel, operands, None, None)


def check_decode(dev, rng, mode="none"):
    args, kw, _ = paged_operands("decode", mode, rng, dev)
    q, kp, vp, pt, ln = args
    lengths = ln.cpu().numpy()
    out = ops.paged_decode_attention(*args, impl="cuda", **kw)
    ref = ops.paged_decode_attention(*args, impl="torch", **kw)
    err, row_err = agree(f"decode kernel ({mode})", out, ref)
    total = int(lengths.sum())
    frames = sum(-(-int(n) // PAGE) for n in lengths)
    nbytes = (q.numel() * 2 * 2 + pt.numel() * 4 + ln.numel() * 4
              + kv_bytes(total, frames, mode))
    flops = 4 * total * H * D
    b_ms, b_by = bound(nbytes, flops)
    return kernel_row(
        "decode", mode, max_abs_err=err, row_err=row_err,
        **paged_times("decode", mode, args, kw), **paged_split(args),
        plain_ms=time_ms(lambda: ops.paged_decode_attention(
            *args, impl="torch", **kw)),
        bound_ms=b_ms, bound_by=b_by)


#: phase 2's prefill chunk rows: offsets and lengths (C = 2, T = 256)
PREFILL_OFFSETS, PREFILL_LENGTHS, PREFILL_T = (512, 1283), (256, 131), 256


def prefill_operands(mode: str, rng, dev, heads=H, hkv=HKV, d=D, gen=None):
    """Phase 2's prefill inputs at ``heads`` / ``hkv`` heads of ``d``: two
    chunk rows of :data:`PREFILL_T` at :data:`PREFILL_OFFSETS` with
    :data:`PREFILL_LENGTHS`, a 2048-position table of page 16 over
    disjoint random frames (numpy ``rng``), the rest on the trash frame,
    pools of ``mode`` and q from ``gen``.  Returns ((q, k_pages, v_pages,
    page_rows, offset, lengths), scale keywords, the table's frames in
    use)."""
    offset = np.array(PREFILL_OFFSETS, np.int32)
    length = np.array(PREFILL_LENGTHS, np.int32)
    C, pps = len(offset), 2048 // PAGE
    valid = offset + length
    n_frames = int(sum(-(-v // PAGE) for v in valid)) + 1
    rows = np.full((C, pps), n_frames - 1, np.int32)
    for c, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-v // PAGE) for v in valid])):
        rows[c, :len(fr)] = fr
    kp, vp, kw = make_pools(n_frames, mode, dev, hkv, d, gen)
    q = torch.randn(C, PREFILL_T, heads, d, generator=gen,
                    device=dev).bfloat16()
    return ((q, kp, vp, torch.from_numpy(rows).to(dev),
             torch.from_numpy(offset).to(dev),
             torch.from_numpy(length).to(dev)), kw, n_frames - 1)


def prefill_work(args, frames: int, mode: str) -> tuple:
    """(bytes, flops) of a prefill case: the valid query rows read and
    their outputs written, the table, offsets and lengths, the K/V
    positions below each row's extent (1-byte and the frames' scales for
    a quantized pool); query t sees offset + t + 1 keys."""
    q, kp, _, pt, off, ln = args
    heads, d, hkv = q.shape[2], q.shape[3], kp.shape[2]
    offset, length = off.tolist(), ln.tolist()
    kv = kv_bytes(sum(o + n for o, n in zip(offset, length)), frames, mode,
                  hkv, d)
    attended = sum(n * o + n * (n + 1) // 2 for o, n in zip(offset, length))
    return (2 * 2 * sum(length) * heads * d + pt.numel() * 4
            + 2 * len(offset) * 4 + kv, 4 * attended * heads * d)


def prefill_cold(args, kw) -> tuple:
    """(kernel, operands) of a prefill case for :func:`cold_times`: the
    scales of a quantized pool ride in the operands, so their copies
    rotate too."""
    names = tuple(kw)
    return ((lambda *a: ops.paged_prefill_attention(
                *a[:6], impl="cuda", **dict(zip(names, a[6:])))),
            tuple(args) + tuple(kw.values()))


def prefill_sdpa(args, heads=H) -> tuple:
    """SDPA on the gathered view of a bf16 prefill case's pool, causal at
    each row's offset: (the call, its operands) — a yardstick only; no
    library call takes a quantized pool with its scales."""
    q, kp, vp, pt, off, _ = args
    kv_pos = torch.arange(pt.shape[1] * PAGE, device=q.device)
    q_pos = off[:, None] + torch.arange(q.shape[1], device=q.device)[None, :]
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return ((lambda *a: sdpa(*a[:3], attn_mask=a[3])),
            (q.transpose(1, 2), gathered(kp, pt, heads),
             gathered(vp, pt, heads), mask))


def check_prefill(dev, rng, mode="none"):
    args, kw, frames = prefill_operands(mode, rng, dev)
    length = PREFILL_LENGTHS
    out = ops.paged_prefill_attention(*args, impl="cuda", **kw)
    ref = ops.paged_prefill_attention(*args, impl="torch", **kw)
    errs = [agree(f"prefill kernel ({mode})", out[c, :length[c]],
                  ref[c, :length[c]]) for c in range(len(length))]
    b_ms, b_by = bound(*prefill_work(args, frames, mode))
    # cold and one call, bf16 beside SDPA
    times = cold_times(*prefill_cold(args, kw),
                       *(prefill_sdpa(args) if mode == "none"
                         else (None, None)))
    return kernel_row(
        "prefill", mode, max_abs_err=max(e for e, _ in errs),
        row_err=max(r for _, r in errs), **times,
        plain_ms=time_ms(lambda: ops.paged_prefill_attention(
            *args, impl="torch", **kw)),
        bound_ms=b_ms, bound_by=b_by)


def check_verify(dev, rng, mode="none"):
    """The verify kernel at K=4: against its plain version, and row s
    against the decode kernel of the same element type at
    ``lengths[:, s]``, bitwise."""
    S = SPECULATE_K + 1
    args, kw, longest = paged_operands("verify", mode, rng, dev)
    q, kp, vp, pt, ln = args
    lengths = ln.cpu().numpy()
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
    return kernel_row(
        "verify", mode, max_abs_err=err, row_err=row_err,
        **paged_times("verify", mode, args, kw), **paged_split(args),
        plain_ms=time_ms(lambda: ops.paged_verify_attention(
            *args, impl="torch", **kw)),
        bound_ms=b_ms, bound_by=b_by)


#: phase 2d: (entry point, dtype, what the case is, shapes); bf16 at
#: phi4-mini-3.8b's full width, f32 at the quickstart's and the reference
#: benchmark's shapes; then the shapes the attention kernels and the f32
#: matmul took only after their repair (other configs' heads, f32 with
#: no tiles), and the linear recurrences at the reference benchmark's f32
#: shapes and at rwkv6-7b's and zamba2-1.2b's full width in bf16; last,
#: the f32 matmul at M = 8 and at 2048^3, where the tile rule takes its
#: large tile, the f32 flash kernel at phi4's full width, and the int8 /
#: fp8 paged prefill at D 80 (appended, so every earlier case keeps its
#: seed).  The first case of an entry point heads its row; the paged
#: kernels' cases join phase 2's rows.
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
    ("matmul", torch.float32, "8 x 1024 x 1024, planned tiles (M = 8)",
     dict(M=8, K=1024, N=1024)),
    ("matmul", torch.float32, "2048^3, no tiles (the card's 128 x 128)",
     dict(M=2048, K=2048, N=2048)),
    ("flash", torch.float32,
     "phi4 24/8 heads of 128, causal 2048-token prompt (f32)",
     dict(B=1, H=24, Hkv=8, Sq=2048, Skv=2048, D=128, q_offset=0,
          kv_valid=2048)),
    ("flash", torch.float32, "256-token chunk at 1792 (f32)",
     dict(B=1, H=24, Hkv=8, Sq=256, Skv=2048, D=128, q_offset=1792,
          kv_valid=2048)),
    ("paged_prefill", torch.int8, "h2o-danube 32/8 heads of 80 (int8)",
     dict(H=32, Hkv=8, D=80)),
    ("paged_prefill", torch.float8_e4m3fn,
     "h2o-danube 32/8 heads of 80 (fp8)", dict(H=32, Hkv=8, D=80)),
)
_DENSE_SOURCE = {"matmul": ("amu_matmul", "amu_matmul.py:117"),
                 "flash": ("flash_attention", "flash_attention.py:114"),
                 "decode": ("decode_attention", "decode_attention.py:109"),
                 "wkv6": ("wkv6", "rwkv6.py:93"),
                 "ssd": ("ssd", "mamba2.py:93")}
#: the paged kernels' cases join these rows of phase 2 (a quantized
#: case the row of its pool's instance)
_PAGED_ROW = {"paged_decode": "paged_decode_attention",
              "paged_verify": "paged_verify_attention",
              "paged_prefill": "paged_prefill_attention"}
_MODE_OF = {KVQuantConfig(m).dtype: m for m in MODES}
#: the reference's bars for the f32 recurrences (tests/test_kernels.py:
#: 117-158): kernel vs chunked form, and vs the sequential oracle
SSM_TOL, SSM_SEQ_TOL = 1e-5, 1e-4
#: kernels one call of the recurrences enqueues, at most (since their
#: redesign: the segments' states, their scan, the outputs)
SSM_LAUNCHES = 3
_NO_LIBRARY = {"wkv6": "no single PyTorch call computes WKV6",
               "ssd": "no single PyTorch call computes SSD"}


def paged_inputs(kind: str, c: dict, i: int, dev):
    """A paged case of :data:`DENSE_CASES` at phase 2's lengths and page
    size with the case's heads: (call, library call, bytes, flops, and
    ``{"cold": ...}`` for :func:`cold_times`, with the prefill rows'
    lengths or the verify case's decode call per row)."""
    heads, hkv, d = c["H"], c["Hkv"], c["D"]
    rng = np.random.default_rng(SEED + 100 + i)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)
    if kind != "paged_prefill":
        row = kind[len("paged_"):]
        args, _, longest = paged_operands(row, "none", rng, dev, heads, hkv,
                                          d, gen)
        q, kp, vp, pt, ln = args
        call = (lambda impl="auto": paged_call(row)(*args, impl=impl))
        lib, lib_ops = paged_sdpa(row, args, heads)
        extra = {"cold": (lambda *a: paged_call(row)(*a, impl="cuda"), args,
                          lib, lib_ops)}
        if row == "verify":
            extra["decode_rows"] = [
                (lambda s=s: ops.paged_decode_attention(
                    q[:, s].contiguous(), kp, vp, pt, ln[:, s].contiguous()))
                for s in range(q.shape[1])]
        kv = 2 * int(longest.sum()) * hkv * d * 2 + pt.numel() * 4
        return (call, lambda: lib(*lib_ops),
                q.numel() * 2 * 2 + ln.numel() * 4 + kv,
                4 * int(ln.sum()) * heads * d, extra)
    mode = _MODE_OF[DENSE_CASES[i][1]]
    args, kw, frames = prefill_operands(mode, rng, dev, heads, hkv, d, gen)
    call = (lambda impl="auto": ops.paged_prefill_attention(
        *args, impl=impl, **kw))
    lib, lib_ops = (prefill_sdpa(args, heads) if mode == "none"
                    else (None, None))
    return (call, None if lib is None else (lambda: lib(*lib_ops)),
            *prefill_work(args, frames, mode),
            {"lengths": list(PREFILL_LENGTHS),
             "cold": (*prefill_cold(args, kw), lib, lib_ops)})


def ssm_inputs(kind: str, c: dict, dt, rand):
    """A recurrence case of :data:`DENSE_CASES`, drawn as the reference's
    test draws it, the decay path in f32: (call, sequential oracle or
    None, bytes, flops, (kernel, operands) for :func:`cold_times`).  The
    flops are the chunked form's products."""
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
                2 * B * H * chunks * per_chunk,
                ((lambda *a: ops.wkv6(*a, impl="cuda", chunk=n)),
                 (r, k, v, w, u)))
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
            B * H * chunks * per_chunk,
            ((lambda *a: ops.ssd(*a, impl="cuda", chunk=n)),
             (x, dts, A, Bm, Cm, Dh)))


def dense_inputs(i: int, dev):
    """Case ``i`` of :data:`DENSE_CASES`: (call, library call or None,
    bytes, flops, extra), where ``call(impl)`` runs the ops entry point
    on inputs drawn from generators seeded by ``i`` (phase 6 draws them
    again) and ``extra`` is a matmul's operands (x, w), which its call
    and library call also take as arguments, or for every other case
    ``{"cold": (kernel, operands, library call or None, its operands)}``
    for :func:`cold_times`, with a recurrence's sequential oracle
    (``seq``, or None), a verify case's per-row decode calls and a
    prefill case's ``lengths``."""
    kind, dt, _, c = DENSE_CASES[i]
    if kind in _PAGED_ROW:
        return paged_inputs(kind, c, i, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + i)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dt)

    if kind in _NO_LIBRARY:
        call, seq, nbytes, flops, cold = ssm_inputs(
            kind, c, dt, lambda *shape: torch.randn(
                *shape, generator=gen, device=dev))
        return call, None, nbytes, flops, {
            "seq": seq, "cold": (*cold, None, None, SSM_LAUNCHES)}
    el = torch.tensor([], dtype=dt).element_size()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if kind == "matmul":
        M, K, N = c["M"], c["K"], c["N"]
        x, w = rand(M, K), rand(K, N)
        tiles = {t: c[t] for t in ("bm", "bk", "bn") if t in c}
        return ((lambda impl="auto", x=x, w=w: ops.matmul(
                    x, w, impl=impl, **tiles)),
                (lambda x=x, w=w: torch.matmul(x, w)),
                (M * K + K * N + M * N) * el, 2 * M * K * N, (x, w))
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
        if off == 0 and Sq == kvv:
            lib_ops, lib_call = (qs, ks, vs), (
                lambda *a: sdpa(*a, is_causal=True))
        else:
            lib_ops, lib_call = (qs, ks, vs, mask), (
                lambda *a: sdpa(*a[:3], attn_mask=a[3]))
        pairs = sum(min(off + t + 1, kvv) for t in range(Sq))
        cold = (lambda *a: ops.flash_attention(*a, causal=True, impl="cuda",
                                               q_offset=off, kv_valid=kvv),
                (q, k, v), lib_call, lib_ops)
        return ((lambda impl="auto": ops.flash_attention(
                    q, k, v, causal=True, impl=impl, q_offset=off,
                    kv_valid=kvv)), (lambda: lib_call(*lib_ops)),
                (2 * B * Sq * H * D + 2 * B * kvv * Hkv * D) * el,
                4 * B * H * D * pairs, {"cold": cold})
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
            4 * B * H * valid * D, {"cold": (
                lambda *a: ops.decode_attention(*a, valid_len=valid,
                                                impl="cuda", bkv=c["bkv"]),
                (q, k, v), sdpa, (qs, ks, vs))})


def _rel(out, ref) -> tuple:
    """(max |err|, max |err| / max |ref|) of two outputs, in f32."""
    o, r = out.float(), ref.float()
    err = float((o - r).abs().max())
    return err, err / float(r.abs().max())


def check_selection(what: str, call, x, w, seed: int) -> None:
    """A bf16 matmul's w replaced by a selection matrix, w[src[n], n] = 1:
    every output column must be x's column src[n] bit for bit (a wrong
    bit of a shared-memory descriptor gives plausible but wrong
    numbers)."""
    (K, N), dev = w.shape, w.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randperm(max(K, N), generator=gen, device=dev)[:N] % K
    sel = torch.zeros_like(w)
    sel[src, torch.arange(N, device=dev)] = 1
    bad = (call("cuda", x, sel) != x[:, src]).any(dim=0).sum()
    require(int(bad) == 0, f"{what}: {int(bad)} of {N} output columns of a "
            "selection matrix are not x's columns")


def library_kernels(call) -> list:
    """The names of the CUDA kernels one ``call()`` launches, from
    ``torch.profiler`` (after a warm-up call): which kernel a library
    call takes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sorted({ev.name for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA})


def _rotated(operands) -> tuple:
    """``operands`` and copies of them spanning :data:`ROTATE_BYTES`
    (at most :data:`MAX_SETS` sets), and the bytes they span."""
    nbytes = sum(t.numel() * t.element_size() for t in operands)
    n_sets = min(MAX_SETS, -(-ROTATE_BYTES // nbytes))
    return ([operands] + [tuple(t.clone() for t in operands)
                          for _ in range(n_sets - 1)], n_sets * nbytes)


def cold_times(kernel, operands, library, lib_operands,
               launches: int = 1) -> dict:
    """A case timed as phase 2g times the gathers (:func:`cold_ms`:
    L2 flushed, copies of the operands spanning :data:`ROTATE_BYTES`
    rotated, the calls queued behind a device sleep, so neither L2 nor
    the wrapper's host work enters), the kernel and the library call
    alike (``library`` None: there is none), with each one's one-call
    :func:`time_ms` beside it; ``launches``: the kernels one call of
    ``kernel`` enqueues."""
    sets, span = _rotated(operands)
    times = {"ms": cold_ms(kernel, sets, launches=launches),
             "one_call_ms": time_ms(lambda: kernel(*operands)),
             "library_ms": None, "library_one_call_ms": None,
             "sets_span_bytes": span}
    del sets
    if library is not None:
        lib_sets, _ = _rotated(lib_operands)
        times["library_ms"] = cold_ms(library, lib_sets)
        times["library_one_call_ms"] = time_ms(
            lambda: library(*lib_operands))
        del lib_sets
    return times


def cold_case(kind: str, call, extra):
    """(kernel, operands, library call, its operands) of a case timed by
    :func:`cold_times`: every matmul (the operands are (x, w)), and the
    cases whose inputs carry ``{"cold": ...}``; None for the others."""
    if kind == "matmul":
        return (lambda x, w: call("cuda", x, w), extra,
                lambda x, w: torch.matmul(x, w), extra)
    return extra["cold"] if isinstance(extra, dict) else None


def launch_shape(kind: str, dt, shape: dict, dev) -> dict:
    """The card's choice for a case, as its wrapper makes it: the f32
    matmul's (bm, bn, stages), a dense decode case's split count, a
    recurrence's plan."""
    props = torch.cuda.get_device_properties(dev)
    if kind == "matmul" and dt == torch.float32:
        return {"tile": list(mm_mod.f32_tiles(
            shape["M"], shape["N"], props.multi_processor_count,
            props.shared_memory_per_block_optin))}
    if kind == "flash" and dt == torch.float32 \
            and hasattr(pre_mod, "f32_flash_plan"):
        return {"warps_q": pre_mod.f32_flash_plan(
            shape["B"], shape["H"], shape["Sq"], props.multi_processor_count)}
    if kind == "decode":
        return {"splits": dec_mod.decode_splits(
            shape["B"], shape["Hkv"], shape["H"] // shape["Hkv"],
            min(shape["valid"], shape["Skv"]), props.multi_processor_count)}
    if kind in _NO_LIBRARY and hasattr(rwkv6, "wkv6_plan"):
        c = min(shape["chunk"], shape["T"])
        plan = (rwkv6.wkv6_plan(shape["B"], shape["T"], shape["H"],
                                shape["K"], shape["K"], c,
                                props.multi_processor_count,
                                props.shared_memory_per_block_optin)
                if kind == "wkv6" else
                mamba2.ssd_plan(shape["B"], shape["T"], shape["H"],
                                shape["P"], shape["N"], c,
                                props.multi_processor_count,
                                props.shared_memory_per_block_optin))
        return {"plan": plan._asdict()}
    if kind in ("paged_decode", "paged_verify"):
        span = dec_mod.paged_split_positions(
            len(DECODE_LENGTHS), shape["Hkv"], shape["H"] // shape["Hkv"],
            2048, props.multi_processor_count)
        return {"split_positions": span, "ranges": -(-2048 // span)}
    return {}


def f32_tile_times(operands, out) -> dict:
    """Cold ms (:func:`cold_ms`) of every tile of ``amu_matmul.F32_TILES``
    on an f32 matmul's operands through the C entry point, keyed
    ``"BMxBN"``; each tile's output must be bitwise ``out``, the
    wrapper's.  What phase 2d holds the tile rule's pick against."""
    x, w = operands
    (M, K), N = x.shape, w.shape[1]
    kernel = mm_mod.KERNELS[torch.float32]
    sets, _ = _rotated(operands)
    times = {}
    for bm, bn in mm_mod.F32_TILES:
        def run(a, b, bm=bm, bn=bn):
            o = torch.empty(M, N, device=a.device)
            kernel.launch(a.data_ptr(), b.data_ptr(), o.data_ptr(), M, K, N,
                          bm, bn, mm_mod.F32_STAGES,
                          torch.cuda.current_stream(a.device).cuda_stream)
            return o
        require(torch.equal(run(x, w), out),
                f"f32 matmul {M}x{K}x{N}: tile ({bm}, {bn}) moved a bit")
        times[f"{bm}x{bn}"] = cold_ms(run, sets)
    del sets
    return times


def f32_matmul_digest(outs) -> str:
    """sha256 of phase 2d's f32 matmul outputs, in case order: the card's
    tile may move no bit of them."""
    h = hashlib.sha256()
    for (kind, dt, _, _), out in zip(DENSE_CASES, outs):
        if kind == "matmul" and dt == torch.float32:
            h.update(out.numpy().tobytes())
    return h.hexdigest()


def check_case(i: int, dev):
    """Case ``i``: kernel against plain version at its bar (and a verify
    case's rows against the decode kernel, bitwise; an f32 recurrence
    against its sequential oracle too; a bf16 matmul against a selection
    matrix, exactly), timed; returns (the case's numbers, the kernel
    output on the host)."""
    kind, dt, label, shape = DENSE_CASES[i]
    call, lib, nbytes, flops, extra = dense_inputs(i, dev)
    out, ref = call("cuda"), call("torch")
    torch.cuda.synchronize()
    what = f"{kind} {label} ({dt})"
    require(torch.isfinite(out.float()).all(), f"{what}: non-finite")
    if kind == "paged_prefill":          # rows past lengths: don't-care
        errs = [agree(what, out[c, :m], ref[c, :m])
                for c, m in enumerate(extra["lengths"])]
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
    if kind in _NO_LIBRARY and dt == torch.float32 and extra["seq"]:
        seq_rel = _rel(out, extra["seq"]())[1]
        require(seq_rel < SSM_SEQ_TOL, f"{what} disagrees with the "
                f"sequential oracle: {seq_rel:.3e} (bar {SSM_SEQ_TOL})")
        acc["seq_rel_err"] = seq_rel
    if kind == "paged_verify":
        diff = max(float((out[:, s].float() - one().float()).abs().max())
                   for s, one in enumerate(extra["decode_rows"]))
        require(diff == 0, f"{what}: row s is not bitwise the decode "
                "kernel at lengths[:, s]")
        acc["vs_decode"] = diff
    if kind == "matmul" and dt == torch.bfloat16:
        check_selection(what, call, *extra, SEED + 300 + i)
    cold = cold_case(kind, call, extra)
    tile_ms = (f32_tile_times(extra, out)
               if kind == "matmul" and dt == torch.float32 else None)
    b_ms, b_by, routes = case_bound(kind, nbytes, flops, dt)
    case = {"case": label, **shape, **launch_shape(kind, dt, shape, dev),
            "max_abs_err": err, **acc,
            **(cold_times(*cold) if cold else {
                "ms": time_ms(lambda: call("cuda")),
                "library_ms": None if lib is None else time_ms(lib)}),
            "plain_ms": time_ms(lambda: call("torch"),
                                reps=3 if kind in _NO_LIBRARY else 10),
            "bound_ms": b_ms, "bound_by": b_by}
    if kind in _NO_LIBRARY:
        case["library"] = _NO_LIBRARY[kind]
    if routes:
        case["bound_routes_ms"] = routes
    if kind == "flash" and dt == torch.float32:
        case["library_kernels"] = library_kernels(lib)
        print(f"[dense] {what}: SDPA's kernels {case['library_kernels']}")
    if tile_ms:
        case["tile_ms"] = tile_ms
    lib_txt = (_NO_LIBRARY.get(kind, "n/a") if case["library_ms"] is None
               else f"{case['library_ms']:.4f}")
    if cold and case["library_ms"] is not None:
        lib_txt += (f" (cold; one call {case['library_one_call_ms']:.4f}) "
                    f"kernel/library {case['ms'] / case['library_ms']:.2f}x"
                    + (", selection matrix exact"
                       if kind == "matmul" and dt == torch.bfloat16 else ""))
    if "tile" in case or "splits" in case:
        lib_txt += (f" tile {case['tile']}" if "tile" in case
                    else f" splits {case['splits']}")
    if "warps_q" in case:
        lib_txt += f" warps_q {case['warps_q']}"
    if "plan" in case:
        plan = case["plan"]
        lib_txt += (f" plan rows {plan['rows']} seg {plan['seg']} segments "
                    f"{plan['segments']} blocks {plan['blocks']} workspace "
                    f"{plan['workspace_bytes']} B")
    if routes:
        lib_txt += (f" (bound by route: CUDA cores {routes['cuda_cores_ms']:.4f}"
                    f", 3xTF32 {routes['tf32x3_ms']:.4f})")
    if "split_positions" in case:
        lib_txt += (f" split_positions {case['split_positions']} ranges "
                    f"{case['ranges']}")
    if tile_ms:
        lib_txt += " (every tile cold: " + ", ".join(
            f"{t} {ms:.4f}" for t, ms in tile_ms.items()) + ")"
    print(f"[dense] {what}: kernel_ms {case['ms']:.4f}"
          + (f" (cold; one call {case['one_call_ms']:.4f})" if cold else "")
          + f" plain_ms {case['plain_ms']:.4f} library_ms {lib_txt} bound_ms "
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
    sources = {k.name: k.source for k in (*ops.DENSE_KERNELS,
                                          *ops.SSM_KERNELS)}
    for i, (kind, dt, _, _) in enumerate(DENSE_CASES):
        case, out = check_case(i, dev)
        outs.append(out)
        if kind in _PAGED_ROW:
            mode = _MODE_OF[dt]
            paged.setdefault(_PAGED_ROW[kind] + (
                "" if mode == "none" else f"_{mode}"), []).append(case)
            continue
        src, replaces = _DENSE_SOURCE[kind]
        name = f"{src}_{'f32' if dt == torch.float32 else 'bf16'}"
        if name not in rows:
            rows[name] = {
                "name": name, "route": "cuda",
                "source": str(sources[name].relative_to(ROOT)),
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": None,
                **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                "cases": []}
            if "library" in case:
                rows[name]["library"] = case["library"]
        rows[name]["cases"].append(case)
    print(f"[dense] f32 matmul outputs sha256 {f32_matmul_digest(outs)}")
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


#: phase 2g: (entry point, dtype, what the case is, shape); f32 at the
#: reference's test shapes (``tests/test_kernels.py:164-183``), bf16 at
#: olmoe-1b-7b's full width with the indices its MoE block computes from
#: a normal draw (``moe="dispatch"``: a row per capacity slot of B rows
#: of S tokens, from the tokens with a zero row appended; ``"combine"``:
#: a row per (token, choice) pair of their expert outputs), and the paged-KV fetch ``decode_attention.py:200-205``
#: names: 128 of a 448-frame pool's frames of 16 rows of 8 x 128; last
#: (appended, so every earlier case keeps its seed) the decode combine.
GATHER_CASES = (
    ("rows", torch.float32, "reference N64 d128 M32 rpb8",
     dict(N=64, d=128, M=32, rpb=8)),
    ("rows", torch.float32, "reference N128 d256 M64 rpb16",
     dict(N=128, d=256, M=64, rpb=16)),
    ("rows", torch.float32, "reference N32 d128 M8 rpb8",
     dict(N=32, d=128, M=8, rpb=8)),
    ("blocks", torch.float32, "reference (64, 128), 6 blocks of 8",
     dict(N=64, d=128, Mb=6, rows=8)),
    ("rows", torch.bfloat16, "olmoe decode dispatch, 8 x 64 experts x 1",
     dict(moe="dispatch", B=8, S=1)),
    ("rows", torch.bfloat16, "olmoe prefill dispatch, 2 x 64 experts x 40",
     dict(moe="dispatch", B=2, S=256)),
    ("rows", torch.bfloat16, "olmoe prefill combine, 2 x 256 tokens x top-8",
     dict(moe="combine", B=2, S=256)),
    ("blocks", torch.bfloat16, "paged-KV fetch, 128 frames of 448",
     dict(N=448 * PAGE, d=HKV * D, Mb=128, rows=PAGE)),
    ("rows", torch.bfloat16, "olmoe decode combine, 8 tokens x top-8",
     dict(moe="combine", B=8, S=1)),
)
_GATHER_SOURCE = {"rows": "moe_gather.py:70", "blocks": "moe_gather.py:104"}


def gather_inputs(i: int, dev):
    """Case ``i`` of :data:`GATHER_CASES`: (inputs, call, plain, bytes,
    shape of the work), with inputs drawn from a generator seeded by
    ``i`` (phase 6 draws them again).  ``call(*inputs, impl=...)`` runs
    the entry point; ``plain(*inputs)`` is ``torch.index_select``, its
    plain version and the one PyTorch call that computes the function.
    The bytes are the bound's: each distinct source row read once, each
    output row written once, and the indices."""
    kind, dt, _, c = GATHER_CASES[i]
    gen = torch.Generator(device=dev).manual_seed(SEED + 200 + i)
    el = torch.tensor([], dtype=dt).element_size()
    if kind == "blocks":
        N, d, Mb, rows = c["N"], c["d"], c["Mb"], c["rows"]
        src = torch.randn(N, d, generator=gen, device=dev).to(dt)
        bidx = torch.randperm(N // rows, generator=gen, device=dev)[:Mb]
        bidx = bidx.to(torch.int32)
        row_bytes = rows * d * el
        return ((src, bidx),
                (lambda s, b, impl="auto": moe_gather.gather_blocks(
                    s, b, block_rows=rows, impl=impl)),
                (lambda s, b: torch.index_select(
                    s.view(N // rows, rows, d), 0, b)),
                (torch.unique(bidx).numel() + Mb) * row_bytes + 4 * Mb,
                dict(N=N, d=d, Mb=Mb, block_rows=rows))
    if "moe" in c:
        cfg = get_config(MOE_ARCH)
        B, S, d, E = c["B"], c["S"], cfg.d_model, cfg.num_experts
        x = torch.randn(B, S, d, generator=gen, device=dev).to(dt)
        router = {"w": torch.randn(d, E, generator=gen, device=dev) * d ** -0.5}
        plan = moe.dispatch({"router": router}, cfg, x)
        if c["moe"] == "dispatch":         # as moe_block: a zero row appended
            src = torch.cat([x.reshape(B * S, d), x.new_zeros(1, d)])
            idx = plan.tokens
        else:
            src = torch.randn(B * E * plan.capacity, d, generator=gen,
                              device=dev).to(dt)
            idx = plan.slots
        rpb = moe.rows_per_block(idx.shape[0])
    else:
        N, d, M, rpb = c["N"], c["d"], c["M"], c["rpb"]
        src = torch.randn(N, d, generator=gen, device=dev).to(dt)
        idx = torch.randint(0, N, (M,), generator=gen, device=dev,
                            dtype=torch.int32)
    M, d = idx.shape[0], src.shape[1]
    return ((src, idx),
            (lambda s, x, impl="auto": ops.gather_rows(
                s, x, impl=impl, rows_per_block=rpb)),
            (lambda s, x: torch.index_select(s, 0, x)),
            (torch.unique(idx).numel() + M) * d * el + 4 * M,
            dict(N=src.shape[0], d=d, M=M, rows_per_block=rpb))


def gather_route(kind: str, inputs, block_rows: int = 1) -> dict:
    """The gather's plan for a case's inputs (``moe_gather.gather_plan``:
    route, piece bytes, threads a block, blocks): a block gather's over
    rows of ``block_rows`` source rows, since it is the row gather on
    that view; {} for a tree without the plan."""
    plan = getattr(moe_gather, "gather_plan", None)
    if plan is None:
        return {}
    src, idx = inputs
    rows = block_rows if kind == "blocks" else 1
    p = plan(idx.shape[0], rows * src.shape[1] * src.element_size(),
             dec_mod.sm_count(src.device), elem_bytes=src.element_size(),
             aligned=src.data_ptr() % 16 == 0)
    return {"gather_route": p.route, "piece_bytes": p.piece_bytes,
            "threads": p.threads, "blocks": p.blocks}


def check_gathers(dev):
    """Phase 2g: every case of :data:`GATHER_CASES`, kernel against plain
    version bitwise, both timed cold (:func:`cold_ms`) and held to the
    byte bound; returns one ``{"kernels": [...]}`` row per gather entry
    point (its first case's numbers, every case under ``cases``) and
    each case's kernel output, on the host, for phase 6."""
    rows, outs = {}, []
    for i, (kind, dt, label, _) in enumerate(GATHER_CASES):
        inputs, call, plain, nbytes, shape = gather_inputs(i, dev)
        out, ref = call(*inputs, impl="cuda"), call(*inputs, impl="torch")
        torch.cuda.synchronize()
        what = f"gather_{kind} {label} ({dt})"
        require(torch.equal(out, ref), f"{what}: not bitwise the plain "
                "version")
        b_ms, b_by = bound(nbytes, 0, dt)
        n_sets = min(MAX_SETS, -(-ROTATE_BYTES // nbytes))
        sets = [inputs] + [tuple(t.clone() for t in inputs)
                           for _ in range(n_sets - 1)]
        ms = cold_ms(lambda *a: call(*a, impl="cuda"), sets)
        plain_ms = cold_ms(plain, sets)
        del sets
        require(min(ms, plain_ms) >= b_ms, f"{what}: {min(ms, plain_ms)} ms "
                f"under its bound {b_ms} ms: the timing or the bound is wrong")
        route = gather_route(kind, inputs, shape.get("block_rows", 1))
        case = {"case": label, **shape, **route,
                "max_abs_err": 0.0, "bitwise": True,
                "ms": ms, "plain_ms": plain_ms, "library_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "sets_span_bytes": n_sets * nbytes}
        print(f"[gather] {what}: kernel_ms {ms:.4f} index_select_ms "
              f"{plain_ms:.4f} kernel/library {ms / plain_ms:.2f}x "
              f"(plain version and library call) bound_ms "
              f"{b_ms:.4f} ({b_by}, {nbytes} B); {n_sets} input sets spanning "
              f"{n_sets * nbytes / 2**20:.1f} MiB; "
              f"{shape}, {route}, bitwise")
        outs.append(out.cpu())
        name = f"gather_{kind}_{'f32' if dt == torch.float32 else 'bf16'}"
        if name not in rows:
            rows[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/moe_gather.cu",
                "replaces": f"src/repro/kernels/{_GATHER_SOURCE[kind]}",
                "launches": None,
                **{k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
                "library": "torch.index_select", "cases": []}
        rows[name]["cases"].append(case)
    return list(rows.values()), outs


def run_gather_path(dev, outs) -> dict:
    """Phase 6, the gathers: every case of phase 2g once through its
    entry point (``ops.gather_rows``, ``moe_gather.gather_blocks``) as a
    user calls it, with the default impl; each output must be bitwise
    phase 2g's kernel output.  Returns the launch counts of this run."""
    for k in ops.GATHER_KERNELS:
        k.launches = 0
    for i, (kind, dt, label, _) in enumerate(GATHER_CASES):
        inputs, call = gather_inputs(i, dev)[:2]
        out = call(*inputs)
        torch.cuda.synchronize()
        require(torch.equal(out.cpu(), outs[i]),
                f"gather_{kind} {label} ({dt}): the default impl's output is "
                "not phase 2g's kernel output")
    launches = {k.name: k.launches for k in ops.GATHER_KERNELS}
    print(f"[gather] entry-point launches in phase 6: {launches}")
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


def serve_moe(dev):
    """Phase 7: the 12 requests of phase 3 with its engine settings on
    olmoe-1b-7b at full width (random bf16 weights from the seed), then
    on a roomy pool; returns (cfg, params, kernel launches of the
    preempting run)."""
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, gen, dev), torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[moe] {MOE_ARCH} params ready in {time.perf_counter() - t0:.3f}s,"
          f" {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    kernels = (*ops.KERNELS, *ops.GATHER_KERNELS)
    reset_peak()
    for k in kernels:
        k.launches = 0
    eng, out, wall = serve(cfg, params, "cuda", ENGINE["device_pages"],
                           clock=time.perf_counter)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(v) for v in out.values())
    ttft = [r.ttft for r in eng.finished.values()]
    print(f"[moe] {len(out)} requests, {n_tok} tokens in {wall:.2f}s "
          f"({n_tok / wall:.1f} tok/s), mean TTFT {np.mean(ttft):.3f}s, "
          f"steps {eng.stats['steps']} (mixed {eng.stats['mixed_steps']}), "
          f"peak memory {peak:.2f} GiB")
    print(f"[moe] preemptions {eng.stats['preemptions']} resumes "
          f"{eng.stats['resumes']} chunks {eng.stats['chunks']}; pager "
          f"{dict(eng.pager.stats)}; kernel launches "
          f"{ {n: c for n, c in launches.items() if c} }")
    require(len(out) == N_REQUESTS, f"moe: {len(out)} of {N_REQUESTS} "
            "finished")
    require(all(len(v) == NEW_TOKENS for v in out.values()),
            "moe: token counts")
    require(all(0 <= t < cfg.padded_vocab for v in out.values() for t in v),
            "moe: token ids out of the vocabulary")
    for k in (dec_mod.KERNEL, pre_mod.KERNEL,
              moe_gather.KERNELS[torch.bfloat16]):
        require(launches[k.name] > 0,
                f"kernel {k.name} never launched on the MoE path")
    require(eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0,
            "moe: the pool never preempted/resumed")
    print(f"[moe] tokens digest {tokens_digest(out)}")
    del eng
    pps = ENGINE["max_len"] // ENGINE["page_size"]
    roomy, rout, r_wall = serve(cfg, params, "cuda",
                                ENGINE["max_batch"] * pps)
    same = sum(a == b for r in out for a, b in zip(out[r], rout[r]))
    print(f"[moe] roomy pool: preemptions {roomy.stats['preemptions']}, "
          f"steps {roomy.stats['steps']}, {n_tok / r_wall:.1f} tok/s; "
          f"tokens equal to the preempting run: {same}/{n_tok}")
    require(same == n_tok, "moe: the roomy pool's tokens differ from the "
            "preempting run's")
    return cfg, params, launches


def check_moe_steps(cfg, params, dev):
    """Phase 7s: one full-width prefill chunk over the engine's batch of
    rows, then one decode step over the pool it filled, kernels against
    plain versions on identical fresh caches; then one layer's MoE block
    with its gathers on the kernel against the same block with them
    plain, bitwise, at a decode step's and a chunk's shapes."""
    rng = np.random.default_rng(SEED + 2)
    B, T = ENGINE["max_batch"], 256
    per_row = -(-(T + 1) // PAGE)
    n_frames = B * per_row + 1
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)).to(dev)
    rows = torch.full((B, 32), n_frames - 1, dtype=torch.int32, device=dev)
    rows[:, :per_row] = torch.arange(B * per_row, dtype=torch.int32,
                                     device=dev).reshape(B, per_row)
    chunk = {"tokens": toks, "page_rows": rows,
             "offset": torch.zeros(B, dtype=torch.int32, device=dev),
             "length": torch.tensor([256, 217, 256, 100, 1, 256, 180, 33],
                                    dtype=torch.int32, device=dev)}
    res = {}
    for impl in ("cuda", "torch"):
        cache = init_paged_cache(cfg, B, 512, n_frames, PAGE, device=dev)
        cl, cache = prefill_chunk(params, cfg, cache, chunk, impl=impl)
        cache.kv["page_table"].copy_(rows)
        cache = cache._replace(pos=chunk["length"].clone())
        dl, _ = decode_step(params, cfg, cache, toks[:, -1:], impl=impl)
        res[impl] = (cl.float(), dl.float())
    for i, name in enumerate(("chunk", "decode")):
        a, b = res["cuda"][i], res["torch"][i]
        require(a.shape == (B, cfg.padded_vocab), f"moe {name}: {a.shape}")
        require(torch.isfinite(a).all(), f"moe {name} logits: non-finite")
        rel = float((a - b).norm() / b.norm())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"[moe:steps] {name} logits kernels vs plain: rel err "
              f"{rel:.3e}, argmax agreement {same:.2f}")
        require(rel < 0.05, f"moe {name} logits rel err {rel}")
    mlp = params["layers"]["mlp"]
    layer = {"router": {"w": mlp["router"]["w"][0]},
             **{n: mlp[n][0] for n in ("gate", "up", "down")}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for nrows, S in ((B, 1), (2, T)):
        x = torch.randn(nrows, S, cfg.d_model, generator=gen,
                        device=dev).bfloat16()
        out, _ = moe.moe_block(layer, cfg, x, impl="cuda")
        plain, _ = moe.moe_block(layer, cfg, x, impl="torch")
        require(torch.isfinite(out.float()).all(), "moe block: non-finite")
        require(torch.equal(out, plain), f"moe block ({nrows} x {S}): the "
                "kernel gathers' output is not bitwise the plain gathers'")
        print(f"[moe:steps] moe_block {nrows} x {S} x {cfg.d_model}: kernel "
              "gathers bitwise the plain gathers")


_ELEM = re.compile(r"kernelI(13__nv_bfloat16|13__nv_fp8_e4m3|a|f)[LE]")
_ELEM_NAME = {"13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "fp8",
              "a": "int8", "f": "f32"}


def ptxas_summary(log: str, default: str = "?"):
    """Per element type of one library's ``nvcc -Xptxas -v`` log:
    (instantiations, fewest and most registers, largest spill store in
    bytes, instantiations that spill); ``default`` names the element
    type of kernels whose template does not."""
    out, elem = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            found = _ELEM.search(m.group(1))
            elem = _ELEM_NAME[found.group(1)] if found else default
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


def sass_counts(library: Path, opcodes) -> dict:
    """How many instructions of each opcode a library's SASS holds
    (``cuobjdump --dump-sass``, from the CUDA toolkit beside ``nvcc``)."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in opcodes}


def _kind(name: str) -> str:
    if any(k in name for k in ("paged_attention_kernel", "paged_prefill",
                                "flash_attention", "combine_kernel")):
        return "attention kernels"
    if "gather_rows_kernel" in name:      # both gathers' one kernel
        return "gather kernels"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies"
    return "other kernels"


def _suffixed(path: Path, tag: str) -> Path:
    return path.with_name(f"{path.stem}-{tag}{path.suffix}")


def profile_engine(cfg, params, runs) -> None:
    """One more (warm) engine run of each of ``runs`` — (tag, proposer
    factory, kv_quant, table path) — under ``torch.profiler``: device
    time by kind of kernel, and the device's busy share of the wall
    time; the per-kernel table goes to the path."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for tag, factory, kv_quant, table in runs:
        table.parent.mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = serve(cfg, params, "cuda", ENGINE["device_pages"],
                               proposer_factory=factory, kv_quant=kv_quant)
        kinds, split = {}, {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                k = _kind(ev.name)
                us = ev.time_range.elapsed_us()
                kinds[k] = kinds.get(k, 0.0) + us / 1e3
                if any(k in ev.name for k in (
                        "paged_attention_kernel", "combine_kernel",
                        "paged_prefill", "gather_rows_kernel")):
                    n, t = split.get(ev.name, (0, 0.0))
                    split[ev.name] = (n + 1, t + us)
        busy = sum(kinds.values())
        print(f"[profile:{tag}] profiled run: {wall:.3f}s wall, device busy "
              f"{busy / 1e3:.3f}s ({busy / (wall * 1e3):.3f} of wall)")
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
            print(f"[profile:{tag}] {k}: {ms / 1e3:.3f}s ({ms / busy:.3f} of "
                  f"device time)" if busy else f"[profile:{tag}] {k}: 0")
        # the paged decode (R = G rows a block) and verify (R = S * G)
        # instances, the split-KV combine, the paged prefill instances
        # and the gathers, by name
        for name, (n, us) in sorted(split.items(), key=lambda kv: -kv[1][1]):
            print(f"[profile:{tag}] {name}: {us / 1e6:.4f}s over {n} "
                  f"launches ({us / n:.1f} us each)")
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
    every = (*ops.KERNELS, *ops.DENSE_KERNELS, *ops.SSM_KERNELS,
             *ops.GATHER_KERNELS)
    secs = build_all(every)
    sources = {k.source.name: k.build_log for k in every}
    print(f"[build] {len(every)} entry points from {len(sources)} "
          f"sources in {secs:.1f}s")
    # the TMA / wgmma libraries: bf16 matmul, dense flash, paged prefill
    sm90 = (mm_mod.KERNELS[torch.bfloat16], pre_mod.DENSE_KERNELS[
        torch.bfloat16], pre_mod.KERNELS[torch.bfloat16])
    sm90_names = {k.source.name for k in sm90}
    # and the cp.async rings of the f32 matmul and the dense decode must
    # not spill either
    # (and, since the split over KV ranges, the paged decode and verify)
    paged_libs = (dec_mod.KERNEL, dec_mod.VERIFY_KERNEL)
    # (and, since their redesign, the f32 dense flash and the gathers,
    # and the int8 / fp8 paged prefill)
    flash_lib = pre_mod.DENSE_KERNELS[torch.float32]
    gather_lib = moe_gather.KERNELS[torch.bfloat16]
    quant_lib = pre_mod.KERNELS[torch.int8]
    # (and, since their redesign, the chunk-parallel recurrences)
    ssm_libs = (rwkv6.KERNELS[torch.float32], mamba2.KERNELS[torch.float32])
    no_spill = sm90_names | {mm_mod.KERNELS[torch.float32].source.name,
                             dec_mod.DENSE_KERNELS[torch.float32].source.name,
                             *(k.source.name for k in paged_libs),
                             flash_lib.source.name, gather_lib.source.name,
                             quant_lib.source.name,
                             *(k.source.name for k in ssm_libs)}
    f32_names = {mm_mod.KERNELS[torch.float32].source.name,
                 flash_lib.source.name}
    for name, log in sources.items():
        summary = ptxas_summary(log, "bf16" if name in sm90_names
                                else "f32" if name in f32_names else "?")
        for elem, (n, lo, hi, spill, n_spill) in summary.items():
            print(f"[build] {name} {elem}: {n} instantiations, registers "
                  f"{lo}-{hi}, largest spill store {spill} B "
                  f"({n_spill} spilling)")
            require(name not in no_spill or n_spill == 0,
                    f"{name}: {n_spill} instantiations spill")
    for k in sm90:
        sass = sass_counts(k.library_path(), ("HGMMA", "UTMALDG"))
        print(f"[build] {k.source.name} SASS: {sass}")
        require(all(sass.values()), f"{k.source.name}: no tensor-core "
                f"products or no TMA loads in its SASS: {sass}")
    # the int8 / fp8 paged prefill: wgmma on the widened tiles, q by TMA,
    # the 1-byte rows by cp.async
    sass = sass_counts(quant_lib.library_path(),
                       ("HGMMA", "UTMALDG", "LDGSTS", "PRMT", "F2FP"))
    print(f"[build] {quant_lib.source.name} SASS: {sass}")
    require(sass["HGMMA"] > 0 and sass["UTMALDG"] > 0 and sass["LDGSTS"] > 0,
            f"{quant_lib.source.name}: no tensor-core products, TMA loads "
            f"or cp.async copies in its SASS: {sass}")
    # the paged kernels' K/V ring: its cp.async copies in the SASS
    for k in paged_libs:
        sass = sass_counts(k.library_path(), ("LDGSTS",))
        print(f"[build] {k.source.name} SASS: {sass}")
        require(sass["LDGSTS"] > 0, f"{k.source.name}: no cp.async copies")
    # the f32 flash kernel's TF32 tensor-core products and cp.async ring,
    # and the gathers' 16-byte copies
    sass = sass_counts(flash_lib.library_path(),
                       ("HMMA.1688.F32.TF32", "HMMA", "LDGSTS", "FFMA",
                        "LDS.128", "LOP3.LUT", "MUFU.EX2"))
    print(f"[build] {flash_lib.source.name} SASS: {sass}")
    require(sass["HMMA.1688.F32.TF32"] > 0 and sass["LDGSTS"] > 0,
            f"{flash_lib.source.name}: no TF32 HMMA or no cp.async copies")
    # the recurrences' TF32 tensor-core products (mma.sync, both instances)
    for k in ssm_libs:
        sass = sass_counts(k.library_path(),
                           ("HMMA.1688.F32.TF32", "HMMA", "MUFU.EX2",
                            "SHFL.UP"))
        print(f"[build] {k.source.name} SASS: {sass}")
        require(sass["HMMA.1688.F32.TF32"] > 0,
                f"{k.source.name}: no TF32 HMMA in its SASS")
    sass = sass_counts(gather_lib.library_path(),
                       ("LDG.E.128", "STG.E.128"))
    print(f"[build] {gather_lib.source.name} SASS: {sass}")
    require(sass["LDG.E.128"] > 0 and sass["STG.E.128"] > 0,
            f"{gather_lib.source.name}: no 16-byte loads or stores")
    # the f32 matmul's fmaf beside its copies, shared loads and the
    # integer ops that address and mask the copies (both instances)
    f32_lib = mm_mod.KERNELS[torch.float32]
    print(f"[build] {f32_lib.source.name} SASS: " + str(sass_counts(
        f32_lib.library_path(), ("FFMA", "LDS", "LDGSTS", "SEL", "ISETP",
                                 "IMAD", "IADD3", "LEA", "SHF"))))

    # 2. kernels vs plain versions, every element type of the pool
    rng = np.random.default_rng(SEED)
    rows = []
    for mode in MODES:
        rows += [check_decode(dev, rng, mode), check_prefill(dev, rng, mode),
                 check_verify(dev, rng, mode)]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        if r["library_ms"] is not None and "one_call_ms" in r:
            lib += (f" (cold; one call {r['library_one_call_ms']:.4f}) "
                    f"kernel/library {r['ms'] / r['library_ms']:.2f}x")
        split = (f" split_positions {r['split_positions']} ranges "
                 f"{r['ranges']}" if "split_positions" in r else "")
        print(f"[kernel] {r['name']}: kernel_ms {r['ms']:.4f}"
              + (f" (cold; one call {r['one_call_ms']:.4f})"
                 if "one_call_ms" in r else "") + " "
              f"plain_ms {r['plain_ms']:.4f} library_ms {lib} "
              f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err {r['max_abs_err']:.3e} "
              f"row_err {r.pop('row_err'):.3e}{split}")

    # 2d. the kernel-level entry points vs their plain versions, and the
    #     paged kernels at the other configs' heads
    dense_rows, paged_cases, dense_outs = check_dense(dev)
    for r in rows:
        r["cases"] = paged_cases.get(r["name"], [])

    # 2g. the indexed gathers vs their plain versions, bitwise
    gather_entries, gather_outs = check_gathers(dev)

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
        out_path = Path(args.profile_out)
        profile_engine(cfg, params, (
            ("plain", None, "none", out_path),
            ("spec:oracle", oracle, "none", _suffixed(out_path, "spec")),
            ("quant:int8", None, "int8", _suffixed(out_path, "int8"))))

    # 6. the kernel-level entry points as a user calls them
    dense_launches = run_dense_path(dev, dense_outs)
    for r in dense_rows:
        r["launches"] = dense_launches[r["name"]]
    gather_launches = run_gather_path(dev, gather_outs)

    # 7. the MoE family on the engine: olmoe-1b-7b at full width, in the
    #    memory phi4's weights leave
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe_cfg, moe_params, moe_launches = serve_moe(dev)
    for r in gather_entries:
        r["launches"] = (moe_launches[r["name"]]
                         if r["name"] == moe_gather.KERNELS[torch.bfloat16].name
                         else gather_launches[r["name"]])
    # 7s. full-width MoE step check and the MoE block's gathers
    check_moe_steps(moe_cfg, moe_params, dev)
    if args.profile_out:
        profile_engine(moe_cfg, moe_params, (
            ("olmoe", None, "none", _suffixed(out_path, "olmoe")),))

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
    print(json.dumps({"kernels": rows + dense_rows + gather_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
