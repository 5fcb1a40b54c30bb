"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives ``repro_torch`` only (nothing of JAX or of the ``repro`` package):

1. builds both CUDA kernels of the serving path from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` for ``sm_90a``, one compiler per source,
   started together;
2. holds each kernel against its plain PyTorch version on the card at
   the main path's shapes (H=24, Hkv=8, D=128, page 16, bf16 pool):
   decode at B=8 with ragged lengths 1..2048, prefill at C=2, T=256 with
   ragged offsets and lengths.  Every element must agree within
   atol 4e-3 + rtol 1e-2 (one bf16 step at any magnitude, four times the
   largest error measured on an H100), and every output row of D values
   within a relative L2 error of 1e-2, which a skipped or repeated page
   of even the longest row exceeds several times.
   It times kernel, plain version and ``scaled_dot_product_attention``
   on the gathered view (a yardstick only) with CUDA events, and
   computes each kernel's bound from these inputs;
3. serves 12 requests (prompts of 512-1536 tokens, 32 new tokens each)
   on ``phi4-mini-3.8b`` at full width with random weights from a seeded
   generator, through the port's ``Engine``: FUSED role, paging and
   chunked prefill on, watermark policy, and a device pool of 448 pages,
   under half of ``max_batch * pages_per_seq``, so the pager parks and
   resumes pages.
   It asserts that every request finishes with its token count, that
   both kernels launched in that run, and that the pager preempted and
   resumed; it prints throughput, TTFT, memory, and the share of tokens
   equal to a run whose pool needs no preemption;
4. checks one prefill chunk and one decode step at full width: kernels
   against plain versions on the same cache, finite logits of the right
   shape within a relative error.

It prints the card's name and power limit first, then the lines of each
phase, then ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
...}``.  Without a CUDA device it exits non-zero before any result.

``--profile-out PATH`` adds one more engine run of phase 3 under
``torch.profiler`` and prints where its device time went (attention
kernels, matrix products, copies, the rest) and the device's busy share
of the profiled wall time; the per-kernel table goes to PATH.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as dec_mod  # noqa: E402
from repro_torch.kernels import flash_attention as pre_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.build import build_all  # noqa: E402
from repro_torch.models.model import (cast_params, decode_step,  # noqa: E402
                                      init_paged_cache, init_params,
                                      prefill_chunk)
from repro_torch.serve.config import (ChunkingConfig, EngineConfig,  # noqa: E402
                                      PagingConfig, SchedulerConfig)
from repro_torch.serve.engine import Engine  # noqa: E402

H, HKV, D, PAGE = 24, 8, 128, 16
ATOL, RTOL = 4e-3, 1e-2          # per element, on bf16 outputs
ROW_TOL = 1e-2                   # relative L2 error of each output row
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor rate
ARCH = "phi4-mini-3.8b"
# 448 of the 8 * 128 pages a roomy pool would need (0.875 GiB of bf16 KV):
# at 512 this load preempted once, at 448 four times (CPU rehearsal at
# the smoke width with full-width page bytes; scheduling does not depend
# on the model's numbers)
ENGINE = dict(max_batch=8, max_len=2048, page_size=16, device_pages=448,
              chunk_tokens=256, chunk_slots=2)
N_REQUESTS, PROMPT_RANGE, NEW_TOKENS = 12, (512, 1536), 32
SEED = 0


def require(ok, msg: str) -> None:
    """A failed check ends the run with an error (unlike ``assert``,
    this survives ``python -O``)."""
    if not ok:
        raise RuntimeError(msg)


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


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_frames(rng, n_frames, counts):
    """Disjoint random frame ids, ``counts[i]`` of them for row i."""
    perm = rng.permutation(n_frames)
    out, at = [], 0
    for n in counts:
        out.append(perm[at:at + n])
        at += n
    return out


def gathered(pool, table):
    """(rows, pages * page, H, D) view of the pool, KV heads repeated to
    the query heads — the operand SDPA needs."""
    rows = table.shape[0]
    x = pool[table.long()].reshape(rows, -1, HKV, D)
    return x.repeat_interleave(H // HKV, dim=2).transpose(1, 2)


def check_decode(dev, rng):
    lengths = np.array([1, 16, 17, 255, 640, 1000, 1537, 2048], np.int32)
    B, pps = len(lengths), 2048 // PAGE
    n_frames = B * pps + 1
    table = np.full((B, pps), n_frames - 1, np.int32)
    for b, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-n // PAGE) for n in lengths])):
        table[b, :len(fr)] = fr
    kp = torch.randn(n_frames, PAGE, HKV, D, device=dev).bfloat16()
    vp = torch.randn(n_frames, PAGE, HKV, D, device=dev).bfloat16()
    q = torch.randn(B, H, D, device=dev).bfloat16()
    pt = torch.from_numpy(table).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    args = (q, kp, vp, pt, ln)
    out = ops.paged_decode_attention(*args, impl="cuda")
    ref = ops.paged_decode_attention(*args, impl="torch")
    err, row_err = agree("decode kernel", out, ref)
    kg, vg = gathered(kp, pt), gathered(vp, pt)
    mask = (torch.arange(pps * PAGE, device=dev)[None, :]
            < ln[:, None])[:, None, None, :]
    qs = q[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    total = int(lengths.sum())
    nbytes = (q.numel() * 2 * 2 + pt.numel() * 4 + ln.numel() * 4
              + 2 * total * HKV * D * 2)
    flops = 4 * total * H * D
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/decode_attention.py:254",
        "launches": None, "max_abs_err": err, "row_err": row_err,
        "ms": time_ms(lambda: ops.paged_decode_attention(*args,
                                                         impl="cuda")),
        "plain_ms": time_ms(lambda: ops.paged_decode_attention(
            *args, impl="torch")),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)),
    }


def check_prefill(dev, rng):
    offset = np.array([512, 1283], np.int32)
    length = np.array([256, 131], np.int32)
    C, T, pps = 2, 256, 2048 // PAGE
    valid = offset + length
    n_frames = int(sum(-(-v // PAGE) for v in valid)) + 1
    rows = np.full((C, pps), n_frames - 1, np.int32)
    for c, fr in enumerate(random_frames(rng, n_frames - 1,
                                         [-(-v // PAGE) for v in valid])):
        rows[c, :len(fr)] = fr
    kp = torch.randn(n_frames, PAGE, HKV, D, device=dev).bfloat16()
    vp = torch.randn(n_frames, PAGE, HKV, D, device=dev).bfloat16()
    q = torch.randn(C, T, H, D, device=dev).bfloat16()
    pr = torch.from_numpy(rows).to(dev)
    off = torch.from_numpy(offset).to(dev)
    ln = torch.from_numpy(length).to(dev)
    args = (q, kp, vp, pr, off, ln)
    out = ops.paged_prefill_attention(*args, impl="cuda")
    ref = ops.paged_prefill_attention(*args, impl="torch")
    errs = [agree("prefill kernel", out[c, :length[c]], ref[c, :length[c]])
            for c in range(C)]
    kg, vg = gathered(kp, pr), gathered(vp, pr)
    q_pos = off[:, None] + torch.arange(T, device=dev)[None, :]
    kv_pos = torch.arange(pps * PAGE, device=dev)
    mask = (kv_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    qs = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # work of the valid query rows: query t sees offset + t + 1 keys
    attended = sum(int(length[c]) * int(offset[c])
                   + int(length[c]) * (int(length[c]) + 1) // 2
                   for c in range(C))
    nbytes = (2 * 2 * int(length.sum()) * H * D + rows.size * 4 + 2 * C * 4
              + 2 * int(valid.sum()) * HKV * D * 2)
    flops = 4 * attended * H * D
    b_ms, b_by = bound(nbytes, flops)
    return {
        "name": "paged_prefill_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill.cu",
        "replaces": "src/repro/kernels/flash_attention.py:279",
        "launches": None, "max_abs_err": max(e for e, _ in errs),
        "row_err": max(r for _, r in errs),
        "ms": time_ms(lambda: ops.paged_prefill_attention(*args,
                                                          impl="cuda")),
        "plain_ms": time_ms(lambda: ops.paged_prefill_attention(
            *args, impl="torch")),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask)),
    }


def engine_config(device, device_pages, clock=None) -> EngineConfig:
    e = ENGINE
    return EngineConfig(
        max_batch=e["max_batch"], max_len=e["max_len"], device=device,
        paging=PagingConfig(page_size=e["page_size"],
                            device_pages=device_pages),
        chunking=ChunkingConfig(chunk_tokens=e["chunk_tokens"],
                                chunk_slots=e["chunk_slots"]),
        scheduler=SchedulerConfig(policy="watermark", clock=clock))


def prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lo, hi = PROMPT_RANGE
    return [rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
            for _ in range(N_REQUESTS)]


def serve(cfg, params, device, device_pages, clock=None):
    """Serve the smoke requests; returns (engine, outputs, wall seconds)."""
    eng = Engine(cfg, params, engine_config(device, device_pages, clock))
    for p in prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    t0 = time.perf_counter()
    out = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    return eng, out, time.perf_counter() - t0


def check_steps(cfg, params, dev):
    """One prefill chunk and one decode step at full width, kernels vs
    plain versions on identical fresh caches."""
    rng = np.random.default_rng(SEED + 1)
    T, n_frames = 256, 2 * 32 + 1
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)).to(dev)
    # pages for the chunk and for the decode token after it
    rows = torch.full((2, 32), n_frames - 1, dtype=torch.int32, device=dev)
    rows[0, :17] = torch.arange(17)
    rows[1, :14] = torch.arange(17, 31)
    chunk = {"tokens": toks, "page_rows": rows,
             "offset": torch.zeros(2, dtype=torch.int32, device=dev),
             "length": torch.tensor([256, 217], dtype=torch.int32,
                                    device=dev)}
    res = {}
    for impl in ("cuda", "torch"):
        cache = init_paged_cache(cfg, 2, 512, n_frames, PAGE, device=dev)
        cl, cache = prefill_chunk(params, cfg, cache, chunk, impl=impl)
        cache.kv["page_table"].copy_(rows)
        cache = cache._replace(pos=chunk["length"].clone())
        dl, _ = decode_step(params, cfg, cache, toks[:, -1:], impl=impl)
        res[impl] = (cl.float(), dl.float())
    for i, name in enumerate(("chunk", "decode")):
        a, b = res["cuda"][i], res["torch"][i]
        require(a.shape == (2, cfg.padded_vocab), f"{name}: {a.shape}")
        require(torch.isfinite(a).all(), f"{name} logits: non-finite")
        rel = float((a - b).norm() / b.norm())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"[steps] {name} logits kernels vs plain: rel err {rel:.3e}, "
              f"argmax agreement {same:.2f}")
        require(rel < 0.05, f"{name} logits rel err {rel}")


def _kind(name: str) -> str:
    if "paged_decode_kernel" in name or "paged_prefill_kernel" in name:
        return "attention kernels"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies"
    return "other kernels"


def profile_engine(cfg, params, path: str) -> None:
    """One more (warm) phase-3 run under ``torch.profiler``: device time
    by kind of kernel, and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, out, wall = serve(cfg, params, "cuda", ENGINE["device_pages"])
    kinds = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            k = _kind(ev.name)
            kinds[k] = kinds.get(k, 0.0) + ev.time_range.elapsed_us() / 1e3
    busy = sum(kinds.values())
    print(f"[profile] profiled run: {wall:.3f}s wall, device busy "
          f"{busy / 1e3:.3f}s ({busy / (wall * 1e3):.3f} of wall)")
    for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {k}: {ms / 1e3:.3f}s ({ms / busy:.3f} of device "
              f"time)" if busy else f"[profile] {k}: 0")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(prof.key_averages().table(
        sort_by="self_cuda_time_total", row_limit=60))
    print(f"[profile] per-kernel table written to {path}")


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
    secs = build_all(ops.KERNELS)
    print(f"[build] {len(ops.KERNELS)} kernels in {secs:.1f}s")
    for k in ops.KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.source.name}: {line.strip()}")

    # 2. kernels vs plain versions
    rng = np.random.default_rng(SEED)
    rows = [check_decode(dev, rng), check_prefill(dev, rng)]
    for r in rows:
        print(f"[kernel] {r['name']}: kernel_ms {r['ms']:.4f} "
              f"plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
              f"({r['bound_by']}) max_abs_err {r['max_abs_err']:.3e} "
              f"row_err {r.pop('row_err'):.3e}")

    # 3. the engine at full width
    cfg = get_config(ARCH)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = cast_params(init_params(cfg, gen, dev), torch.bfloat16, dev)
    torch.cuda.synchronize()
    print(f"[engine] {ARCH} params ready in {time.perf_counter() - t0:.3f}s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    for k in ops.KERNELS:
        k.launches = 0
    eng, out, wall = serve(cfg, params, "cuda", ENGINE["device_pages"],
                           clock=time.perf_counter)
    launches = {k.name: k.launches for k in ops.KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tok = sum(len(v) for v in out.values())
    ttft = [r.ttft for r in eng.finished.values()]
    print(f"[engine] {len(out)} requests, {n_tok} tokens in {wall:.2f}s "
          f"({n_tok / wall:.1f} tok/s), mean TTFT {np.mean(ttft):.3f}s, "
          f"steps {eng.stats['steps']} (mixed {eng.stats['mixed_steps']}), "
          f"peak memory {peak:.2f} GiB")
    print(f"[engine] preemptions {eng.stats['preemptions']} resumes "
          f"{eng.stats['resumes']} prefill_preempts "
          f"{eng.stats['prefill_preempts']} chunks {eng.stats['chunks']}; "
          f"pager {dict(eng.pager.stats)}")
    print(f"[engine] kernel launches {launches}")
    require(len(out) == N_REQUESTS, f"{len(out)} of {N_REQUESTS} finished")
    require(all(len(v) == NEW_TOKENS for v in out.values()), "token counts")
    require(all(0 <= t < cfg.padded_vocab for v in out.values() for t in v),
            "token ids out of the vocabulary")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched on the main path")
    require(eng.stats["preemptions"] > 0 and eng.stats["resumes"] > 0,
            "the pool never preempted/resumed")
    pps = ENGINE["max_len"] // ENGINE["page_size"]
    roomy, rout, r_wall = serve(cfg, params, "cuda",
                                ENGINE["max_batch"] * pps)
    same = sum(a == b for r in out for a, b in zip(out[r], rout[r]))
    print(f"[engine] roomy pool: preemptions {roomy.stats['preemptions']}, "
          f"steps {roomy.stats['steps']}, {n_tok / r_wall:.1f} tok/s; "
          f"tokens equal to the preempting run: {same}/{n_tok} "
          f"({same / n_tok:.3f})")
    del eng, roomy

    # 4. full-width step check against the plain versions
    check_steps(cfg, params, dev)
    if args.profile_out:
        profile_engine(cfg, params, args.profile_out)

    rows[0]["launches"] = launches[dec_mod.KERNEL.name]
    rows[1]["launches"] = launches[pre_mod.KERNEL.name]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
