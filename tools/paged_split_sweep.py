"""Time the paged decode and verify kernels cold at every candidate range
length, at ``chip_smoke.py``'s phase-2 shapes and at the engine's.

    python tools/paged_split_sweep.py [--out sweep.jsonl]

For each case it draws the inputs once (seeded), holds the kernel at the
range length of ``decode_attention.paged_split_positions`` against the
plain version at phase 2's bars, then times the kernel cold
(``chip_smoke.cold_ms``: L2 flushed, input copies rotated, calls queued
behind a device sleep) with ``split_positions`` forced to each of
:data:`SPANS` that the table's capacity admits and to the rule's pick.
Verify row s against decode is ``chip_smoke.py``'s check, not this
tool's.  Cases:
phase 2's decode in bf16, int8 and fp8 and its verify (K = 4) in bf16
(phi4-mini's 24/8 heads of 128, lengths 1..2048 of a 2048 table, page
16); the phase-2d heads G5 (40/8), G12 (96/8) and D80 (32/8 of 80) for
decode; the engine's decode and verify at phi4-mini's heads and its
decode at olmoe-1b-7b's (16/16 of 128), 8 rows at the lengths of the
first 8 prompts ``chip_smoke.py`` serves, 32 tokens in.  Prints one
JSON line per case: the card, the rule's pick, each span's cold ms and
the fastest.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

dec = cs.dec_mod
SPANS = (64, 128, 192, 256, 320, 384, 448, 512, 768, 1024, 2048)


def engine_operands(kind: str, mode: str, heads: int, hkv: int, seed: int,
                    dev):
    """The engine's decode (or verify, K = 4) step over 8 rows: the first
    8 prompts' lengths plus 32 tokens, a 2048-position table over
    disjoint random frames; as ``chip_smoke.paged_operands`` returns."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = np.array([len(p) for p in cs.prompts(50304)][:8], np.int32) + 32
    if kind == "verify":
        lengths = base[:, None] + np.arange(cs.SPECULATE_K + 1)[None, :]
        longest = lengths.max(axis=1)
    else:
        lengths = longest = base
    pps = 2048 // cs.PAGE
    n_frames = len(base) * pps + 1
    table = np.full((len(base), pps), n_frames - 1, np.int32)
    for b, fr in enumerate(cs.random_frames(
            rng, n_frames - 1, [-(-int(n) // cs.PAGE) for n in longest])):
        table[b, :len(fr)] = fr
    kp, vp, kw = cs.make_pools(n_frames, mode, dev, hkv, cs.D, gen)
    q = torch.randn(*lengths.shape, heads, cs.D, generator=gen,
                    device=dev).bfloat16()
    return ((q, kp, vp, torch.from_numpy(table).to(dev),
             torch.from_numpy(lengths.astype(np.int32)).to(dev)), kw)


def cases(dev):
    """(name, kind, mode, operands, scale keywords) of every case."""
    out = []
    for mode in cs.MODES:
        args, kw, _ = cs.paged_operands(
            "decode", mode, np.random.default_rng(1), dev,
            gen=torch.Generator(device=dev).manual_seed(1))
        out.append((f"phase 2 decode ({mode})", "decode", mode, args, kw))
    args, kw, _ = cs.paged_operands(
        "verify", "none", np.random.default_rng(2), dev,
        gen=torch.Generator(device=dev).manual_seed(2))
    out.append(("phase 2 verify K=4 (none)", "verify", "none", args, kw))
    for i, (label, heads, hkv, d) in enumerate(
            (("G5 40/8", 40, 8, 128), ("G12 96/8", 96, 8, 128),
             ("D80 32/8", 32, 8, 80))):
        args, kw, _ = cs.paged_operands(
            "decode", "none", np.random.default_rng(3 + i), dev, heads, hkv,
            d, torch.Generator(device=dev).manual_seed(3 + i))
        out.append((f"phase 2d decode {label}", "decode", "none", args, kw))
    for label, kind, heads, hkv in (
            ("engine phi4 decode", "decode", 24, 8),
            ("engine phi4 verify K=4", "verify", 24, 8),
            ("engine olmoe decode", "decode", 16, 16)):
        args, kw = engine_operands(kind, "none", heads, hkv, 7, dev)
        out.append((label, kind, "none", args, kw))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also append the lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_split_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    sms = dec.sm_count(dev)
    sink = open(args.out, "a") if args.out else None
    for name, kind, mode, operands, kw in cases(dev):
        q, kp, _, pt, ln = operands
        capacity = pt.shape[1] * cs.PAGE
        rule = dec.paged_split_plan(tuple(q.shape), tuple(kp.shape),
                                    pt.shape[1], sms)[0]
        call = cs.paged_call(kind)
        cs.agree(name, call(*operands, impl="cuda", **kw),
                 call(*operands, impl="torch", **kw))
        names = tuple(kw)
        sets, _ = cs._rotated(tuple(operands) + tuple(kw.values()))
        times = {}
        for span in sorted(set(SPANS) | {rule}):
            if span > -(-capacity // 64) * 64:
                continue
            run = (lambda *a, span=span: dec.paged_decode_attention_cuda(
                *a[:5], **dict(zip(names, a[5:])), split_positions=span)
                if kind == "decode" else dec.paged_verify_attention_cuda(
                    *a[:5], **dict(zip(names, a[5:])),
                    split_positions=span))
            times[span] = cs.cold_ms(run, sets)
        del sets
        best = min(times, key=times.get)
        line = {"card": smi, "case": name, "positions": int(ln.sum()),
                "rule": rule, "rule_ms": times.get(rule), "best": best,
                "best_ms": times[best],
                "cold_ms": {str(k): v for k, v in times.items()}}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
