"""Time the f32 matmul and dense decode cases of ``chip_smoke.py`` phase
2d, and its paged decode and verify cases (phase 2 in bf16, int8 and
fp8, phase 2d's G5 / G12 / D80), or its f32 dense flash cases, or the
gather cases of phase 2g, or the int8 / fp8 paged prefill cases (phase
2's and phase 2d's D80) with phase 2g's block gathers, or the wkv6 and
ssd cases of phase 2d, with the ``repro_torch`` package of a given tree,
to compare two trees on one card.

    python tools/dense_ab.py --src PATH/TO/TREE/src --tag parent \
        [--only paged|flash_f32|gather|quant_prefill|ssm]

Imports ``repro_torch`` from ``--src`` before ``chip_smoke`` (whose own
imports then find it loaded), draws each case's inputs as phase 2d does
(the same seeds, so two trees see the same operands), holds the kernel
against its plain version at phase 2d's bars, and times kernel and
library call cold and one call (``chip_smoke.cold_times``; the int8 /
fp8 paged cases have no library call; a gather case against
``index_select``, bitwise, as phase 2g times it).  The paged cases go through
``ops`` alone, which both trees have, and print the range length the
tree cuts (none before the split).  Prints one JSON line per case and,
last, one with the sha256 of the f32 matmul outputs in case order
(``chip_smoke.f32_matmul_digest`` over the f32 matmul cases only).  Run a tree in a process of its own, each after the
other in one call (parent, change, change, parent) so both meet the
same card.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def paged_cases(cs, dev, tag: str, smi: str) -> None:
    """Phase 2's decode and verify in every pool type (inputs seeded per
    case, so two trees see the same operands) and phase 2d's paged
    decode and verify cases: each held at phase 2's bars, timed cold and
    one call, a JSON line each."""
    import numpy as np

    split_plan = getattr(cs.dec_mod, "paged_split_plan", None)
    todo = []
    for j, (kind, mode) in enumerate((k, m) for k in ("decode", "verify")
                                     for m in cs.MODES):
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 200 + j)
        args, kw, longest = cs.paged_operands(
            kind, mode, np.random.default_rng(cs.SEED + 200 + j), dev,
            gen=gen)
        todo.append((f"phase 2 {kind} ({mode})", kind, mode, args, kw,
                     cs.kv_bytes(int(longest.sum()), sum(
                         -(-int(n) // cs.PAGE) for n in longest), mode)))
    for i, (kind, _, label, c) in enumerate(cs.DENSE_CASES):
        if kind in ("paged_decode", "paged_verify"):
            row = kind[len("paged_"):]
            args, kw, longest = cs.paged_operands(
                row, "none", np.random.default_rng(cs.SEED + 100 + i), dev,
                c["H"], c["Hkv"], c["D"],
                torch.Generator(device=dev).manual_seed(cs.SEED + 100 + i))
            todo.append((f"phase 2d {row} {label}", row, "none", args, kw,
                         2 * int(longest.sum()) * c["Hkv"] * c["D"] * 2))
    for label, kind, mode, args, kw, kv in todo:
        q, kp, vp, pt, ln = args
        call = cs.paged_call(kind)
        err = cs.agree(label, call(*args, impl="cuda", **kw),
                       call(*args, impl="torch", **kw))[1]
        heads = q.shape[-2]
        times = cs.paged_times(kind, mode, args, kw, heads)
        b_ms, b_by = cs.bound(q.numel() * 4 + pt.numel() * 4
                              + ln.numel() * 4 + kv,
                              4 * int(ln.sum()) * heads * q.shape[-1])
        split = ({} if split_plan is None else dict(zip(
            ("split_positions", "ranges"), split_plan(
                tuple(q.shape), tuple(kp.shape), pt.shape[1],
                cs.dec_mod.sm_count(dev))[:2])))
        print(json.dumps({"tag": tag, "card": smi, "case": label,
                          "row_err": err, "bound_ms": b_ms,
                          "bound_by": b_by, **split, **times}), flush=True)


def flash_f32_cases(cs, dev, tag: str, smi: str) -> None:
    """Phase 2d's f32 flash cases through ``ops`` (which both trees
    have): each within the reference's bar, timed cold beside SDPA, a
    JSON line each with the sha256 of the kernel's output."""
    import hashlib

    for i, (kind, dt, label, shape) in enumerate(cs.DENSE_CASES):
        if kind != "flash" or dt != torch.float32:
            continue
        call, _, nbytes, flops, extra = cs.dense_inputs(i, dev)
        out, ref = call("cuda"), call("torch")
        torch.cuda.synchronize()
        err = cs._rel(out, ref)[1]
        cs.require(err < cs.F32_TOL, f"{label}: {err:.3e}")
        times = cs.cold_times(*extra["cold"])
        b_ms, b_by = cs.bound(nbytes, flops, dt)
        print(json.dumps({
            "tag": tag, "card": smi, "case": label, "rel_err": err,
            "bound_ms": b_ms, "bound_by": b_by,
            **cs.launch_shape(kind, dt, shape, dev), **times,
            "kernel_over_library": times["ms"] / times["library_ms"],
            "sha256": hashlib.sha256(out.cpu().numpy().tobytes())
            .hexdigest()}), flush=True)


def gather_cases(cs, dev, tag: str, smi: str,
                 kinds=("rows", "blocks")) -> None:
    """Phase 2g's cases of ``kinds``: bitwise ``index_select``, the
    kernel and ``index_select`` timed cold as phase 2g times them, a
    JSON line each."""
    for i, (kind, dt, label, _) in enumerate(cs.GATHER_CASES):
        if kind not in kinds:
            continue
        inputs, call, plain, nbytes, shape = cs.gather_inputs(i, dev)
        cs.require(torch.equal(call(*inputs, impl="cuda"),
                               call(*inputs, impl="torch")),
                   f"{label}: not bitwise")
        n_sets = min(cs.MAX_SETS, -(-cs.ROTATE_BYTES // nbytes))
        sets = [inputs] + [tuple(t.clone() for t in inputs)
                           for _ in range(n_sets - 1)]
        ms = cs.cold_ms(lambda *a: call(*a, impl="cuda"), sets)
        lib_ms = cs.cold_ms(plain, sets)
        del sets
        print(json.dumps({
            "tag": tag, "card": smi, "case": f"gather_{kind} {label}",
            "dtype": str(dt), **shape,
            **cs.gather_route(kind, inputs, shape.get("block_rows", 1)),
            "ms": ms, "library_ms": lib_ms,
            "kernel_over_library": ms / lib_ms,
            "bound_ms": cs.bound(nbytes, 0, dt)[0]}), flush=True)


def quant_prefill_cases(cs, dev, tag: str, smi: str) -> None:
    """Phase 2's int8 / fp8 prefill (inputs seeded per case, so two
    trees see the same operands) and phase 2d's at D 80: each held at
    phase 2's bars, timed cold and one call (no library call takes the
    pool with its scales), a JSON line each; then phase 2g's block
    gathers."""
    import numpy as np

    todo = []
    for j, mode in enumerate(cs.QUANT_MODES):
        seed = cs.SEED + 400 + j
        args, kw, frames = cs.prefill_operands(
            mode, np.random.default_rng(seed), dev,
            gen=torch.Generator(device=dev).manual_seed(seed))
        todo.append((f"phase 2 prefill ({mode})", args, kw,
                     cs.prefill_work(args, frames, mode)))
    for i, (kind, dt, label, _) in enumerate(cs.DENSE_CASES):
        if kind == "paged_prefill" and dt != torch.bfloat16:
            _, _, nbytes, flops, extra = cs.dense_inputs(i, dev)
            operands = extra["cold"][1]
            todo.append((f"phase 2d prefill {label}", operands[:6],
                         dict(zip(("k_scales", "v_scales"), operands[6:])),
                         (nbytes, flops)))
    for label, args, kw, work in todo:
        out = cs.ops.paged_prefill_attention(*args, impl="cuda", **kw)
        ref = cs.ops.paged_prefill_attention(*args, impl="torch", **kw)
        err = max(cs.agree(label, out[c, :n], ref[c, :n])[1]
                  for c, n in enumerate(cs.PREFILL_LENGTHS))
        b_ms, b_by = cs.bound(*work)
        print(json.dumps({"tag": tag, "card": smi, "case": label,
                          "row_err": err, "bound_ms": b_ms,
                          "bound_by": b_by,
                          **cs.cold_times(*cs.prefill_cold(args, kw), None,
                                          None)}), flush=True)
    gather_cases(cs, dev, tag, smi, kinds=("blocks",))


def ssm_cases(cs, dev, tag: str, smi: str) -> None:
    """Phase 2d's wkv6 and ssd cases through ``ops`` (which both trees
    have): each held at phase 2d's bars (f32 against the plain version
    and the sequential oracle, bf16 per element and per row), timed cold
    and one call (no library call computes either), a JSON line each with
    the tree's plan (none where its wrappers have no plan) and the sha256
    of the output."""
    import hashlib

    for i, (kind, dt, label, shape) in enumerate(cs.DENSE_CASES):
        if kind not in ("wkv6", "ssd"):
            continue
        call, _, nbytes, flops, extra = cs.dense_inputs(i, dev)
        out, ref = call("cuda"), call("torch")
        torch.cuda.synchronize()
        if dt == torch.float32:
            acc = {"rel_err": cs._rel(out, ref)[1]}
            cs.require(acc["rel_err"] < cs.SSM_TOL, f"{label}: {acc}")
            if extra["seq"]:
                acc["seq_rel_err"] = cs._rel(out, extra["seq"]())[1]
                cs.require(acc["seq_rel_err"] < cs.SSM_SEQ_TOL,
                           f"{label}: {acc}")
        else:
            acc = dict(zip(("max_abs_err", "row_err"),
                           cs.agree(label, out, ref)))
        b_ms, b_by = cs.bound(nbytes, flops, dt)
        print(json.dumps({
            "tag": tag, "card": smi, "case": f"{kind} {label}",
            "dtype": str(dt), **acc, "bound_ms": b_ms, "bound_by": b_by,
            **cs.launch_shape(kind, dt, shape, dev),
            **cs.cold_times(*extra["cold"]),
            "sha256": hashlib.sha256(out.cpu().float().numpy().tobytes())
            .hexdigest()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src directory holding repro_torch")
    ap.add_argument("--tag", required=True, help="names the tree")
    ap.add_argument("--only", default=None,
                    choices=("dense", "paged", "flash_f32", "gather",
                             "quant_prefill", "ssm"),
                    help="time only the dense (f32 matmul, dense decode), "
                    "the paged, the f32 flash or the gather cases, the "
                    "int8 / fp8 prefill and block gather cases, or the "
                    "wkv6 and ssd cases")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dense_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.kernels.ops  # noqa: F401  (from --src, first)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    if args.only == "flash_f32":
        flash_f32_cases(cs, dev, args.tag, smi)
        return 0
    if args.only == "gather":
        gather_cases(cs, dev, args.tag, smi)
        return 0
    if args.only == "quant_prefill":
        quant_prefill_cases(cs, dev, args.tag, smi)
        return 0
    if args.only == "ssm":
        ssm_cases(cs, dev, args.tag, smi)
        return 0
    if args.only != "dense":
        paged_cases(cs, dev, args.tag, smi)
    if args.only == "paged":
        return 0
    outs = []
    for i, (kind, dt, label, shape) in enumerate(cs.DENSE_CASES):
        if kind not in ("matmul", "decode") or (
                kind == "matmul" and dt == torch.bfloat16):
            outs.append(None)
            continue
        call, _, nbytes, flops, extra = cs.dense_inputs(i, dev)
        out, ref = call("cuda"), call("torch")
        torch.cuda.synchronize()
        if dt == torch.float32:
            err = cs._rel(out, ref)[1]
            cs.require(err < cs.F32_TOL, f"{label}: {err:.3e}")
        else:
            err = cs.agree(label, out, ref)[1]
        times = cs.cold_times(*cs.cold_case(kind, call, extra))
        b_ms, b_by = cs.bound(nbytes, flops, dt)
        print(json.dumps({"tag": args.tag, "card": smi, "case": label,
                          "dtype": str(dt), "err": err, "bound_ms": b_ms,
                          "bound_by": b_by, **times}), flush=True)
        outs.append(out.cpu() if kind == "matmul" else None)
    print(json.dumps({"tag": args.tag,
                      "f32_matmul_sha256": cs.f32_matmul_digest(outs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
