"""Time every plan of the wkv6 and ssd kernels at ``chip_smoke.py``
phase 2d's cases: each (rows a piece, pieces a segment) that fits,
through ``rwkv6.wkv6_cuda`` / ``mamba2.ssd_cuda`` with ``rows`` and
``seg`` forced, held at phase 2d's bars against the plain version and
timed cold (``chip_smoke.cold_ms``), the plan the wrappers pick marked;
then, for the picked plan, each of the call's kernels' device time
(``torch.profiler``, warm, the mean of 10 calls).

    python tools/ssm_sweep.py [--seg-max 8]

Prints one JSON line per (case, plan) and one per case with the picked
plan's kernels.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seg-max", type=int, default=8,
                    help="the most pieces a segment to try")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import mamba2, rwkv6
    from repro_torch.kernels.decode_attention import sm_count, smem_optin

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    sms, smem = sm_count(dev), smem_optin(dev)
    for i, (kind, dt, label, c) in enumerate(cs.DENSE_CASES):
        if kind not in ("wkv6", "ssd"):
            continue
        call, _, _, _, extra = cs.dense_inputs(i, dev)
        ref = call("torch")
        operands = extra["cold"][1]
        chunk = min(c["chunk"], c["T"])
        if kind == "wkv6":
            plan_of = (lambda rows=None, seg=None: rwkv6.wkv6_plan(
                c["B"], c["T"], c["H"], c["K"], c["K"], chunk, sms, smem,
                rows=rows, seg=seg))
            run = (lambda rows, seg: lambda *a: rwkv6.wkv6_cuda(
                *a, chunk=chunk, rows=rows, seg=seg))
        else:
            plan_of = (lambda rows=None, seg=None: mamba2.ssd_plan(
                c["B"], c["T"], c["H"], c["P"], c["N"], chunk, sms, smem,
                rows=rows, seg=seg))
            run = (lambda rows, seg: lambda *a: mamba2.ssd_cuda(
                *a, chunk=chunk, rows=rows, seg=seg))
        picked = plan_of()
        sets, _ = cs._rotated(operands)
        rows = chunk
        while rows >= 16 and chunk % rows == 0:
            seg = 1
            while seg <= args.seg_max and (c["T"] // rows) % seg == 0:
                try:
                    plan = plan_of(rows, seg)
                except ValueError:
                    break
                fn = run(rows, seg)
                out = fn(*operands)
                torch.cuda.synchronize()
                if dt == torch.float32:
                    acc = {"rel_err": cs._rel(out, ref)[1]}
                    cs.require(acc["rel_err"] < cs.SSM_TOL, f"{label}: {acc}")
                else:
                    acc = dict(zip(("max_abs_err", "row_err"),
                                   cs.agree(label, out, ref)))
                print(json.dumps({
                    "card": smi, "case": f"{kind} {label}", "dtype": str(dt),
                    "rows": rows, "seg": seg, "picked": plan == picked,
                    "blocks": plan.blocks,
                    "workspace_bytes": plan.workspace_bytes,
                    "smem_bytes": plan.smem_bytes, **acc,
                    "ms": cs.cold_ms(fn, sets, launches=cs.SSM_LAUNCHES)}),
                      flush=True)
                seg *= 2
            rows //= 2
        del sets
        print(json.dumps({"card": smi, "case": f"{kind} {label}",
                          "dtype": str(dt), "rows": picked.rows,
                          "seg": picked.seg,
                          "kernels_us": kernel_times(
                              run(picked.rows, picked.seg), operands)}),
              flush=True)
    return 0


def kernel_times(fn, operands) -> dict:
    """Mean device microseconds of each kernel one ``fn(*operands)``
    launches, over 10 calls after a warm-up, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*operands)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn(*operands)
        torch.cuda.synchronize()
    return {ev.key: ev.self_device_time_total / ev.count
            for ev in prof.key_averages() if ev.self_device_time_total > 0}


if __name__ == "__main__":
    sys.exit(main())
