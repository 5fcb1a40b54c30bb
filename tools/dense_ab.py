"""Time the f32 matmul and dense decode cases of ``chip_smoke.py`` phase
2d with the ``repro_torch`` package of a given tree, to compare two trees
on one card.

    python tools/dense_ab.py --src PATH/TO/TREE/src --tag parent

Imports ``repro_torch`` from ``--src`` before ``chip_smoke`` (whose own
imports then find it loaded), draws each case's inputs as phase 2d does
(the same seeds, so two trees see the same operands), holds the kernel
against its plain version at phase 2d's bars, and times kernel and
library call cold and one call (``chip_smoke.cold_times``).  Prints one
JSON line per case and, last, one with the sha256 of the f32 matmul
outputs in case order (``chip_smoke.f32_matmul_digest`` over the f32
matmul cases only).  Run a tree in a process of its own, each after the
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src directory holding repro_torch")
    ap.add_argument("--tag", required=True, help="names the tree")
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
