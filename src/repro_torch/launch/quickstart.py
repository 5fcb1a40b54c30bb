"""Quickstart: the AMU programming model at both of the port's levels.

Mirrors the paper's Listing 1 — issue aload, do other work, poll getfin,
consume from SPM — as the JAX package's ``examples/quickstart.py`` does:

  1. the *runtime* AMU (request queue on a simulated far-memory tier),
  2. the *kernel* AMU (global -> shared-memory async copies inside the
     CUDA matmul, ``ops.matmul``).

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The device defaults to ``cuda``, where part 2 launches the hand-written
kernel; ``--device cpu`` runs its plain version.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import (AMU, AccessConfig, FAILURE_CODE, QoS,
                              SimBackend, StreamPattern, granules)
from repro_torch.kernels import matmul


def runtime_amu() -> Dict[str, object]:
    """Part 1: Listing-1 style aload -> overlap other work -> getfin ->
    consume, then variable granularity; prints and returns the counts."""
    print("== runtime AMU (paper Listing 1) ==")
    amu = AMU(backend=SimBackend(base_latency=3e-6, bandwidth=50e9),
              max_outstanding=64,
              default_config=AccessConfig(granularity_bytes=4096,
                                          qos=QoS.STANDARD))

    far_data = [np.full(1024, i, np.float32) for i in range(8)]
    rids = [amu.aload(x) for x in far_data]      # returns ids immediately
    issued, outstanding = len(rids), amu.outstanding
    print(f"issued {issued} aloads; outstanding={outstanding}")

    other_work = 0
    done = []
    while len(done) < len(rids):
        rid = amu.getfin()                        # never blocks
        if rid == FAILURE_CODE:
            other_work += 1                       # overlap useful work
            amu.backend.advance(1e-6)             # (virtual clock here)
            continue
        done.append(rid)
    head = amu.result(done[0])[:4]
    print(f"all requests landed; did {other_work} units of work while "
          f"waiting")
    print(f"first landed buffer head: {head}")

    pat = StreamPattern(total_bytes=1 << 20)
    small, large = granules(pat, 512), granules(pat, 65536)
    print(f"1 MiB stream = {small} requests @512B vs {large} @64KiB  "
          f"(variable granularity)")
    return {"issued": issued, "outstanding": outstanding,
            "other_work": other_work, "head": [float(x) for x in head],
            "granules": (small, large)}


def kernel_amu(device: torch.device) -> Dict[str, float]:
    """Part 2: ``ops.matmul`` at 256x512x256 f32 with 128^3 tiles against
    ``x @ w``; prints and returns the error."""
    what = "CUDA kernel" if device.type == "cuda" else "plain version"
    print(f"\n== kernel AMU ({what} on {device}) ==")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (256, 512)).astype(np.float32)).to(device)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (512, 256)).astype(np.float32)).to(device)
    out = matmul(x, w, bm=128, bk=128, bn=128)
    ref = x @ w
    err = float((out - ref).abs().max())
    print(f"amu_matmul max err vs torch: {err:.2e}")
    print("kernel pipeline: aload tile k+2 while the block consumes tile k "
          "(see src/repro_torch/kernels/csrc/amu_matmul.cu)")
    return {"max_err": err, "rel_err": err / float(ref.abs().max()),
            "shape": tuple(out.shape)}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of part 2 (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    return {"runtime": runtime_amu(), "kernel": kernel_amu(device)}


if __name__ == "__main__":
    main()
