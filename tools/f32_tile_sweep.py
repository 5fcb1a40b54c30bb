"""Time every tile of the f32 AMU matmul kernel at a range of shapes.

    python3 tools/f32_tile_sweep.py

Needs one NVIDIA Hopper card and ``nvcc`` (the kernel is built at first
launch).  For each shape (the quickstart's 256 x 512 x 256, 8 x 1024 x
1024, and square products of 1024 to 4096) it runs ``ops.matmul`` (the
tile ``amu_matmul.f32_tiles`` picks), holds it within the reference's
bar (5e-6 of max |ref|) of the plain version, and prints each tile of
``amu_matmul.F32_TILES`` launched through the C entry point, bitwise
that output (``chip_smoke.f32_tile_times``), with the blocks of its
grid, the blocks an SM holds (the card's occupancy reckoning,
``amu_matmul_f32_resident``) and its time beside ``torch.matmul``'s
(TF32 off), all timed as ``chip_smoke.cold_ms`` times them (L2 flushed,
input copies rotated, calls queued behind a device sleep).  The card's
name and power limit come first; each shape's numbers are also one JSON
line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import amu_matmul as mm, ops  # noqa: E402

SHAPES = [(256, 512, 256), (8, 1024, 1024), (1024, 1024, 1024),
          (2048, 2048, 2048), (4096, 4096, 4096)]


def resident(bm: int, bn: int) -> int:
    """Blocks of the (bm, bn) instance one SM holds at once."""
    blocks = ctypes.c_int()
    mm.KERNELS[torch.float32].query(
        "amu_matmul_f32_resident",
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)], bm, bn,
        ctypes.byref(blocks))
    return blocks.value


def main() -> int:
    if not torch.cuda.is_available():
        print("f32_tile_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    props = torch.cuda.get_device_properties(0)
    sms, smem = props.multi_processor_count, props.shared_memory_per_block_optin
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda")
        w = torch.randn(K, N, generator=gen, device="cuda")
        out = ops.matmul(x, w)
        rel = cs._rel(out, mm.amu_matmul_torch(x, w))[1]
        cs.require(rel < cs.F32_TOL, f"{M}x{K}x{N}: {rel:.3e}")
        sets, _ = cs._rotated((x, w))
        lib_ms = cs.cold_ms(torch.matmul, sets)
        del sets
        tile_ms = cs.f32_tile_times((x, w), out)
        pick = mm.f32_tiles(M, N, sms, smem)
        row = {"shape": [M, K, N], "torch_matmul_ms": lib_ms,
               "bound_ms": cs.bound(0, 2 * M * K * N, torch.float32)[0],
               "pick": list(pick[:2]), "rel_err": rel, "tiles": []}
        print(f"{M}x{K}x{N}: torch.matmul {lib_ms:.4f} ms; bound "
              f"{row['bound_ms']:.4f} ms; f32_tiles picks {pick}")
        for bm, bn in mm.F32_TILES:
            ms, r = tile_ms[f"{bm}x{bn}"], resident(bm, bn)
            blocks = -(-M // bm) * -(-N // bn)
            row["tiles"].append({"tile": [bm, bn], "blocks": blocks,
                                 "resident": r, "ms": ms})
            print(f"  ({bm}, {bn}) {blocks} blocks, {r} an SM: {ms:.4f} ms, "
                  f"{ms / lib_ms:.2f}x torch.matmul")
        print(json.dumps(row), flush=True)
        del x, w, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
