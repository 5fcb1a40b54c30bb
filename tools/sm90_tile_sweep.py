"""Time every tile of the bf16 AMU matmul kernel at phi4-mini's MLP shapes.

    python3 tools/sm90_tile_sweep.py

Needs one NVIDIA Hopper card and ``nvcc`` (the kernel is built at first
launch).  For the MLP's gate/up (512 x 3072 @ 3072 x 8192) and down
(512 x 8192 @ 8192 x 3072) products it launches
``src/repro_torch/kernels/csrc/amu_matmul_sm90.cu`` at every (bm, bn)
the kernel has, each with its ring as deep as the shared memory holds,
holds each output against the plain version at ``chip_smoke.py``'s
phase-2 bars, and prints each tile's time beside ``torch.matmul``'s,
both timed as ``chip_smoke.cold_ms`` times them (L2 flushed, input
copies rotated, calls queued behind a device sleep), and the tile that
``amu_matmul.sm90_tiles`` picks.  The card's name and power limit come
first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import amu_matmul as mm  # noqa: E402

SHAPES = [(512, 3072, 8192), (512, 8192, 3072)]


def main() -> int:
    if not torch.cuda.is_available():
        print("sm90_tile_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    props = torch.cuda.get_device_properties(0)
    sms, smem = props.multi_processor_count, props.shared_memory_per_block_optin
    kernel = mm.KERNELS[torch.bfloat16]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for M, K, N in SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = torch.randn(K, N, generator=gen, device="cuda").bfloat16()
        ref = mm.amu_matmul_torch(x, w)
        nbytes = (x.numel() + w.numel()) * 2
        sets = [(x, w)] + [(x.clone(), w.clone()) for _ in range(
            -(-cs.ROTATE_BYTES // nbytes) - 1)]
        lib_ms = cs.cold_ms(torch.matmul, sets)
        print(f"{M}x{K}x{N}: torch.matmul {lib_ms:.4f} ms; bound "
              f"{cs.bound(0, 2 * M * K * N)[0]:.4f} ms; sm90_tiles picks "
              f"{mm.sm90_tiles(M, N, sms, smem)}")
        for bm in mm.SM90_BM:
            for bn in mm.SM90_BN:
                stages = mm.sm90_stages(bm, bn, smem)

                def run(a, b, bm=bm, bn=bn, stages=stages):
                    out = torch.empty(M, N, device="cuda",
                                      dtype=torch.bfloat16)
                    kernel.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  M, K, N, bm, bn, stages,
                                  torch.cuda.current_stream().cuda_stream)
                    return out

                cs.agree(f"({bm}, {bn})", run(x, w), ref)
                blocks = -(-M // bm) * -(-N // bn)
                ms = cs.cold_ms(run, sets)
                print(f"  ({bm}, {bn}) {blocks} blocks, {stages} stages: "
                      f"{ms:.4f} ms, {ms / lib_ms:.2f}x torch.matmul")
    return 0


if __name__ == "__main__":
    sys.exit(main())
