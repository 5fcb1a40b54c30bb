"""Time the row gather against ``index_select`` at a range of row lengths
and row counts.

    python3 tools/gather_sweep.py

Needs one NVIDIA Hopper card and ``nvcc`` (the kernel is built at first
launch).  For bf16 sources of rows of 256 B to 16 KB (olmoe-1b-7b's are
4 KB) and M = 64, 512 and 4096 output rows (olmoe's decode combine and
dispatch, and its prefill combine) with random indices into N = 1024
rows, and at olmoe's own gathers beside that grid, it launches the row
gather (``moe_gather.gather_rows_cuda``, on the plan
``moe_gather.gather_plan`` gives it), holds it bitwise against
``index_select``, and times both as ``chip_smoke.cold_ms`` times them
(L2 flushed, input copies rotated, calls queued behind a device sleep).
Then the block gather (``moe_gather.gather_blocks_cuda``, the same
kernel over the view whose rows are the blocks) against ``index_select``
on that view, at the paged-KV fetch's blocks (16 rows of 8 x 128 bf16,
32 KB, 128 of 448 frames) and at 8 KB to 64 KB blocks.  The card's name
and power limit come first; each shape's numbers, with its plan, are
one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import moe_gather  # noqa: E402
from repro_torch.kernels.decode_attention import sm_count  # noqa: E402

ROW_BYTES = (256, 512, 1024, 2048, 4096, 8192, 16384)
ROWS = (64, 512, 4096)
N = 1024
#: (source rows, row bytes, M) beside the grid: olmoe's decode dispatch
#: (8 tokens and the zero row), prefill dispatch and combine
MORE = ((9, 4096, 512), (513, 4096, 5120), (5120, 4096, 4096))
#: (frames, block rows, d, Mb) of the block gather, bf16: the paged-KV
#: fetch (16 rows of 8 KV heads x 128), all its 448 frames, and blocks of
#: 8 KB and 64 KB
BLOCKS = ((448, 16, 1024, 128), (448, 16, 1024, 448), (448, 4, 1024, 128),
          (448, 32, 1024, 128))


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sms = sm_count(dev)
    shapes = [(N, r, M) for r in ROW_BYTES for M in ROWS] + list(MORE)
    for n_src, row_bytes, M in shapes:
        src = torch.randn(n_src, row_bytes // 2, generator=gen,
                          device=dev).bfloat16()
        idx = torch.randint(0, n_src, (M,), generator=gen, device=dev,
                            dtype=torch.int32)
        cs.require(torch.equal(moe_gather.gather_rows_cuda(src, idx, 1),
                               torch.index_select(src, 0, idx)),
                   f"rows of {row_bytes} B, M {M}: not bitwise index_select")
        nbytes = (torch.unique(idx).numel() + M) * row_bytes + 4 * M
        n_sets = min(cs.MAX_SETS, -(-cs.ROTATE_BYTES // nbytes))
        sets = [(src, idx)] + [(src.clone(), idx.clone())
                               for _ in range(n_sets - 1)]
        ms = cs.cold_ms(lambda s, i: moe_gather.gather_rows_cuda(s, i, 1),
                        sets)
        lib_ms = cs.cold_ms(lambda s, i: torch.index_select(s, 0, i), sets)
        del sets
        print(json.dumps({
            "N": n_src, "row_bytes": row_bytes, "M": M,
            **moe_gather.gather_plan(M, row_bytes, sms)._asdict(),
            "bound_ms": cs.bound(nbytes, 0)[0], "ms": ms,
            "index_select_ms": lib_ms, "kernel_over_library": ms / lib_ms}),
            flush=True)
    for frames, rows, d, Mb in BLOCKS:
        src = torch.randn(frames * rows, d, generator=gen,
                          device=dev).bfloat16()
        bidx = torch.randperm(frames, generator=gen, device=dev)[:Mb]
        bidx = bidx.to(torch.int32)
        blocks = lambda s, b: torch.index_select(  # noqa: E731
            s.view(frames, rows, d), 0, b)
        cs.require(torch.equal(
            moe_gather.gather_blocks_cuda(src, bidx, rows),
            blocks(src, bidx).reshape(-1, d)),
            f"blocks of {rows} x {d}, Mb {Mb}: not bitwise index_select")
        block_bytes = rows * d * 2
        nbytes = 2 * Mb * block_bytes + 4 * Mb
        n_sets = min(cs.MAX_SETS, -(-cs.ROTATE_BYTES // nbytes))
        sets = [(src, bidx)] + [(src.clone(), bidx.clone())
                                for _ in range(n_sets - 1)]
        ms = cs.cold_ms(lambda s, b: moe_gather.gather_blocks_cuda(
            s, b, rows), sets)
        lib_ms = cs.cold_ms(blocks, sets)
        del sets
        print(json.dumps({
            "frames": frames, "block_rows": rows, "d": d, "Mb": Mb,
            "block_bytes": block_bytes,
            **moe_gather.gather_plan(Mb, block_bytes, sms)._asdict(),
            "bound_ms": cs.bound(nbytes, 0)[0], "ms": ms,
            "index_select_ms": lib_ms, "kernel_over_library": ms / lib_ms}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
