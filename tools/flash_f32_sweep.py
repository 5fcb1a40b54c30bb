"""Time the f32 dense flash kernel at each of its plans.

    python3 tools/flash_f32_sweep.py

Needs one NVIDIA Hopper card and ``nvcc`` (the kernel is built at first
launch).  For the f32 flash cases of ``chip_smoke.py`` phase 2d (the
reference benchmark's B1 H4/2 S256 D64, and phi4-mini-3.8b's 24/8 heads
of 128 over a causal 2048-token prompt and a 256-token chunk at 1792)
and a few more shapes, it runs the kernel at every ``warps_q`` of
``flash_attention.F32_FLASH_WARPS_Q`` (query rows a block = 16 *
warps_q; the block's other warps split each stage's positions), holds
each within the reference's bar (5e-6 of max |ref|) of the plain
version, and times each and SDPA as ``chip_smoke.cold_ms`` times them
(L2 flushed, input copies rotated, calls queued behind a device sleep),
with the plan ``flash_attention.f32_flash_plan`` picks.  The card's name
and power limit come first; each shape's numbers are one JSON line.
"""

from __future__ import annotations

import json
import subprocess
import sys
from importlib import import_module
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.decode_attention import sm_count  # noqa: E402

fa = import_module("repro_torch.kernels.flash_attention")

#: more shapes beside phase 2d's: (what, B, H, Hkv, Sq, Skv, D, q_offset)
MORE = (("B4 phi4 heads, causal 512", 4, 24, 8, 512, 512, 128, 0),
        ("B1 H32/8 D80, causal 1024", 1, 32, 8, 1024, 1024, 80, 0),
        ("B2 H8/2 D64, 128-token chunk at 896", 2, 8, 2, 128, 1024, 64, 896))


def cases(dev):
    """(what, q, k, v, q_offset) of each shape, drawn from a seeded
    generator."""
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    shapes = [(label, c["B"], c["H"], c["Hkv"], c["Sq"], c["Skv"], c["D"],
               c["q_offset"]) for kind, dt, label, c in cs.DENSE_CASES
              if kind == "flash" and dt == torch.float32] + list(MORE)
    for label, B, H, Hkv, Sq, Skv, D, off in shapes:
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev)
        k = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev)
        v = torch.randn(B, Skv, Hkv, D, generator=gen, device=dev)
        yield label, q, k, v, off


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_f32_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, q, k, v, off in cases(dev):
        B, Sq, H, D = q.shape
        Hkv = k.shape[2]
        ref = fa.flash_attention_torch(q, k, v, causal=True, q_offset=off)
        qs = q.transpose(1, 2).contiguous()
        ks, vs = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2)
                  .contiguous() for t in (k, v))
        q_pos = off + torch.arange(Sq, device=dev)
        mask = torch.arange(k.shape[1], device=dev)[None, :] <= q_pos[:, None]
        lib_sets, _ = cs._rotated((qs, ks, vs, mask))
        line = {"case": label, "B": B, "H": H, "Hkv": Hkv, "Sq": Sq,
                "Skv": k.shape[1], "D": D, "q_offset": off,
                "plan": fa.f32_flash_plan(B, H, Sq, sm_count(dev)),
                "sdpa_ms": cs.cold_ms(
                    lambda *a: sdpa(*a[:3], attn_mask=a[3]), lib_sets)}
        del lib_sets
        sets, _ = cs._rotated((q, k, v))
        for wq in fa.F32_FLASH_WARPS_Q:
            def run(a, b, c, wq=wq):
                return fa.flash_attention_cuda(a, b, c, causal=True,
                                               q_offset=off, warps_q=wq)
            rel = cs._rel(run(q, k, v), ref)[1]
            cs.require(rel < cs.F32_TOL, f"{label}, warps_q {wq}: "
                       f"{rel:.3e} of max |ref|")
            line[f"warps_q{wq}_ms"] = cs.cold_ms(run, sets)
            line[f"warps_q{wq}_rel_err"] = rel
        del sets
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
