"""Where a train step's time goes on the card: the port's train step
(``repro_torch.steps.make_train_step``) under ``torch.profiler``.

    python tools/train_profile.py [--arch h2o-danube-1.8b] [--layers N]
        [--seq 4096] [--batch 4] [--microbatches 2] [--remat block]
        [--table PATH]

Draws the arch's f32 weights on the card from a seed (``--layers`` cuts
the depth; ``--arch phi4-100m`` is the train_lm example's config), takes
a batch of the synthetic stream, runs two steps unprofiled (the second
timed) and one under the profiler, and prints: the unprofiled step's
seconds, the profiled step's wall and device-busy seconds and the busy
share, device time by kind of kernel (matrix products, elementwise,
reductions, copies, the rest; ``--table`` splits them by op, such as
``aten::bmm`` and ``aten::mm``), the kernel launches and the
host's op count, and the ten kernels that took most device time; the
whole per-kernel table goes to ``--table``.  It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.steps import make_train_step  # noqa: E402


def kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma", "gemv")):
        return "matrix products"
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return "copies"
    if "reduce" in low or "softmax" in low or "norm" in low:
        return "reductions"
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    return "other kernels"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--remat", default="block")
    ap.add_argument("--table", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    example = train_lm.config()
    cfg = example if args.arch == example.name else get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, TrainConfig(microbatches=args.microbatches,
                                            remat=args.remat))
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
    step(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds, launches, host_ops = {}, 0, 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            k = kind(ev.name)
            kinds[k] = kinds.get(k, 0.0) + us
            launches += 1
        elif ev.name.startswith("aten::"):
            host_ops += 1
    busy = sum(kinds.values()) / 1e6
    name = torch.cuda.get_device_name(0)
    print(f"[profile] {name}; {cfg.name} ({cfg.num_layers} layers), "
          f"{args.batch} x {args.seq} tokens in {args.microbatches} "
          f"microbatches, remat {args.remat}")
    print(f"[profile] unprofiled step {plain_s:.3f} s "
          f"({args.batch * args.seq / plain_s:.1f} tok/s); profiled step "
          f"{wall:.3f} s wall, device busy {busy:.3f} s ({busy / wall:.3f} "
          f"of the wall); {launches} kernel launches, {host_ops} aten ops "
          f"on the host")
    for k, us in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {k}: {us / 1e6:.3f} s ({us / 1e6 / busy:.3f} of "
              f"device time)")
    avg = prof.key_averages()
    table = avg.table(sort_by="self_cuda_time_total", row_limit=-1)
    rows = sorted(((e.key, e.self_device_time_total, e.count) for e in avg
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    for key, us, n in rows[:10]:
        print(f"[profile] {us / 1e6:.4f} s / {n}: {key[:110]}")
    if args.table:
        Path(args.table).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table).write_text(table)
    return 0


if __name__ == "__main__":
    sys.exit(main())
