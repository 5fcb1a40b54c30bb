"""The train CLI, the port of ``repro.launch.train``.

Wires the substrates together: config -> seeded init on the device ->
AMU prefetching data loader (copies on a side CUDA stream) -> train step
(remat, gradient accumulation, AdamW) -> checkpoints (async, atomic,
resumable) -> fault tolerance (heartbeat, straggler detection, recovery
from the latest checkpoint).  The dense family without experts trains;
the other families raise ``NotImplementedError``.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch h2o-danube-1.8b --smoke --steps 12 --batch 4 --seq 64

The device is ``cuda`` unless ``--device cpu`` is given; without a CUDA
device the CLI exits non-zero.  ``--data-axis`` and ``--model-axis``
are the reference's mesh flags: on one device both must be 1.

Recovery (``--fail-at-step N``) restores the latest checkpoint and
rebuilds the loader at the restored step of this run's own stream, so
the replayed steps see the batches they saw before and a recovered run
repeats the uninterrupted one.  The reference keeps drawing from its
stream there, so its replayed steps train on later batches.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint.checkpoint import (latest_step, prune, restore,
                                               save, wait_pending)
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.pipeline import make_loader
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault_tolerance import Heartbeat, StragglerDetector
from repro_torch.steps import make_train_step

__all__ = ["parse", "run", "main"]


def parse(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="block",
                    choices=["none", "block", "dots"])
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject one failure (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Dict[str, object]:
    """Train as ``args`` say.  Returns {"losses": per step run,
    "step_s": each step's host seconds (ending in the loss's read,
    which waits for the device), "loader": the loader's AMU counts,
    "params", "opt", "steps": the last step, "restore_s": the seconds of
    the recovery's restore (or None), "save_s": those of the last
    synchronous save (or None)}."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("[train] no CUDA device; pass --device cpu to "
                         "train on the CPU")
    if args.data_axis != 1 or args.model_axis != 1:
        raise SystemExit("[train] --data-axis/--model-axis other than 1 "
                         "need sharding, which the port does not have yet "
                         "(ROADMAP.md queue 1, item 2)")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       microbatches=args.microbatches, remat=args.remat,
                       seed=args.seed)
    print(f"[train] arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"device={device} batch={args.batch}x{args.seq}")

    step_fn = make_train_step(cfg, tcfg, shape)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    opt = adamw_init(params)

    start = 0
    if args.ckpt_dir and args.resume and latest_step(args.ckpt_dir) is not None:
        (params, opt), meta = restore(args.ckpt_dir, target=(params, opt),
                                      device=device)
        start = meta.get("step", latest_step(args.ckpt_dir))
        print(f"[train] resumed from step {start}")

    def loader_at(step: int):
        return make_loader(cfg, shape, seed=args.seed, start_step=start,
                           device=device, skip=step - start)

    loader = loader_at(start)
    hb = Heartbeat(timeout_s=600.0)
    stragglers = StragglerDetector(threshold=2.5)
    losses: List[float] = []
    step_s: List[float] = []
    counts = {"aloads": 0, "landed": 0, "waited": 0}
    t_start = time.time()
    failed_once = False
    restore_s = save_s = None

    step = start
    while step < args.steps:
        batch = next(loader)
        t0 = time.time()
        if args.fail_at_step == step and not failed_once:
            failed_once = True
            print(f"[train] injecting failure at step {step}")
            wait_pending()
            if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
                t1 = time.time()
                (params, opt), meta = restore(
                    args.ckpt_dir, target=(params, opt), device=device)
                restore_s = time.time() - t1
                step = meta.get("step", 0)
                print(f"[train] recovered from checkpoint at step {step} "
                      f"({restore_s:.2f}s)")
                counts = {k: counts[k] + n
                          for k, n in loader.counts().items()}
                loader = loader_at(step)
                continue
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        step_s.append(dt)
        rep = stragglers.record(dt)
        if rep is not None:
            print(f"[train] straggler step {rep.step}: {rep.ratio:.1f}x median")
        hb.beat()
        step += 1
        if step % args.log_every == 0:
            tok_s = shape.tokens / dt
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms/step "
                  f"({tok_s/1e3:.1f}k tok/s)")
        if args.ckpt_dir and step % args.ckpt_every == 0:
            save(args.ckpt_dir, step, (params, opt),
                 metadata={"step": step, "loss": loss}, async_=True)
            prune(args.ckpt_dir, keep=3)
    wait_pending()
    if args.ckpt_dir:
        t1 = time.time()
        save(args.ckpt_dir, step, (params, opt),
             metadata={"step": step, "loss": losses[-1] if losses else None})
        save_s = time.time() - t1
    counts = {k: counts[k] + n for k, n in loader.counts().items()}
    wall = time.time() - t_start
    print(f"[train] done: {step - start} steps in {wall:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"stragglers {stragglers.straggler_fraction:.1%}")
    return {"losses": losses, "step_s": step_s, "loader": counts,
            "params": params, "opt": opt, "steps": step,
            "restore_s": restore_s, "save_s": save_s}


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """The CLI: trains and returns the losses, as the reference does."""
    return run(parse(argv))["losses"]


if __name__ == "__main__":
    main()
