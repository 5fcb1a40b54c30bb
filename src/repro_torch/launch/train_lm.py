"""End-to-end training example, the port of ``examples/train_lm.py``:
a ~115M-parameter LM, a few hundred steps.

Uses the full stack through the train CLI (:mod:`repro_torch.launch.
train`): the AMU-prefetched data pipeline, the train step (remat +
gradient accumulation), AdamW, async atomic checkpoints, straggler
detection — on the phi4 family scaled to ~115M parameters.

Run:  PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200]
      [--device cpu] [--ckpt-dir DIR]

The synthetic corpus is a learnable affine-recurrence task, so the loss
drops from ~ln(V) as the model memorises the transition pool.  The
checkpoints go to ``--ckpt-dir``, or to a temporary directory that is
removed at the end.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import tempfile
import types
from typing import Iterator, List, Optional, Sequence

from repro_torch import configs
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod

__all__ = ["config", "registered", "main"]


def config() -> ModelConfig:
    """~115M parameters: the phi4 smoke config scaled up."""
    return dataclasses.replace(
        configs.get_smoke("phi4-mini-3.8b"), name="phi4-100m",
        num_layers=12, d_model=640, num_heads=8, num_kv_heads=4,
        head_dim=80, d_ff=2560, vocab_size=32000)


@contextlib.contextmanager
def registered(cfg: ModelConfig) -> Iterator[str]:
    """``cfg`` in the config registry under its name for as long as the
    block runs (as both CONFIG and SMOKE), so the CLI path stays the
    single entry point; yields the name."""
    module = f"_example_{cfg.name.replace('-', '_')}"
    mod = types.ModuleType(f"repro_torch.configs.{module}")
    mod.CONFIG = mod.SMOKE = cfg
    configs._ARCH_MODULES[cfg.name] = module
    sys.modules[mod.__name__] = mod
    try:
        yield cfg.name
    finally:
        del configs._ARCH_MODULES[cfg.name]
        del sys.modules[mod.__name__]


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = config()
    print(f"[example] {cfg.name}: ~{cfg.param_count()/1e6:.0f}M params")
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="train_lm_"))
        arch = stack.enter_context(registered(cfg))
        losses = train_mod.main([
            "--arch", arch, "--smoke",
            "--steps", str(args.steps),
            "--batch", "8", "--seq", "128",
            "--lr", "1e-3",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "100",
            "--log-every", "20", "--device", args.device,
        ])
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss should decrease: {losses[0]:.3f} -> "
                           f"{losses[-1]:.3f}")
    print(f"[example] final loss {losses[-1]:.3f} (from {losses[0]:.3f})")
    return losses


if __name__ == "__main__":
    main()
