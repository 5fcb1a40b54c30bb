"""AdamW with global-norm clipping and a warmup + cosine schedule, the
reference's arithmetic on nested dicts of tensors.

The moments are f32 tensors shaped like the parameters and the step
counter an int32 scalar tensor, all on the parameters' device, so that
nothing in an update waits for the host.  :func:`adamw_update` writes
the parameters and the moments in place (the reference's step donates
them) and returns them with the counter advanced.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, tree_map

__all__ = ["OptState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm"]


class OptState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor


def adamw_init(params) -> OptState:
    leaf = leaves(params)[0]
    return OptState(
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        step=torch.zeros((), dtype=torch.int32, device=leaf.device))


def lr_schedule(cfg: TrainConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """step -> learning rate: linear warmup over ``warmup_steps``, then a
    cosine to zero at ``total_steps``, in f32."""
    def fn(step):
        step = step.float()
        warm = cfg.lr * (step + 1.0) / max(1, cfg.warmup_steps)
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0.0, 1.0)
        cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < cfg.warmup_steps, warm, cos)
    return fn


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def adamw_update(grads, opt_state: OptState, params, cfg: TrainConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: gradients clipped to ``grad_clip`` global norm,
    bias-corrected moments, decoupled weight decay, the learning rate
    read at the incremented step.  ``params`` and the moments change in
    place; ``grads`` may be consumed.  Returns (params, state with
    ``step + 1``, {"grad_norm", "lr"})."""
    step = opt_state.step + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0)
             if cfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    lr = lr_schedule(cfg)(step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads),
                          leaves(opt_state.m), leaves(opt_state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(m=opt_state.m, v=opt_state.v, step=step), metrics
