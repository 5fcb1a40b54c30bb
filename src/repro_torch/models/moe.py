"""Mixture-of-Experts block with sort-based, capacity-bounded dispatch:
the counterpart of ``repro.models.moe``.

This is the AMU gather pattern (:class:`repro_torch.core.patterns.
GatherPattern`) at model scale: expert dispatch and combine are indexed
row gathers, and both go through :func:`repro_torch.kernels.ops.
gather_rows` — the hand-written CUDA kernel on the card, its plain
version on the CPU.  A gather moves bits only, so the block computes
the same function either way.

Dropping semantics, as in the reference: per (sequence, expert)
capacity ``C = ceil(S·k/E · capacity_factor)``; pairs beyond C are
dropped (their gate mass is simply not added — standard Switch
behaviour).  Each batch row is its own sequence: the reference's
``vmap`` over rows is written out as a batch dimension, one stable sort
of every row's (pair → expert) ids and per-row offsets into the
flattened (B·S, d) token rows and (B·E·C, d) capacity slots.

The dispatch is one gather: each capacity slot fetches the row of the
token routed to it from the tokens with a zero row appended, and an
empty slot fetches that zero row — the bits of the reference's zeroed
buffer with ``xr[st] * keep`` set into its slots.

The combine is deterministic on the card.  The reference scatter-adds
the k gated expert rows of each token (``.at[st].add``); here the
inverse of the sort permutation puts each (token, choice j) pair's slot
back in token order, one gather fetches the k rows of every token, and
a sum over j adds them in a fixed order — no atomics, so two runs give
the same bits.  The order of the k additions differs from XLA's
scatter-add, so the block matches the reference at f32 tolerance, not
bitwise.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

__all__ = ["moe_init", "moe_block", "dispatch", "Dispatch",
           "expert_capacity", "rows_per_block"]


def expert_capacity(cfg: ModelConfig, seq_len: int) -> int:
    pairs = seq_len * cfg.experts_per_token
    return max(1, math.ceil(pairs / cfg.num_experts * cfg.capacity_factor))


def rows_per_block(M: int) -> int:
    """The gather kernel's rows per block for M rows: the largest of 8,
    4, 2, 1 that divides M."""
    return next(r for r in (8, 4, 2, 1) if M % r == 0)


def moe_init(cfg: ModelConfig, generator: torch.Generator, device,
             dtype=torch.float32, layers: Optional[int] = None) -> Params:
    """Random MoE parameters with the reference's shapes and scales:
    router ``{"w"}`` (d, E) and the expert stacks ``gate``/``up``
    (E, d, ff) scaled by d^-0.5, ``down`` (E, ff, d) by ff^-0.5, drawn
    from ``generator``.  ``layers`` stacks them on a leading axis."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = () if layers is None else (layers,)

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=generator, dtype=dtype,
                           device=device).mul_(scale)

    return {"router": {"w": normal((d, E), d ** -0.5)},
            "gate": normal((E, d, ff), d ** -0.5),
            "up": normal((E, d, ff), d ** -0.5),
            "down": normal((E, ff, d), ff ** -0.5)}


def _dispatch_indices(sorted_e: torch.Tensor, E: int, C: int):
    """Per-row slot assignment for pairs sorted by expert id.

    sorted_e: (..., P) int ascending expert ids along the last axis.
    Returns (slot, keep): slot in [0, E*C) for kept pairs; dropped pairs
    get slot E*C.
    """
    P = sorted_e.shape[-1]
    experts = torch.arange(E, dtype=sorted_e.dtype, device=sorted_e.device)
    starts = torch.searchsorted(
        sorted_e, experts.expand(*sorted_e.shape[:-1], E).contiguous(),
        side="left")
    rank = (torch.arange(P, device=sorted_e.device)
            - torch.gather(starts, -1, sorted_e))
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    return slot, keep


def _route(p: Params, x: torch.Tensor, k: int, renorm_gates: bool):
    """Routing in f32: (probs (B, S, E), gates (B, S, k), expert ids
    (B, S, k)) — softmax over the router's logits, then top-k, then the
    gates renormalised to sum to one."""
    logits = x.float() @ p["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)
    if renorm_gates:
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_ids


def _sort_pairs(flat_ids: torch.Tensor, E: int, C: int):
    """(order, slot, keep) of every row's pairs (B, P): the stable sort
    by expert id — pairs of one expert stay in token order, as
    ``jnp.argsort`` keeps them — and each sorted pair's capacity slot
    (:func:`_dispatch_indices`)."""
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    slot, keep = _dispatch_indices(torch.gather(flat_ids, 1, order), E, C)
    return order, slot, keep


class Dispatch(NamedTuple):
    """The index vectors of one MoE block's gathers, every batch row's
    pairs flattened: M = B·S·k pairs, S tokens and C capacity slots per
    expert per row.

    ``tokens`` (B·E·C,) int32: the dispatch gather's rows, one per
    capacity slot, of the (B·S + 1, d) tokens with a zero row appended:
    the token routed to that slot, or the zero row (B·S) where the slot
    is empty; ``slots`` (M,) int32: the combine gather's rows of the
    (B·E·C, d) expert outputs, one per pair in token order (s·k + j);
    ``weights`` (M,) f32: each such pair's gate, 0 where dropped."""

    capacity: int
    tokens: torch.Tensor
    slots: torch.Tensor
    weights: torch.Tensor
    aux: torch.Tensor


def dispatch(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
             capacity: Optional[int] = None,
             renorm_gates: bool = True) -> Dispatch:
    """Route x (B, S, d) and lay out the block's gathers
    (:class:`Dispatch`), with the reference's Switch aux loss."""
    B, S, _ = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity or expert_capacity(cfg, S)
    P = S * k
    dev = x.device
    probs, gate_vals, expert_ids = _route(p, x, k, renorm_gates)

    # -- aux load-balancing loss (Switch): E * sum_e f_e * P_e ----------------
    flat_ids = expert_ids.reshape(B, P)
    counts = torch.zeros((B, E), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, flat_ids, torch.ones_like(flat_ids,
                                                     dtype=torch.float32))
    f_e = counts / P                                            # (B, E)
    p_e = probs.mean(dim=1)                                     # (B, E)
    aux = cfg.router_aux_coef * E * torch.mean(torch.sum(f_e * p_e, dim=-1))

    # -- sort-based dispatch, every row at once (pair q = s * k + j is -------
    #    token s's j-th choice) ---------------------------------------------
    order, slot, keep = _sort_pairs(flat_ids, E, C)              # (B, P)
    rows = torch.arange(B, device=dev)[:, None]
    # each kept pair names its slot's token; empty slots keep the zero
    # row; dropped pairs all land in the extra column E*C, cut off
    tokens = torch.full((B, E * C + 1), B * S, dtype=torch.int64,
                        device=dev).scatter_(1, slot, rows * S + order // k)
    tokens = tokens[:, :-1].reshape(-1).to(torch.int32)

    # -- combine layout: each pair's slot back in token order ----------------
    inv = torch.empty_like(order).scatter_(   # sorted position of pair q
        1, order, torch.arange(P, device=dev).expand(B, P))
    slot_q = torch.gather(slot, 1, inv)
    keep_q = torch.gather(keep, 1, inv)
    slots = (rows * (E * C) + torch.clamp_max(slot_q, E * C - 1)
             ).reshape(-1).to(torch.int32)
    weights = (gate_vals.reshape(B, P) * keep_q).reshape(-1)
    return Dispatch(C, tokens, slots, weights, aux)


def moe_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              capacity: Optional[int] = None, compute_dtype=torch.bfloat16,
              renorm_gates: bool = True, impl: str = "auto"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (out (B, S, d) in x's dtype, aux loss f32 scalar).
    ``impl`` selects the gathers' implementation
    (:func:`repro_torch.kernels.ops.gather_rows`)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    plan = dispatch(p, cfg, x, capacity=capacity, renorm_gates=renorm_gates)
    C, M = plan.capacity, B * S * k

    xc = x.to(compute_dtype).reshape(B * S, d)
    src = torch.cat([xc, xc.new_zeros(1, d)])       # row B*S: empty slots
    buf = ops.gather_rows(src, plan.tokens, impl=impl,
                          rows_per_block=rows_per_block(B * E * C))
    buf = buf.reshape(B, E, C, d)

    # -- expert FFN (einsum over stacked expert weights) ----------------------
    g = torch.einsum("becd,edf->becf", buf, p["gate"].to(compute_dtype))
    u = torch.einsum("becd,edf->becf", buf, p["up"].to(compute_dtype))
    h = torch.nn.functional.silu(g) * u
    eo = torch.einsum("becf,efd->becd", h, p["down"].to(compute_dtype))

    # -- combine: gather back by slot, weight by gate, sum a token's k rows ---
    y = ops.gather_rows(eo.reshape(B * E * C, d), plan.slots, impl=impl,
                        rows_per_block=rows_per_block(M))        # (M, d)
    y = y * plan.weights[:, None].to(y.dtype)
    out = y.reshape(B, S, k, d).sum(dim=2)
    return out.to(x.dtype), plan.aux
