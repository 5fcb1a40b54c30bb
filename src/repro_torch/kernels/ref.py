"""Plain oracles for the port's kernels: torch copies of the JAX
package's ``kernels/ref.py`` (``matmul_ref``, ``attention_ref``,
``decode_attention_ref``, ``wkv6_ref``, ``ssd_ref``, lines 22-72).

Deliberately naive — full materialisation, no chunking — so they stay
obviously correct.  Operands are widened to f32 and the result is cast
back to the first operand's dtype, as in the reference.
"""

from __future__ import annotations

import math

import torch

__all__ = ["matmul_ref", "attention_ref", "decode_attention_ref",
           "wkv6_ref", "ssd_ref"]


def matmul_ref(x, w):
    return (x.float() @ w.float()).to(x.dtype)


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0):
    """Naive softmax attention with GQA.  q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Sq, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.float())
    s = s / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window:
        mask &= kv_pos > q_pos - window
    s = torch.where(mask[None, :, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_ref(q, k, v, valid_len):
    """One-token attention.  q: (B,H,D); k/v: (B,S,Hkv,D); valid_len scalar."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.float().reshape(B, Hkv, g, D) / math.sqrt(D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    mask = torch.arange(S, device=q.device)[None, None, None, :] < valid_len
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def wkv6_ref(r, k, v, w, u):
    """Sequential WKV6 (same math as models.ssm.wkv6_sequential)."""
    from repro_torch.models.ssm import wkv6_sequential
    return wkv6_sequential(r, k, v, w, u)


def ssd_ref(x, dt, A, B, C, D):
    """Sequential Mamba2 SSD (same math as models.ssm.ssd_sequential)."""
    from repro_torch.models.ssm import ssd_sequential
    y, _ = ssd_sequential(x, dt, A, B, C, D)
    return y
