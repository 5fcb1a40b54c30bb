"""Linear recurrences of RWKV6 ("Finch") and Mamba2 (SSD) on tensors:
the counterparts of the JAX package's ``models/ssm.py`` forms
``wkv6_sequential`` / ``wkv6_chunked`` and ``ssd_sequential`` /
``ssd_chunked``, with their signatures, layouts and numerics.

Both stream a fixed-size recurrent state over the sequence (the AMU
stream pattern at model level).  Two forms of each:

  * ``*_sequential`` — O(T) loop over single tokens: the oracle,
  * ``*_chunked``    — chunked parallel form (intra-chunk pairwise decay
    + inter-chunk state scan); numerically safe because the pairwise
    exponents ``W_t - W_s (s <= t)`` are always <= 0.  This is what the
    reference's ``impl="xla"`` runs, and the plain version of the CUDA
    kernels ``kernels/csrc/wkv6.cu`` and ``ssd.cu``.

The blocks around them (``rwkv6_*``, ``mamba2_*``) belong to the SSM
model family and are not here yet.  An ``einsum`` whose operands the
reference keeps in ``operand_dtype`` with ``preferred_element_type=f32``
widens them to f32 here first: the products of two bf16 values are
exact in f32, so the two agree up to the order of the sums.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["wkv6_chunked", "wkv6_sequential", "ssd_chunked",
           "ssd_sequential"]


def wkv6_sequential(r, k, v, w, u):
    """Oracle WKV6: per-head recurrence.

    r,k,w: (B,T,H,K); v: (B,T,H,V); u: (H,K); w = log-decay (<=0).
    Returns o: (B,T,H,V).  o_t = S_{t-1}^T r_t + (r_t . (u*k_t)) v_t;
    S_t = diag(e^{w_t}) S_{t-1} + k_t v_t^T.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    S = torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        o = torch.einsum("bhkv,bhk->bhv", S, rt)
        o = o + torch.einsum("bhk,bhk->bh", rt, uf * kt)[..., None] * vt
        S = torch.exp(wt)[..., None] * S + kt[..., None] * vt[..., None, :]
        outs.append(o)
    return torch.stack(outs, dim=1).to(r.dtype)


#: factorized mode clamps in-chunk cumulative log-decay at -_WKV_CLAMP:
#: contributions decayed below e^-20 are numerically zero anyway, and the
#: clamp keeps exp(-W) <= e^20 (safe in f32 AND bf16).
_WKV_CLAMP = 20.0


def _chunks(a, n: int, c: int):
    """(B, n * c, ...) -> (n, B, c, ...): the chunk axis first."""
    return a.reshape(a.shape[0], n, c, *a.shape[2:]).transpose(0, 1)


def wkv6_chunked(r, k, v, w, u, *, chunk: int = 64,
                 initial_state: Optional[torch.Tensor] = None,
                 return_state: bool = False,
                 mode: str = "pairwise",
                 operand_dtype=None):
    """Chunked WKV6 (GLA-style): intra-chunk decay + state scan.

    ``mode``:
      * ``"pairwise"``  — materialises the exact (c, c, K) pairwise decay
        tensor (always stable since exponents are <= 0),
      * ``"factorized"``— att = (r * e^{W_prev}) @ (k * e^{-W})^T with the
        exponent clamped at ``_WKV_CLAMP``: no (c, c, K) tensor; error
        bounded by dropping contributions decayed below e^-20.

    A ``T`` that is not a multiple of the chunk is zero-padded, and the
    padding cut from the output, as in the reference.  Returns o
    (B, T, H, V) in r's dtype, and with ``return_state`` the final
    (B, H, K, V) f32 state too.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        r, k, v, w = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, w))
    n = (T + pad) // c
    opd = operand_dtype or torch.float32      # matmul operand dtype
    rf, kf, vf = (_chunks(a.to(opd), n, c) for a in (r, k, v))
    # the decay path stays f32: cumsum+exp precision sets state fidelity
    wf = _chunks(w.float(), n, c)
    uf = u.float()
    idx = torch.arange(c, device=r.device)
    mask = idx[:, None] > idx[None, :]

    S = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if initial_state is None else initial_state.float())
    outs = []
    for j in range(n):
        rc, kc, vc, wc = rf[j], kf[j], vf[j], wf[j]   # (B,c,H,K|V)
        Wc = torch.cumsum(wc, dim=1)              # inclusive
        # inter-chunk: o_t += (r_t * e^{W_{t-1}}) . S_in
        decay_q = torch.exp(Wc - wc).to(opd)      # e^{W_{t-1}} <= 1
        o_inter = torch.einsum("bthk,bhkv->bthv", (rc * decay_q).float(), S)
        if mode == "factorized":
            rp = rc * torch.exp(torch.clamp(Wc - wc, min=-_WKV_CLAMP)).to(opd)
            kp = kc * torch.exp(-torch.clamp(Wc, min=-_WKV_CLAMP)).to(opd)
            att = torch.einsum("bthk,bshk->btsh", rp.float(), kp.float())
            att = att * mask[None, :, :, None]
        else:
            # intra-chunk pairwise: s < t strictly; decay e^{W_{t-1} - W_s}
            pair = (Wc - wc)[:, :, None] - Wc[:, None, :, :]  # (B,t,s,H,K)
            pairdec = (torch.exp(torch.clamp(pair, max=0.0))
                       * mask[None, :, :, None, None]).to(opd)
            att = torch.einsum("bthk,btshk,bshk->btsh", rc.float(),
                               pairdec.float(), kc.float())
        o_intra = torch.einsum("btsh,bshv->bthv", att.to(opd).float(),
                               vc.float())
        # bonus diagonal s = t
        o_diag = torch.einsum("bthk,bthk->bth", rc.float(),
                              (uf.to(opd) * kc).float())[..., None] \
            * vc.float()
        # state update: S_out = e^{W_last} S + sum_s e^{W_last - W_s} k_s v_s^T
        Wl = Wc[:, -1][:, None]                   # (B,1,H,K)
        kdec = kc * torch.exp(Wl - Wc).to(opd)
        S = torch.exp(Wl[:, 0])[..., None] * S + torch.einsum(
            "bshk,bshv->bhkv", kdec.float(), vc.float())
        outs.append(o_inter + o_intra + o_diag)
    o = torch.stack(outs, dim=1).reshape(B, n * c, H, V)[:, :T].to(r.dtype)
    return (o, S) if return_state else o


def ssd_sequential(x, dt, A, B, C, D):
    """Oracle SSD.  x:(B,T,H,P) dt:(B,T,H) A:(H,) B,C:(B,T,N).

    S_t = e^{-A dt_t} S_{t-1} + dt_t B_t x_t^T; y_t = C_t^T S_t + D x_t.
    Returns (y in x's dtype, the final (B, H, N, P) f32 state).
    """
    Bb, T, H, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = (a.float() for a in (x, dt, B, C))
    Af, Df = A.float(), D.float()
    S = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        xt, dtt, Bt, Ct = xf[:, t], dtf[:, t], Bf[:, t], Cf[:, t]
        a = torch.exp(-Af * dtt)                      # (B,H)
        S = a[..., None, None] * S + torch.einsum(
            "bn,bhp,bh->bhnp", Bt, xt, dtt)
        ys.append(torch.einsum("bn,bhnp->bhp", Ct, S) + Df[:, None] * xt)
    return torch.stack(ys, dim=1).to(x.dtype), S


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 128,
                initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Chunked SSD: scalar per-head decay -> cheap pairwise (c x c) masks.

    A ``T`` that is not a multiple of the chunk is zero-padded, and the
    padding cut from the output.  Returns y (B, T, H, P) in x's dtype,
    and with ``return_state`` the final (B, H, N, P) f32 state too.
    """
    Bb, T, H, P = x.shape
    N = B.shape[-1]
    c = min(chunk, T)
    pad = (-T) % c
    if pad:
        x, dt, B, C = (F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
                       for a in (x, dt, B, C))
    n = (T + pad) // c
    xf, dtf, Bf, Cf = (_chunks(a.float(), n, c) for a in (x, dt, B, C))
    Af, Df = A.float(), D.float()
    idx = torch.arange(c, device=x.device)
    mask = idx[:, None] >= idx[None, :]

    S = (torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    ys = []
    for j in range(n):
        xc, dtc, Bc, Cc = xf[j], dtf[j], Bf[j], Cf[j]  # x (B,c,H,P) ...
        dA = -Af * dtc                            # log decay (B,c,H)
        L = torch.cumsum(dA, dim=1)               # inclusive
        o_inter = torch.einsum("btn,bhnp->bthp", Cc, S) \
            * torch.exp(L)[..., None]
        # pairwise s <= t: decay exp(L_t - L_s) * dt_s (B,t,s,H)
        pair = L[:, :, None] - L[:, None, :, :]
        G = torch.exp(torch.clamp(pair, max=0.0)) * mask[None, :, :, None]
        CB = torch.einsum("btn,bsn->bts", Cc, Bc)
        M = CB[..., None] * G * dtc[:, None]      # (B,t,s,H)
        o_intra = torch.einsum("btsh,bshp->bthp", M, xc)
        # state update
        Ll = L[:, -1]                             # (B,H)
        kdec = torch.exp(Ll[:, None] - L) * dtc   # (B,c,H)
        S = torch.exp(Ll)[..., None, None] * S + torch.einsum(
            "bsn,bshp,bsh->bhnp", Bc, xc, kdec)
        ys.append(o_inter + o_intra + Df[:, None] * xc)
    y = torch.stack(ys, dim=1).reshape(Bb, n * c, H, P)[:, :T].to(x.dtype)
    return (y, S) if return_state else y
