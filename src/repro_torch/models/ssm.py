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

The blocks around them are the SSM family's (RWKV6: ``rwkv6_*``) and
the hybrid family's (Mamba2: ``mamba2_*``), each in two forms: over a
whole sequence, whose recurrence runs through ``ops.wkv6`` / ``ops.ssd``
(the hand-written kernels on the card) with the state carried in and
out, and the one-token step, plain tensor ops as the reference's are
jnp.  The full-sequence forms follow the reference's baseline numerics
(pairwise mode, f32 recurrence operands).  A T that the kernel's chunk
does not divide is padded at the end with rows that leave the state as
it is (wkv6: k = v = w = 0; ssd: dt = 0 and zero x, B, C), and the
output is cut back: the padding the reference's chunked forms do inside.

An ``einsum`` whose operands the reference keeps in ``operand_dtype``
with ``preferred_element_type=f32`` widens them to f32 here first: the
products of two bf16 values are exact in f32, so the two agree up to the
order of the sums.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import dense, layer_norm, rms_norm

Params = Dict[str, torch.Tensor]

__all__ = ["wkv6_chunked", "wkv6_sequential", "ssd_chunked",
           "ssd_sequential", "RWKVState", "rwkv6_state_init",
           "rwkv6_time_mix", "rwkv6_channel_mix", "rwkv6_block",
           "rwkv6_step", "wkv6_padded", "MambaState", "mamba2_state_init",
           "mamba2_seq", "mamba2_step", "ssd_padded"]


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


# ===========================================================================
# the kernels' calls, padded to the chunk
# ===========================================================================

def _pad_rows(T: int, chunk: int) -> int:
    """Rows to append so that ``min(chunk, T)`` divides the sequence."""
    return (-T) % min(chunk, T)


def _pad_t(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` (B, T, ...) with ``pad`` zero rows appended along T."""
    return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))


def wkv6_padded(r, k, v, w, u, *, chunk: int = 64, initial_state=None,
                impl: str = "auto"):
    """``ops.wkv6`` with the state in and out, on any T: a T that the
    chunk does not divide gets zero rows of r, k, v and w (a decay of
    e^0 = 1 and no k v^T term: the state is left as it is), and the
    output is cut back.  Returns (o (B, T, H, V), S (B, H, K, V) f32)."""
    T = r.shape[1]
    pad = _pad_rows(T, chunk)
    if pad:
        r, k, v, w = (_pad_t(a, pad) for a in (r, k, v, w))
    o, S = ops.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                    w.contiguous(), u, impl=impl, chunk=chunk,
                    initial_state=initial_state, return_state=True)
    return o[:, :T], S


def ssd_padded(x, dt, A, B, C, D, *, chunk: int = 128, initial_state=None,
               impl: str = "auto"):
    """``ops.ssd`` with the state in and out, on any T: a T that the chunk
    does not divide gets rows of dt = 0 (a decay of 1) and zero x, B, C
    (the state is left as it is), and the output is cut back.  Returns
    (y (B, T, H, P), S (B, H, N, P) f32)."""
    T = x.shape[1]
    pad = _pad_rows(T, chunk)
    if pad:
        x, dt, B, C = (_pad_t(a, pad) for a in (x, dt, B, C))
    y, S = ops.ssd(x.contiguous(), dt.contiguous(), A, B.contiguous(),
                   C.contiguous(), D, impl=impl, chunk=chunk,
                   initial_state=initial_state, return_state=True)
    return y[:, :T], S


# ===========================================================================
# RWKV6
# ===========================================================================

class RWKVState(NamedTuple):
    S: torch.Tensor          # (B, H, K, V) wkv state, f32
    tm_prev: torch.Tensor    # (B, d) last input to time mix
    cm_prev: torch.Tensor    # (B, d) last input to channel mix


def rwkv6_state_init(cfg: ModelConfig, batch: int, *, device,
                     dtype=torch.float32) -> RWKVState:
    H, K = cfg.num_heads, cfg.head_dim
    return RWKVState(
        S=torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
        tm_prev=torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device),
        cm_prev=torch.zeros((batch, cfg.d_model), dtype=dtype,
                            device=device))


def _token_shift(x: torch.Tensor,
                 x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1}, with ``x_prev`` (B, d) filling t = 0 (zeros if None)."""
    B, T, d = x.shape
    first = (x.new_zeros((B, 1, d)) if x_prev is None
             else x_prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _rwkv6_rkvgw(p: Params, cfg: ModelConfig, x, xx, compute_dtype):
    B, T, _ = x.shape
    H, K = cfg.num_heads, cfg.head_dim
    mu = p["mu"]
    r = dense(p["Wr"], _lerp(x, xx, mu["r"]), compute_dtype).reshape(B, T, H, K)
    k = dense(p["Wk"], _lerp(x, xx, mu["k"]), compute_dtype).reshape(B, T, H, K)
    v = dense(p["Wv"], _lerp(x, xx, mu["v"]), compute_dtype).reshape(B, T, H, K)
    g = dense(p["Wg"], _lerp(x, xx, mu["g"]), compute_dtype)
    xw = _lerp(x, xx, mu["w"]).float()
    wlog = -torch.exp(p["w0"].float()
                      + torch.tanh(xw @ p["wA"].float()) @ p["wB"].float())
    return r, k, v, g, wlog.reshape(B, T, H, K)


def _group_norm(gn: Params, o: torch.Tensor, eps: float) -> torch.Tensor:
    """o (B, T, H, K): a layer norm per head."""
    of = o.float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, unbiased=False, keepdim=True)
    y = (of - mu) * torch.rsqrt(var + eps)
    return (y * gn["scale"] + gn["bias"]).to(o.dtype)


def rwkv6_time_mix(p: Params, cfg: ModelConfig, x, *, x_prev=None,
                   state=None, chunk: int = 64, return_state: bool = False,
                   compute_dtype=torch.bfloat16, impl: str = "auto"):
    """The time mix over a sequence x (B, T, d), from ``x_prev`` (the
    last input before x, or zeros) and the wkv ``state`` (or zero); its
    recurrence is ``ops.wkv6`` (kernel 9 on the card).  Returns the
    output, and with ``return_state`` the final wkv state too."""
    B, T, _ = x.shape
    H, K = cfg.num_heads, cfg.head_dim
    xx = _token_shift(x, x_prev)
    r, k, v, g, w = _rwkv6_rkvgw(p, cfg, x, xx, compute_dtype)
    o, S = wkv6_padded(r, k, v, w, p["u"], chunk=chunk, initial_state=state,
                       impl=impl)
    o = _group_norm(p["gn"], o, cfg.norm_eps).reshape(B, T, H * K)
    out = dense(p["Wo"], o.to(compute_dtype) * F.silu(g), compute_dtype)
    return (out, S) if return_state else out


def rwkv6_channel_mix(p: Params, cfg: ModelConfig, x, *, x_prev=None,
                      compute_dtype=torch.bfloat16):
    xx = _token_shift(x, x_prev)
    kx = _lerp(x, xx, p["cm_mu"]["k"])
    rx = _lerp(x, xx, p["cm_mu"]["r"])
    kk = torch.square(torch.relu(dense(p["cWk"], kx, compute_dtype)))
    return torch.sigmoid(dense(p["cWr"], rx, compute_dtype)) * \
        dense(p["cWv"], kk, compute_dtype)


def rwkv6_block(p: Params, cfg: ModelConfig, x, *, state=None,
                return_state: bool = False, compute_dtype=torch.bfloat16,
                impl: str = "auto"):
    """A full-sequence RWKV6 layer, from ``state`` (an :class:`RWKVState`
    of the sequence so far) or from zero, the reference's
    ``rwkv6_block``.  With ``return_state``, returns (x, the state after
    x: the final wkv state and the last inputs of the two mixes, in the
    state's dtype or f32), the reference's prefill body."""
    h = layer_norm(p["ln1"], x, cfg.norm_eps)
    tm, S = rwkv6_time_mix(
        p, cfg, h, x_prev=None if state is None else state.tm_prev,
        state=None if state is None else state.S, return_state=True,
        compute_dtype=compute_dtype, impl=impl)
    x = x + tm
    h2 = layer_norm(p["ln2"], x, cfg.norm_eps)
    x = x + rwkv6_channel_mix(
        p, cfg, h2, x_prev=None if state is None else state.cm_prev,
        compute_dtype=compute_dtype)
    if not return_state:
        return x
    dt = torch.float32 if state is None else state.tm_prev.dtype
    return x, RWKVState(S=S, tm_prev=h[:, -1].to(dt), cm_prev=h2[:, -1].to(dt))


def rwkv6_step(p: Params, cfg: ModelConfig, x, state: RWKVState, *,
               compute_dtype=torch.bfloat16):
    """One-token decode.  x: (B, 1, d).  Returns (x, new state)."""
    B = x.shape[0]
    H, K = cfg.num_heads, cfg.head_dim
    xn = layer_norm(p["ln1"], x, cfg.norm_eps)
    xx = state.tm_prev[:, None].to(xn.dtype)
    r, k, v, g, w = _rwkv6_rkvgw(p, cfg, xn, xx, compute_dtype)
    rt, kt, vt, wt = (a[:, 0].float() for a in (r, k, v, w))
    S = state.S
    o = torch.einsum("bhkv,bhk->bhv", S, rt)
    o = o + torch.einsum("bhk,bhk->bh", rt,
                         p["u"].float() * kt)[..., None] * vt
    S = torch.exp(wt)[..., None] * S + kt[..., None] * vt[..., None, :]
    o = _group_norm(p["gn"], o[:, None], cfg.norm_eps).reshape(B, 1, H * K)
    x = x + dense(p["Wo"], o.to(compute_dtype) * F.silu(g), compute_dtype)
    xn2 = layer_norm(p["ln2"], x, cfg.norm_eps)
    x = x + rwkv6_channel_mix(p, cfg, xn2, x_prev=state.cm_prev,
                              compute_dtype=compute_dtype)
    return x, RWKVState(S=S, tm_prev=xn[:, 0].to(state.tm_prev.dtype),
                        cm_prev=xn2[:, 0].to(state.cm_prev.dtype))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

class MambaState(NamedTuple):
    S: torch.Tensor            # (B, H, N, P) f32
    conv: torch.Tensor         # (B, W - 1, conv_dim)


def mamba2_state_init(cfg: ModelConfig, batch: int, *, device) -> MambaState:
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.head_dim
    H = di // P
    return MambaState(
        S=torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * N),
                         dtype=torch.float32, device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  x: (B, T, C); w: (W, C).  Returns (y, the
    last W - 1 rows of the context: the next call's ``conv_state``)."""
    W, T = w.shape[0], x.shape[1]
    if conv_state is None:
        ctx = F.pad(x, (0, 0, W - 1, 0))
    else:
        ctx = torch.cat([conv_state.to(x.dtype), x], dim=1)
    y = sum(ctx[:, i:i + T] * w[i].to(x.dtype) for i in range(W))
    y = F.silu(y + b.to(x.dtype))
    return y, (ctx[:, -(W - 1):] if W > 1 else None)


def _mamba2_project(p: Params, cfg: ModelConfig, xn, compute_dtype):
    di, N = cfg.d_inner, cfg.ssm_state
    zxbcdt = dense(p["in_proj"], xn, compute_dtype)
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N],
            zxbcdt[..., 2 * di + 2 * N:])


def _mamba2_ssm_inputs(p: Params, cfg: ModelConfig, xbc_conv, dt_raw):
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.head_dim
    xs, Bs, Cs = (xbc_conv[..., :di], xbc_conv[..., di:di + N],
                  xbc_conv[..., di + N:])
    xh = xs.reshape(xs.shape[0], xs.shape[1], di // P, P)
    a = dt_raw.float() + p["dt_bias"].float()
    dt = torch.logaddexp(a, torch.zeros_like(a))     # softplus
    return xh, dt, Bs, Cs


def _mamba2_out(p: Params, cfg: ModelConfig, x, y, z, compute_dtype):
    """The gated norm and the out projection, with the residual."""
    y = rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return x + dense(p["out_proj"], y.to(compute_dtype), compute_dtype)


def mamba2_seq(p: Params, cfg: ModelConfig, x, *, state=None,
               chunk: int = 128, compute_dtype=torch.bfloat16,
               impl: str = "auto") -> Tuple[torch.Tensor, MambaState]:
    """A Mamba2 layer over a sequence x (B, T, d) with the residual, its
    recurrence ``ops.ssd`` (kernel 10 on the card).  With ``state`` (a
    :class:`MambaState`) the conv and the SSD continue from it, the
    reference's chunked-prefill body, and the new conv state is the
    context's last W - 1 rows; without, they start from zero, the
    reference's prefill body, and the conv state is x's projected last
    W - 1 rows, in f32.  Returns (x, the state after x)."""
    B, T, _ = x.shape
    xn = rms_norm(p["norm"], x, cfg.norm_eps)
    z, xbc, dt_raw = _mamba2_project(p, cfg, xn, compute_dtype)
    xbc_conv, ctx = _causal_conv(
        xbc, p["conv_w"], p["conv_b"],
        conv_state=None if state is None else state.conv)
    xh, dt, Bs, Cs = _mamba2_ssm_inputs(p, cfg, xbc_conv, dt_raw)
    A = torch.exp(p["A_log"].float())
    y, S = ssd_padded(xh, dt, A, Bs, Cs, p["D"], chunk=chunk,
                      initial_state=None if state is None else state.S,
                      impl=impl)
    out = _mamba2_out(p, cfg, x, y.reshape(B, T, cfg.d_inner), z,
                      compute_dtype)
    if state is None:
        conv = xbc[:, -(cfg.ssm_conv - 1):].float()
    else:
        conv = ctx.to(state.conv.dtype)
    return out, MambaState(S=S, conv=conv)


def mamba2_step(p: Params, cfg: ModelConfig, x, state: MambaState, *,
                compute_dtype=torch.bfloat16):
    """One-token decode.  x: (B, 1, d).  Returns (x, new state)."""
    B = x.shape[0]
    xn = rms_norm(p["norm"], x, cfg.norm_eps)
    z, xbc, dt_raw = _mamba2_project(p, cfg, xn, compute_dtype)
    xbc_conv, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                      conv_state=state.conv)
    xh, dt, Bs, Cs = _mamba2_ssm_inputs(p, cfg, xbc_conv, dt_raw)
    A = torch.exp(p["A_log"].float())
    xt, dtt = xh[:, 0].float(), dt[:, 0]
    Bt, Ct = Bs[:, 0].float(), Cs[:, 0].float()
    a = torch.exp(-A * dtt)
    S = a[..., None, None] * state.S + torch.einsum("bn,bhp,bh->bhnp", Bt,
                                                    xt, dtt)
    y = torch.einsum("bn,bhnp->bhp", Ct, S) + p["D"].float()[:, None] * xt
    y = rms_norm(p["gate_norm"], y.reshape(B, 1, cfg.d_inner)
                 .to(compute_dtype) * F.silu(z), cfg.norm_eps)
    out = x + dense(p["out_proj"], y.to(compute_dtype), compute_dtype)
    return out, MambaState(S=S, conv=new_conv.to(state.conv.dtype))
