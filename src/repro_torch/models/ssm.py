"""Mamba2 (SSD — state-space duality) block [arXiv:2405.21060], the port
of the JAX package's ``models/ssm.py``.

Chunked SSD: intra-chunk quadratic (dual/attention) form + an inter-chunk
state recurrence (a Python loop over the chunks where the reference
scans), O(L * Q) instead of O(L^2); single-step recurrence for decode
with O(1) state:

  h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x)_t,   y_t = C_t . h_t + D x_t

Separate projections and depthwise convs for x, B and C, as in the
reference. Shapes: d_inner = expand * d_model; nheads = d_inner /
head_dim; activations carry the client axis m in front: x [m, b, l, h,
p]; B, C: [m, b, l, n] (ngroups = 1); dt: [m, b, l, h]. The SSD core has
no weights, so it folds the clients into its batch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng
from .layers import Params, bcast, dense_init, mm

D_CONV = 4           # depthwise conv width (Mamba2 default)
DEFAULT_CHUNK = 128


def init_mamba2(key: torch.Tensor, d_model: int, d_state: int, *,
                expand: int = 2, head_dim: int = 64,
                dtype=torch.float32) -> Params:
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    ks = prng.split(key, 9)
    dev = key.device
    return {
        "wz": dense_init(ks[0], (d_model, d_inner), dtype),
        "wx": dense_init(ks[1], (d_model, d_inner), dtype),
        "wB": dense_init(ks[2], (d_model, d_state), dtype),
        "wC": dense_init(ks[3], (d_model, d_state), dtype),
        "wdt": dense_init(ks[4], (d_model, nheads), dtype),
        "conv_x": dense_init(ks[5], (D_CONV, d_inner), dtype,
                             fan_in=D_CONV),
        "conv_B": dense_init(ks[6], (D_CONV, d_state), dtype, fan_in=D_CONV),
        "conv_C": dense_init(ks[7], (D_CONV, d_state), dtype, fan_in=D_CONV),
        "A_log": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "D": torch.ones((nheads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nheads,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=dev),
        "wo": dense_init(ks[8], (d_inner, d_model), dtype, fan_in=d_inner),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x: [m, b, l, c]; w: [m, D_CONV, c].
    state: [m, b, D_CONV-1, c] trailing context (decode) or None (zeros)."""
    m, b, l, c = x.shape
    if state is None:
        state = x.new_zeros((m, b, D_CONV - 1, c))
    xp = torch.cat([state.to(x.dtype), x], dim=2)
    out = sum(xp[:, :, i:i + l] * w[:, i][:, None, None, :]
              for i in range(D_CONV))
    return F.silu(out)


def _segsum_decay(da_cs: torch.Tensor) -> torch.Tensor:
    """Intra-chunk decay matrix L[q, k] = exp(sum_{j=k+1..q} dA_j) for
    q >= k else 0.  da_cs: [..., Q] inclusive cumsum of dA."""
    diff = da_cs[..., :, None] - da_cs[..., None, :]   # [..., Q, Q]
    q = da_cs.shape[-1]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=da_cs.device))
    return torch.where(tri, torch.exp(diff), 0.0)


def ssd_chunked(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int = DEFAULT_CHUNK,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x:[b,l,h,p] (pre-multiplied by dt), dA:[b,l,h] (= dt*A),
    B,C:[b,l,n]. Returns (y [b,l,h,p], final_state [b,h,n,p])."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    f32 = torch.float32
    xc = x.reshape(b, nc, q, h, p).to(f32)
    dac = dA.to(f32).reshape(b, nc, q, h)
    bc = B.reshape(b, nc, q, n).to(f32)
    cc = C.reshape(b, nc, q, n).to(f32)

    da_cs = torch.cumsum(dac, dim=2)                  # [b,nc,q,h]
    # ---- intra-chunk (dual quadratic form) ----
    L = _segsum_decay(da_cs.permute(0, 1, 3, 2))      # [b,nc,h,q,q]
    cb = torch.einsum("bcqn,bckn->bcqk", cc, bc)      # [b,nc,q,k]
    y_diag = torch.einsum("bchqk,bcqk,bckhp->bcqhp", L, cb, xc)

    # ---- chunk summary states ----
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # [b,nc,q,h]
    s_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bc, decay_to_end,
                           xc)                        # [b,nc,h,n,p]
    da_tot = da_cs[:, :, -1, :]                       # [b,nc,h]

    # ---- inter-chunk recurrence (a loop over chunks) ----
    s_run = (init_state.to(f32) if init_state is not None
             else x.new_zeros((b, h, n, p), dtype=f32))
    befores = []
    for c in range(nc):
        befores.append(s_run)                         # state BEFORE chunk
        s_run = (s_run * torch.exp(da_tot[:, c])[..., None, None]
                 + s_chunk[:, c])
    s_before = torch.stack(befores, dim=1)            # [b,nc,h,n,p]

    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", cc, s_before,
                         torch.exp(da_cs))
    y = (y_diag + y_off).reshape(b, nc * q, h, p)[:, :l]
    return y.to(x.dtype), s_run


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def apply_mamba2(params: Params, x: torch.Tensor, *, head_dim: int = 64,
                 chunk: int = DEFAULT_CHUNK, cache: Params | None = None
                 ) -> tuple[torch.Tensor, Params | None]:
    """x: [m, b, l, d_model]. cache (decode): {"conv_x","conv_B","conv_C":
    [m, b, D_CONV-1, *], "ssm": [m, b, h, n, p]}. Returns (y,
    new_cache|None)."""
    m, b, l, d = x.shape
    d_inner = params["wx"].shape[-1]
    h = d_inner // head_dim
    f32 = torch.float32

    z = mm(x, params["wz"])                            # [m,b,l,di]
    xin = mm(x, params["wx"])
    Braw = mm(x, params["wB"])
    Craw = mm(x, params["wC"])
    dt = _softplus(mm(x.to(f32), params["wdt"].to(f32))
                   + bcast(params["dt_bias"], x))      # [m,b,l,h]
    A = -torch.exp(params["A_log"])                    # [m,h]

    decode = cache is not None and l == 1
    cstate = cache if cache is not None else {}
    xc = _causal_conv(xin, params["conv_x"], cstate.get("conv_x"))
    Bc = _causal_conv(Braw, params["conv_B"], cstate.get("conv_B"))
    Cc = _causal_conv(Craw, params["conv_C"], cstate.get("conv_C"))

    xh = xc.reshape(m, b, l, h, head_dim)
    x_dt = xh.to(f32) * dt[..., None]
    dA = dt * A[:, None, None, :]

    if decode:
        s = cstate["ssm"].to(f32)                      # [m,b,h,n,p]
        da1 = torch.exp(dA[:, :, 0])                   # [m,b,h]
        s_new = s * da1[..., None, None] + torch.einsum(
            "mbn,mbhp->mbhnp", Bc[:, :, 0].to(f32), x_dt[:, :, 0])
        y = torch.einsum("mbn,mbhnp->mbhp", Cc[:, :, 0].to(f32), s_new)
        y = y[:, :, None]                              # [m,b,1,h,p]
        new_cache = {
            "conv_x": torch.cat([cstate["conv_x"][:, :, 1:], xin], dim=2),
            "conv_B": torch.cat([cstate["conv_B"][:, :, 1:], Braw], dim=2),
            "conv_C": torch.cat([cstate["conv_C"][:, :, 1:], Craw], dim=2),
            "ssm": s_new.to(cstate["ssm"].dtype),
        }
    else:
        init = cstate.get("ssm")
        y, s_final = ssd_chunked(
            x_dt.reshape(m * b, l, h, head_dim), dA.reshape(m * b, l, h),
            Bc.reshape(m * b, l, -1), Cc.reshape(m * b, l, -1), chunk=chunk,
            init_state=None if init is None else init.reshape(
                (m * b,) + tuple(init.shape[2:])))
        y = y.reshape(m, b, l, h, head_dim)
        new_cache = None
        if cache is not None:   # chunked prefill into state
            new_cache = {
                "conv_x": torch.cat([cstate["conv_x"], xin],
                                    dim=2)[:, :, -(D_CONV - 1):],
                "conv_B": torch.cat([cstate["conv_B"], Braw],
                                    dim=2)[:, :, -(D_CONV - 1):],
                "conv_C": torch.cat([cstate["conv_C"], Craw],
                                    dim=2)[:, :, -(D_CONV - 1):],
                "ssm": s_final.reshape(init.shape).to(cstate["ssm"].dtype),
            }

    y = y + params["D"][:, None, None, :, None] * xh.to(f32)
    y = y.reshape(m, b, l, d_inner)
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    g = y * F.silu(z.to(f32))
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + 1e-6)
    g = g * bcast(params["norm_scale"].to(f32), g)
    out = mm(g.to(x.dtype), params["wo"])
    return out, new_cache


def init_mamba2_cache(batch: int, d_model: int, d_state: int, *,
                      expand: int = 2, head_dim: int = 64,
                      dtype=torch.float32, m: int = 1,
                      device=None) -> Params:
    d_inner = expand * d_model
    h = d_inner // head_dim
    z = lambda *s: torch.zeros((m, batch) + s, dtype=dtype, device=device)
    return {
        "conv_x": z(D_CONV - 1, d_inner),
        "conv_B": z(D_CONV - 1, d_state),
        "conv_C": z(D_CONV - 1, d_state),
        "ssm": z(h, d_state, head_dim),
    }
