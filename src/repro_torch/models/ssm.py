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

With a column group ``tp`` (``sharding.tensor_parallel``) and the inner
dim cut over the model columns, the training forward runs
tensor-parallel: B and C (the replicated ``ssm_state`` leaves) are
computed at home and broadcast, each column projects z and x for its
channels, convolves, runs ``ssd_chunked`` over them and gates; the gated
RMSNorm's ``mean(g * g)`` over the whole ``d_inner`` is the columns'
partial sums of squares added at home and broadcast back; and ``wo`` is
row-parallel, its partials summed at home. Where the heads are cut with
the inner dim (a column's ``ssm_inner`` slice is exactly its heads'
slice) each column also projects its heads' dt. Where the model axis
divides the inner dim but not the heads, a column's contiguous channels
``[c * w, (c+1) * w)`` cross head boundaries: the SSD is independent per
channel given its head's dt, A and D (B and C are shared), so each head
is read as sub-heads of width ``gcd(w, head_dim)``, whole within one
column, and every head's dt and dt * A are computed at home from the
replicated ``wdt``, ``dt_bias`` and ``A_log`` and broadcast with ``D``;
each column expands them to its sub-heads (a sum over a head's sub-heads
in the backward, then the columns' sum at home in column order).

A serving row (``launch.build`` on a ``launch.mesh.ServeMesh``) passes
its cache as one copy or slice a column (every leaf a list), laid out by
the reference's ``_cache_specs``: ``conv_x`` cut by channel with the
inner dim, the ``ssm`` state ``[b, h, n_state, p]`` by heads where the
model axis divides them (else every column holds a copy), and
``conv_B`` / ``conv_C`` by channel where the model axis divides
``ssm_state`` (else each column holds a copy). The cached mixer then runs
one decode step's recurrence (or a prompt's chunked scan from the state)
per column over its heads or sub-heads, as the training form does; B
and C's convolutions run at home over their whole state (a cut state's
slices gathered there, and the new state sliced back); every column's
cache is updated in place. A replicated state is read by each column at
its sub-heads, and the columns' new sub-head states are all-gathered, so
every copy takes the whole new state, bitwise alike. With the inner dim
and heads replicated the mixer runs at home and every column's copy
takes the new state.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import prng
from .layers import Params, bcast, dense_init, mm

D_CONV = 4           # depthwise conv width (Mamba2 default)
DEFAULT_CHUNK = 128


def init_mamba2(key: torch.Tensor, d_model: int, d_state: int, *,
                expand: int = 2, head_dim: int = 64,
                dtype=torch.float32) -> Params:
    """A Mamba2 mixer's weights from ``key``: the z, x, B, C and dt
    projections, the three depthwise convs, ``A_log``, ``D``, ``dt_bias``,
    the gated norm's scale and the output projection."""
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
    q >= k else 0.  da_cs: [..., Q] inclusive cumsum of dA.

    The entries above the diagonal are masked to -inf *before* the exp
    (the reference exponentiates every entry, then selects): there diff
    is a positive sum of |dA| that overflows f32 once a chunk's decay
    passes ~88, and the exp's backward then multiplies the masked zero
    gradient by inf, NaN in every gradient (a 128-token chunk of the
    reduced Mamba2 does). The values are the reference's bit for bit."""
    diff = da_cs[..., :, None] - da_cs[..., None, :]   # [..., Q, Q]
    q = da_cs.shape[-1]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=da_cs.device))
    return torch.exp(torch.where(tri, diff, -torch.inf))


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


def _heads_gated(params: Params, x: torch.Tensor, Bc: torch.Tensor,
                 Cc: torch.Tensor, *, head_dim: int, chunk: int,
                 state: Params | None = None, heads=None
                 ) -> tuple[torch.Tensor, Params | None]:
    """The mixer up to its gated norm, over the heads of ``params`` (the
    whole mixer, or one column's heads): ``y * silu(z)`` in f32, [m, b,
    l, d_inner of these heads], and the new state. ``heads``: the (dt,
    dt * A, D) of these (sub-)heads, [m, b, l, h] twice and [m, h], where
    they come from elsewhere (a column whose channels cross heads), else
    from ``params``' own ``wdt``, ``dt_bias``, ``A_log`` and ``D``.
    ``state`` (``conv_x`` and ``ssm`` of these heads) is read as the
    conv's trailing context and the scan's initial state (one recurrence
    step for one token); the new one is returned (None without a state),
    not written."""
    m, b, l, _ = x.shape
    f32 = torch.float32
    z = mm(x, params["wz"])
    xin = mm(x, params["wx"])
    xc = _causal_conv(xin, params["conv_x"],
                      None if state is None else state["conv_x"])
    if heads is None:
        dt, dA = _dt_dA(params, x)
        D = params["D"]
    else:
        dt, dA, D = heads
    h = dt.shape[-1]
    xh = xc.reshape(m, b, l, h, head_dim)
    x_dt = xh.to(f32) * dt[..., None]
    if state is not None and l == 1:
        s_new = state["ssm"].to(f32) * torch.exp(dA[:, :, 0])[
            ..., None, None] + torch.einsum(
            "mbn,mbhp->mbhnp", Bc[:, :, 0].to(f32), x_dt[:, :, 0])
        y = torch.einsum("mbn,mbhnp->mbhp", Cc[:, :, 0].to(f32),
                         s_new)[:, :, None]
    else:
        init = None if state is None else state["ssm"].reshape(
            (m * b,) + tuple(state["ssm"].shape[2:]))
        y, s_new = ssd_chunked(x_dt.reshape(m * b, l, h, head_dim),
                               dA.reshape(m * b, l, h),
                               Bc.reshape(m * b, l, -1),
                               Cc.reshape(m * b, l, -1), chunk=chunk,
                               init_state=init)
        y = y.reshape(m, b, l, h, head_dim)
    new = None if state is None else {
        "conv_x": _conv_state(state["conv_x"], xin),
        "ssm": s_new.reshape(state["ssm"].shape).to(state["ssm"].dtype)}
    y = y + D[:, None, None, :, None] * xh.to(f32)
    return y.reshape(m, b, l, h * head_dim) * F.silu(z.to(f32)), new


def _dt_dA(params: Params, x: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every head of ``params``: dt = softplus(x wdt + dt_bias) and dt *
    A (A = -exp(A_log)), f32 [m, b, l, h] each."""
    f32 = torch.float32
    dt = _softplus(mm(x.to(f32), params["wdt"].to(f32))
                   + bcast(params["dt_bias"], x))
    return dt, dt * -torch.exp(params["A_log"])[:, None, None, :]


def _crossing(params: Params) -> bool:
    """Whether the model axis cuts the inner dim but not the heads."""
    return (isinstance(params["wx"], list)
            and not isinstance(params["A_log"], list))


def _sub_heads(tp, params: Params, x: torch.Tensor, per: list,
               head_dim: int) -> tuple[list, int]:
    """A cut across heads (module docstring): each column's (dt, dt * A,
    D) over its sub-heads, and the sub-head width g. Every head's values
    are computed at home and broadcast; column c holds sub-heads ``[c *
    n, (c+1) * n)`` of the ``h * head_dim / g``, n = w / g."""
    w = per[0]["wx"].shape[-1]
    g = math.gcd(w, head_dim)
    rep, n = head_dim // g, w // g

    def mine(t: torch.Tensor, c: int) -> torch.Tensor:
        sub = t.unsqueeze(-1).expand(t.shape + (rep,))
        return sub.reshape(t.shape[:-1] + (-1,)).narrow(-1, c * n, n)

    dt, dA = _dt_dA(params, x)
    out = []
    for c, (both, D) in enumerate(zip(tp.broadcast(torch.stack([dt, dA])),
                                      tp.broadcast(params["D"]))):
        out.append((mine(both[0], c), mine(both[1], c), mine(D, c)))
    return out, g


def _sub_state(ssm: torch.Tensor, rep: int) -> torch.Tensor:
    """A state [m, b, h, n, p] as its sub-heads [m, b, h * rep, n, p /
    rep], sub-head ``i * rep + k`` channels ``[k * p / rep, (k+1) * p /
    rep)`` of head i."""
    m, b, h, n, p = ssm.shape
    return ssm.reshape(m, b, h, n, rep, p // rep).permute(
        0, 1, 2, 4, 3, 5).reshape(m, b, h * rep, n, p // rep)


def _whole_state(sub: torch.Tensor, rep: int) -> torch.Tensor:
    """The inverse of :func:`_sub_state`."""
    m, b, hs, n, g = sub.shape
    return sub.reshape(m, b, hs // rep, rep, n, g).permute(
        0, 1, 2, 4, 3, 5).reshape(m, b, hs // rep, n, rep * g)


def _conv_state(state: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """The conv's trailing context after ``raw`` [m, b, l, c]: the last
    D_CONV - 1 inputs, in the state's dtype."""
    return torch.cat([state, raw.to(state.dtype)],
                     dim=2)[:, :, -(D_CONV - 1):]


def _conv_at_home(tp, raw: torch.Tensor, w: torch.Tensor,
                  states: list) -> torch.Tensor:
    """B's or C's depthwise conv at home over its whole cached state (the
    columns' channel slices gathered, or column 0's copy); the new state
    sliced back to the columns, or into every copy, in place."""
    cut = states[0].shape[-1] < raw.shape[-1]
    st = tp.gather(states, dim=-1) if cut else states[0]
    out = _causal_conv(raw, w, st)
    new = _conv_state(st, raw)
    for s, n in zip(states, tp.slice(new, -1) if cut else tp.broadcast(new)):
        s.copy_(n)
    return out


def _mamba2_cached_columns(tp, params: Params, x: torch.Tensor,
                           cache: dict, *, head_dim: int, chunk: int
                           ) -> torch.Tensor:
    """The cached mixer over a serving row (module docstring); updates
    every column's cache in place and returns [m, b, l, d_model] at
    home."""
    cols = [{n: t[c] for n, t in cache.items()} for c in range(tp.mp)]
    if not isinstance(params["wx"], list):
        y, new = apply_mamba2(params, x, head_dim=head_dim, chunk=chunk,
                              cache=cols[0])
        for name, t in new.items():
            for col, tc in zip(cols, tp.broadcast(t)):
                col[name].copy_(tc)
        return y
    Bc = _conv_at_home(tp, mm(x, params["wB"]), params["conv_B"],
                       [c["conv_B"] for c in cols])
    Cc = _conv_at_home(tp, mm(x, params["wC"]), params["conv_C"],
                       [c["conv_C"] for c in cols])
    per = [{n: t[c] for n, t in params.items() if isinstance(t, list)}
           for c in range(tp.mp)]
    crossing = _crossing(params)
    heads, hd = (_sub_heads(tp, params, x, per, head_dim) if crossing
                 else ([None] * tp.mp, head_dim))
    rep = head_dim // hd
    gs, subs = [], []
    for c, (p, xc, bc, cc, col, hv) in enumerate(zip(
            per, tp.broadcast(x), tp.broadcast(Bc), tp.broadcast(Cc), cols,
            heads)):
        st = col
        if crossing:          # the column's sub-heads of its state's copy
            n = p["wx"].shape[-1] // hd
            st = {"conv_x": col["conv_x"],
                  "ssm": _sub_state(col["ssm"], rep).narrow(2, c * n, n)}
        g, new = _heads_gated(p, xc, bc, cc, head_dim=hd, chunk=chunk,
                              state=st, heads=hv)
        col["conv_x"].copy_(new["conv_x"])
        if crossing:
            subs.append(new["ssm"])
        else:
            col["ssm"].copy_(new["ssm"])
        gs.append(g)
    if crossing:              # every copy takes the whole new state
        for col, s in zip(cols, tp.all_gather(subs, dim=2)):
            col["ssm"].copy_(_whole_state(s, rep))
    return _gated_out(tp, per, gs, x.dtype)


def _gated_out(tp, per: list, gs: list, dtype) -> torch.Tensor:
    """The gated RMSNorm over the columns' ``g`` (the mean of g * g over
    the whole inner dim from the columns' partial sums) and the
    row-parallel ``wo``, summed at home."""
    f32 = torch.float32
    d_inner = sum(g.shape[-1] for g in gs)
    ms = tp.all_sum([(g * g).sum(dim=-1, keepdim=True) for g in gs])
    outs = []
    for p, g, sq in zip(per, gs, ms):
        g = g * torch.rsqrt(sq / d_inner + 1e-6)
        g = g * bcast(p["norm_scale"].to(f32), g)
        outs.append(mm(g.to(dtype), p["wo"]))
    return tp.reduce_sum(outs)


def _mamba2_columns(tp, params: Params, x: torch.Tensor, *, head_dim: int,
                    chunk: int) -> torch.Tensor:
    """The uncached mixer with its inner dim cut over ``tp``'s columns,
    with its heads or across them (module docstring); returns [m, b, l,
    d_model] at home."""
    Bc = _causal_conv(mm(x, params["wB"]), params["conv_B"])
    Cc = _causal_conv(mm(x, params["wC"]), params["conv_C"])
    per = [{n: t[c] for n, t in params.items() if isinstance(t, list)}
           for c in range(tp.mp)]
    heads, hd = (_sub_heads(tp, params, x, per, head_dim)
                 if _crossing(params) else ([None] * tp.mp, head_dim))
    gs = [_heads_gated(p, xc, bc, cc, head_dim=hd, chunk=chunk,
                       heads=hv)[0]
          for p, xc, bc, cc, hv in zip(per, tp.broadcast(x),
                                       tp.broadcast(Bc), tp.broadcast(Cc),
                                       heads)]
    return _gated_out(tp, per, gs, x.dtype)


def apply_mamba2(params: Params, x: torch.Tensor, *, head_dim: int = 64,
                 chunk: int = DEFAULT_CHUNK, cache: Params | None = None,
                 tp=None) -> tuple[torch.Tensor, Params | None]:
    """x: [m, b, l, d_model]. cache (decode): {"conv_x","conv_B","conv_C":
    [m, b, D_CONV-1, *], "ssm": [m, b, h, n, p]}. ``tp``: a column group,
    the inner dim cut (the uncached training forward), or with
    a cache (a serving row's, a list a leaf) the cached mixer, which
    updates it in place (:func:`_mamba2_cached_columns`). Returns (y,
    new_cache|None)."""
    if tp is not None and cache is not None:
        return _mamba2_cached_columns(tp, params, x, cache,
                                      head_dim=head_dim, chunk=chunk), cache
    if tp is not None and isinstance(params["wx"], list):
        return _mamba2_columns(tp, params, x, head_dim=head_dim,
                               chunk=chunk), None
    f32 = torch.float32
    Braw, Craw = mm(x, params["wB"]), mm(x, params["wC"])
    cstate = cache if cache is not None else {}
    Bc = _causal_conv(Braw, params["conv_B"], cstate.get("conv_B"))
    Cc = _causal_conv(Craw, params["conv_C"], cstate.get("conv_C"))
    g, state = _heads_gated(params, x, Bc, Cc, head_dim=head_dim,
                            chunk=chunk, state=cache)
    new_cache = None if cache is None else {
        **state, "conv_B": _conv_state(cache["conv_B"], Braw),
        "conv_C": _conv_state(cache["conv_C"], Craw)}
    # gated RMSNorm (Mamba2): norm(y * silu(z))
    g = g * torch.rsqrt((g * g).mean(dim=-1, keepdim=True) + 1e-6)
    g = g * bcast(params["norm_scale"].to(f32), g)
    out = mm(g.to(x.dtype), params["wo"])
    return out, new_cache


def init_mamba2_cache(batch: int, d_model: int, d_state: int, *,
                      expand: int = 2, head_dim: int = 64,
                      dtype=torch.float32, m: int = 1,
                      device=None) -> Params:
    """A Mamba2 decode cache of zeros: the three convs' trailing context ``[m,
    batch, D_CONV - 1, *]`` and the SSM state ``[m, batch, heads, d_state,
    head_dim]``."""
    d_inner = expand * d_model
    h = d_inner // head_dim
    z = lambda *s: torch.zeros((m, batch) + s, dtype=dtype, device=device)
    return {
        "conv_x": z(D_CONV - 1, d_inner),
        "conv_B": z(D_CONV - 1, d_state),
        "conv_C": z(D_CONV - 1, d_state),
        "ssm": z(h, d_state, head_dim),
    }
