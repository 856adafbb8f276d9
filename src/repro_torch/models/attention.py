"""Attention: GQA/MQA, qk-norm, RoPE, sliding-window, cross-attn, KV cache
— the port of the JAX package's ``models/attention.py``.

The score computation is *streaming*: an online softmax over KV chunks of
``KV_CHUNK`` (a Python loop over the chunks where the reference scans),
queries in blocks of ``Q_CHUNK``, so peak memory is bounded by chunk-sized
buffers instead of an [L, L] score matrix. The math is the reference's,
written with ``torch.einsum``; a fused attention kernel is later work.

Activations carry the client axis m in front (``[m, b, L, ...]``); the
streaming core folds it into the batch (the clients never interact), and
the projections are one batched product over the clients
(``layers.mm``).

With a column group ``tp`` (``sharding.tensor_parallel``) and ``wq`` cut
by heads, attention runs tensor-parallel: each column projects, norms,
rotates and attends over its query heads (the KV heads cut with them,
or, when the model axis does not divide the KV heads, the replicated
``wk``/``wv`` narrowed to the KV heads its query heads read), and ``wo``
is row-parallel, its partials summed at home. Cross-attention projects
the home's encoder states through each column's slice of ``wk``/``wv``.

A serving row (``launch.build`` on a ``launch.mesh.ServeMesh``) passes
its cache as one copy or slice a column (every leaf a list), laid out by
the reference's ``_cache_specs``, and the cached attention runs in that
layout (:func:`_attention_cached_columns`), writing each column's cache
in place:

* **KV heads cut** (the model axis divides the KV heads): each column
  appends to and attends over its own KV heads;
* **head_dim cut** (it does not, it divides head_dim, and the cache is
  over 1 GiB): the new keys and values are computed once at home and
  each column keeps its head_dim slice. For a one-token query with
  ``DECODE_Q_SPEC`` set (``launch.build.build_decode_step`` sets it
  where the reference does: ``P(dp, None, None, None)``, q replicated
  over the columns), every column holds the whole query, scores its
  head_dim slice against its slice of the keys, the partial scores are
  summed across the columns before the online softmax, and each column
  applies its slice of v; the slices of the output meet at home, where
  ``wo`` applies (``wo`` stays as the rules cut it: replicated, at home,
  or by heads, the output then sliced by heads to the columns and their
  partials summed). Otherwise (a prompt; no hint) the slices of the
  keys and values are gathered where the queries are — the layout
  GSPMD falls back to without the hint;
* **replicated** (neither divides, or the cache is small): the new keys
  and values are computed once at home and every column writes them into
  its own copy; each column narrows the whole cache to the KV heads its
  query heads read (or, with ``wq`` replicated, the home attends alone).

KV cache layout (decode), per client and layer:
  {"k": [m, b, S_alloc, KV, hd], "v": same, "kpos": [S_alloc] int32}
``kpos`` stores the absolute position held in each slot (-2^30 = empty),
which uniformly handles full caches (S_alloc = max_seq, slot = pos) and
sliding-window ring buffers (S_alloc = window, slot = pos % window):
masking is always "kpos <= q_pos and q_pos - kpos < window". The clients
decode in step, so one ``kpos`` serves them all.
"""
from __future__ import annotations

import contextvars
import math

import torch
import torch.nn.functional as F

from .. import prng
from ..launch.cost_model import repeats_on_meta
from .layers import Params, apply_rope, dense_init, mm, rms_norm_headdim
from ..sharding.rules import P

DECODE_Q_SPEC: contextvars.ContextVar = contextvars.ContextVar(
    "DECODE_Q_SPEC", default=None)

_EMPTY = -(2 ** 30)
KV_CHUNK = 1024
Q_CHUNK = 1024
_NEG = -1e30


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_attention(key: torch.Tensor, d_model: int, n_heads: int, n_kv: int,
                   head_dim: int, *, qk_norm: bool, dtype,
                   kv_input_dim: int | None = None) -> Params:
    """kv_input_dim: source dim for K/V projections (cross-attn encoder side
    or concat tricks); defaults to d_model."""
    kd = kv_input_dim if kv_input_dim is not None else d_model
    k1, k2, k3, k4 = prng.split(key, 4)
    p = {
        "wq": dense_init(k1, (d_model, n_heads, head_dim), dtype,
                         fan_in=d_model),
        "wk": dense_init(k2, (kd, n_kv, head_dim), dtype, fan_in=kd),
        "wv": dense_init(k3, (kd, n_kv, head_dim), dtype, fan_in=kd),
        "wo": dense_init(k4, (n_heads, head_dim, d_model), dtype,
                         fan_in=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=dtype,
                                 device=key.device)
        p["k_norm"] = torch.ones((head_dim,), dtype=dtype,
                                 device=key.device)
    return p


# ---------------------------------------------------------------------------
# Streaming scaled-dot-product attention
# ---------------------------------------------------------------------------

@repeats_on_meta
def _attend_qchunk(q, k, v, q_pos, k_pos, *, window: int, causal: bool,
                   scale: float, tp=None):
    """q: [B, Lq, KV, rep, hd]; k/v: [B, S, KV, hd]; q_pos: [Lq];
    k_pos: [S]. Returns [B, Lq, KV, rep, hd] (f32). With a column group
    ``tp`` every argument is a list, column c's on its device: the
    query's, keys' and values' head_dim slices of a head_dim-cut cache
    (the whole query replicated, then sliced). Each KV chunk's partial
    scores are then summed across the columns (``ColumnGroup.all_sum``:
    every column the same sum) before the online softmax, which every
    column runs alike on its own slice of v; returns the columns'
    outputs. Counted on ``meta`` once a shape
    (``launch.cost_model.repeats_on_meta``): a prompt's query blocks,
    layers and columns repeat it."""
    cols = tp is not None
    qs, ks, vs, qps, kps = ((q, k, v, q_pos, k_pos) if cols else
                            ([q], [k], [v], [q_pos], [k_pos]))
    b, lq, kvh, rep, _ = qs[0].shape
    s = ks[0].shape[1]
    ck = min(KV_CHUNK, s)
    n_chunks = -(-s // ck)
    pad = n_chunks * ck - s
    if pad:
        ks = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in ks]
        vs = [F.pad(t, (0, 0, 0, 0, 0, pad)) for t in vs]
        kps = [F.pad(t, (0, pad), value=_EMPTY) for t in kps]
    f32 = torch.float32
    qfs = [t.to(f32) for t in qs]
    states = [[torch.full((b, lq, kvh, rep), -math.inf, dtype=f32,
                          device=t.device),
               torch.zeros((b, lq, kvh, rep), dtype=f32, device=t.device),
               torch.zeros(t.shape, dtype=f32, device=t.device)]
              for t in qfs]
    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        parts = [torch.einsum("blgrd,bsgd->blgrs", qf, kt[:, sl].to(f32))
                 for qf, kt in zip(qfs, ks)]
        if cols:
            parts = tp.all_sum(parts)
        for scores, vt, qp, kp, st in zip(parts, vs, qps, kps, states):
            scores = scores * scale
            pch = kp[sl]
            valid = (pch != _EMPTY)[None, :]            # [1, ck]
            if causal:
                valid = valid & (pch[None, :] <= qp[:, None])
            if window > 0:
                valid = valid & (qp[:, None] - pch[None, :] < window)
            # A Python scalar, not a host tensor: no copy to the card
            # (which would wait for it, and which a CUDA graph cannot
            # hold).
            scores = scores.masked_fill(~valid[None, :, None, None, :],
                                        _NEG)
            m, l, acc = st
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            st[1] = l * corr + p.sum(dim=-1)
            st[2] = acc * corr[..., None] + torch.einsum(
                "blgrs,bsgd->blgrd", p, vt[:, sl].to(f32))
            st[0] = m_new
    outs = [acc / torch.clamp(l, min=1e-30)[..., None]
            for _, l, acc in states]
    return outs if cols else outs[0]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_positions: torch.Tensor, k_positions: torch.Tensor, *,
           causal: bool, window: int = 0,
           scale: float | None = None) -> torch.Tensor:
    """q: [B, Lq, H, hd]; k/v: [B, S, KV, hd]. Returns [B, Lq, H, hd]."""
    b, lq, h, hd = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, lq, kvh, rep, hd)
    if lq <= Q_CHUNK:
        out = _attend_qchunk(qg, k, v, q_positions, k_positions,
                             window=window, causal=causal, scale=scale)
        return out.reshape(b, lq, h, hd).to(q.dtype)
    qc = Q_CHUNK
    n_q = -(-lq // qc)
    pad = n_q * qc - lq
    if pad:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
        q_positions = F.pad(q_positions, (0, pad))
    outs = [_attend_qchunk(qg[:, i * qc:(i + 1) * qc], k, v,
                           q_positions[i * qc:(i + 1) * qc], k_positions,
                           window=window, causal=causal, scale=scale)
            for i in range(n_q)]
    out = torch.cat(outs, dim=1).reshape(b, n_q * qc, h, hd)
    return out[:, :lq].to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention layer (projections + rope + cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, s_alloc: int, n_kv: int, head_dim: int,
                  dtype, m: int = 1, device=None) -> Params:
    """Zeroed key and value caches ``[m, batch, s_alloc, n_kv, head_dim]`` and
    the slot positions ``kpos``, on ``device``."""
    return {
        "k": torch.zeros((m, batch, s_alloc, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((m, batch, s_alloc, n_kv, head_dim), dtype=dtype,
                         device=device),
        "kpos": torch.full((s_alloc,), _EMPTY, dtype=torch.int32,
                           device=device),
    }


def _slots(positions: torch.Tensor, s_alloc: int, lq: int,
           device) -> torch.Tensor:
    """The cache slots of ``lq`` new entries at ``positions``: the
    reference's dynamic_update_slice at positions[0] % s_alloc (its start
    clamped so the update fits), as indices on the device (no host read
    of the position)."""
    start = torch.clamp(positions[:1].long() % s_alloc, max=s_alloc - lq)
    return start + torch.arange(lq, device=device)


def _write(cache: Params, k: torch.Tensor, v: torch.Tensor,
           positions: torch.Tensor) -> None:
    """k, v [m, b, lq, kv, hd] and their positions into ``cache`` (one
    column's copy or slice), in place."""
    slots = _slots(positions, cache["k"].shape[2], k.shape[2], k.device)
    cache["k"].index_copy_(2, slots, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, slots, v.to(cache["v"].dtype))
    cache["kpos"].index_copy_(0, slots, positions.to(torch.int32))


def _fold(t: torch.Tensor) -> torch.Tensor:
    """[m, b, ...] -> [m*b, ...]."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


def apply_attention(params: Params, x: torch.Tensor, *, n_heads: int,
                    n_kv: int, qk_norm: bool, rope_theta: float,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, cache: Params | None = None,
                    cross_kv: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None,
                    tp=None) -> tuple[torch.Tensor, Params | None]:
    """x: [m, b, Lq, d_model]; positions: [Lq] absolute positions of x.

    cross_kv: encoder states [m, b, S_enc, kd] for cross-attention.
    tp: a column group; with ``wq`` cut by heads the (uncached) self-
    or cross-attention runs tensor-parallel (:func:`_attention_columns`);
    with a cache (a serving row's, a list a leaf) the cached attention
    runs in the cache's layout and updates it in place
    (:func:`_attention_cached_columns`).
    Returns (out [m, b, Lq, d_model], updated cache or None).
    """
    if tp is not None and cache is not None:
        return _attention_cached_columns(
            tp, params, x, cache, n_heads=n_heads, n_kv=n_kv,
            qk_norm=qk_norm, rope_theta=rope_theta, positions=positions,
            causal=causal, window=window), cache
    if tp is not None and isinstance(params["wq"], list):
        return _attention_columns(
            tp, params, x, n_heads=n_heads, n_kv=n_kv, qk_norm=qk_norm,
            rope_theta=rope_theta, positions=positions, causal=causal,
            window=window, cross_kv=cross_kv,
            kv_positions=kv_positions), None
    m, b, lq, _ = x.shape
    q = mm(x, params["wq"])
    if qk_norm:
        q = rms_norm_headdim(q, params["q_norm"])
    new_cache = None
    if cross_kv is not None:
        k = mm(cross_kv, params["wk"])
        v = mm(cross_kv, params["wv"])
        if qk_norm:
            k = rms_norm_headdim(k, params["k_norm"])
        kp = (kv_positions if kv_positions is not None
              else torch.arange(cross_kv.shape[2], dtype=torch.int32,
                                device=x.device))
        out = attend(_fold(q), _fold(k), _fold(v), positions, kp,
                     causal=False, window=0)
    else:
        k = mm(x, params["wk"])
        v = mm(x, params["wv"])
        if qk_norm:
            k = rms_norm_headdim(k, params["k_norm"])
        if rope_theta > 0:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        if cache is not None:
            slots = _slots(positions, cache["k"].shape[2], lq, x.device)
            ck = cache["k"].index_copy(2, slots, k.to(cache["k"].dtype))
            cv = cache["v"].index_copy(2, slots, v.to(cache["v"].dtype))
            kpos = cache["kpos"].index_copy(0, slots,
                                            positions.to(torch.int32))
            new_cache = {"k": ck, "v": cv, "kpos": kpos}
            out = attend(_fold(q), _fold(ck), _fold(cv), positions, kpos,
                         causal=causal, window=window)
        else:
            out = attend(_fold(q), _fold(k), _fold(v), positions, positions,
                         causal=causal, window=window)
    out = out.reshape(m, b, lq, -1)
    wo = params["wo"]
    y = mm(out, wo.reshape(m, -1, wo.shape[-1]))
    return y, new_cache


def _kv_heads_of(c: int, hc: int, rep: int) -> tuple[int, int, list[int]]:
    """Column c's query heads ``[c*hc, (c+1)*hc)`` read the KV heads
    ``[lo, hi)``; local query head j reads ``lo + idx[j]``."""
    lo, hi = c * hc // rep, ((c + 1) * hc - 1) // rep + 1
    return lo, hi, [(c * hc + j) // rep - lo for j in range(hc)]


def _attention_columns(tp, params: Params, x: torch.Tensor, *, n_heads: int,
                       n_kv: int, qk_norm: bool, rope_theta: float,
                       positions: torch.Tensor, causal: bool,
                       window: int, cross_kv: torch.Tensor | None = None,
                       kv_positions: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Attention with ``wq``/``wo`` cut by heads over ``tp``'s columns
    (``wk``/``wv`` cut with them, or replicated), the replicated leaves
    read from column 0's copies: self-attention, or with ``cross_kv``
    (the home's encoder states) cross-attention as the unsharded path
    runs it (no rotation, no mask but the empty slots); returns [m, b,
    Lq, d_model] at home."""
    m, b, lq, _ = x.shape
    kv_cut = isinstance(params["wk"], list)
    rep = n_heads // n_kv

    def per_column(name):
        return params[name] if isinstance(params[name], list) \
            else tp.broadcast(params[name])

    wk, wv = per_column("wk"), per_column("wv")
    qn = per_column("q_norm") if qk_norm else None
    kn = per_column("k_norm") if qk_norm else None
    xs = tp.broadcast(x)
    srcs = xs if cross_kv is None else tp.broadcast(cross_kv)
    ys = []
    for c, (xc, src) in enumerate(zip(xs, srcs)):
        pos = positions.to(xc.device)
        wq = params["wq"][c]
        hc = wq.shape[2]
        wkc, wvc, idx = wk[c], wv[c], None
        if not kv_cut:
            lo, hi, idx = _kv_heads_of(c, hc, rep)
            wkc, wvc = wkc.narrow(2, lo, hi - lo), wvc.narrow(2, lo, hi - lo)
            if hc % (hi - lo) == 0 and idx == [j // (hc // (hi - lo))
                                               for j in range(hc)]:
                idx = None      # a uniform grouping: attend's own GQA
        q = mm(xc, wq)
        if qk_norm:
            q = rms_norm_headdim(q, qn[c])
        k, v = mm(src, wkc), mm(src, wvc)
        if qk_norm:
            k = rms_norm_headdim(k, kn[c])
        if cross_kv is not None:
            kpos = (kv_positions.to(xc.device) if kv_positions is not None
                    else torch.arange(src.shape[2], dtype=torch.int32,
                                      device=xc.device))
        else:
            kpos = pos
            if rope_theta > 0:
                q = apply_rope(q, pos, rope_theta)
                k = apply_rope(k, pos, rope_theta)
        if idx is not None:     # one KV head a query head
            k = torch.cat([k.narrow(-2, i, 1) for i in idx], dim=-2)
            v = torch.cat([v.narrow(-2, i, 1) for i in idx], dim=-2)
        out = attend(_fold(q), _fold(k), _fold(v), pos, kpos,
                     causal=causal and cross_kv is None,
                     window=window if cross_kv is None else 0
                     ).reshape(m, b, lq, -1)
        wo = params["wo"][c]
        ys.append(mm(out, wo.reshape(m, -1, wo.shape[-1])))
    return tp.reduce_sum(ys)


def _q_spec_replicates(lq: int) -> bool:
    """Whether ``DECODE_Q_SPEC`` asks for a replicated query: set, a
    one-token query (the reference constrains only those), and its heads
    and head_dim dims replicated — the only hint the port's head_dim
    layout takes."""
    spec = DECODE_Q_SPEC.get()
    if spec is None or lq != 1:
        return False
    if not isinstance(spec, P) or spec.names(2) or spec.names(3):
        raise ValueError(f"DECODE_Q_SPEC {spec!r}: the port replicates the "
                         "decode query over the columns or leaves it as "
                         "its projection cuts it")
    return True


def _attention_cached_columns(tp, params: Params, x: torch.Tensor,
                              cache: dict, *, n_heads: int, n_kv: int,
                              qk_norm: bool, rope_theta: float,
                              positions: torch.Tensor, causal: bool,
                              window: int) -> torch.Tensor:
    """Cached self-attention over a serving row: ``cache`` one copy or
    slice a column (each leaf a list), in the layout its shapes show
    (KV heads cut, head_dim cut, or replicated: module docstring), the
    projections as the rules cut them (``wq``/``wo`` by heads or
    replicated, ``wk``/``wv`` with the KV heads or replicated). Writes
    the new keys and values into every column's cache in place; returns
    [m, b, Lq, d_model] at home."""
    m, b, lq, d = x.shape
    mp = tp.mp
    cols = [{n: t[c] for n, t in cache.items()} for c in range(mp)]
    wq_cut = isinstance(params["wq"], list)
    hd = (params["wq"][0] if wq_cut else params["wq"]).shape[-1]
    kv_cut = cols[0]["k"].shape[-2] < n_kv
    hd_cut = not kv_cut and cols[0]["k"].shape[-1] < hd
    rep = n_heads // n_kv
    rope = rope_theta > 0
    poss = [positions.to(dv) for dv in tp.devices]

    def per_column(name):
        return params[name] if isinstance(params[name], list) \
            else tp.broadcast(params[name])

    qn = per_column("q_norm") if qk_norm and (kv_cut or wq_cut) else None
    xs = tp.broadcast(x) if kv_cut or wq_cut else None

    def query(c, xc, wq):
        q = mm(xc, wq)
        if qk_norm:
            q = rms_norm_headdim(q, qn[c] if qn is not None
                                 else params["q_norm"])
        return apply_rope(q, poss[c], rope_theta) if rope else q

    def keys(xc, wk, wv, kn, pos):
        k, v = mm(xc, wk), mm(xc, wv)
        if qk_norm:
            k = rms_norm_headdim(k, kn)
        return (apply_rope(k, pos, rope_theta) if rope else k), v

    def out_proj(out, wo):
        return mm(out.reshape(m, b, lq, -1), wo.reshape(m, -1, d))

    if kv_cut:                  # each column its own KV heads
        kn = per_column("k_norm") if qk_norm else [None] * mp
        ys = []
        for c, col in enumerate(cols):
            q = query(c, xs[c], params["wq"][c])
            k, v = keys(xs[c], params["wk"][c], params["wv"][c], kn[c],
                        poss[c])
            _write(col, k, v, poss[c])
            out = attend(_fold(q), _fold(col["k"]), _fold(col["v"]),
                         poss[c], col["kpos"], causal=causal, window=window)
            ys.append(out_proj(out, params["wo"][c]))
        return tp.reduce_sum(ys)

    # wk / wv replicated: the new keys and values once, at home; each
    # column keeps its head_dim slice of them, or its own copy.
    k, v = keys(x, params["wk"], params["wv"],
                params.get("k_norm"), positions)
    ks, vs = ((tp.slice(k, -1), tp.slice(v, -1)) if hd_cut
              else (tp.broadcast(k), tp.broadcast(v)))
    for col, kc, vc, pos in zip(cols, ks, vs, poss):
        _write(col, kc, vc, pos)

    if hd_cut and _q_spec_replicates(lq):
        # q replicated over the columns; the partial scores summed.
        if wq_cut:
            qs = tp.all_gather([query(c, xs[c], params["wq"][c])
                                for c in range(mp)], dim=-2)
        else:
            qs = tp.broadcast(query(0, x, params["wq"]))
        w = cols[0]["k"].shape[-1]
        outs = _attend_qchunk(
            [_fold(q).narrow(-1, c * w, w).reshape(m * b, lq, n_kv, rep, w)
             for c, q in enumerate(qs)],
            [_fold(col["k"]) for col in cols],
            [_fold(col["v"]) for col in cols], poss,
            [col["kpos"] for col in cols], causal=causal, window=window,
            scale=1.0 / math.sqrt(hd), tp=tp)
        out = tp.gather([o.to(x.dtype) for o in outs], dim=-1).reshape(
            m, b, lq, n_heads, hd)
        if not wq_cut:
            return out_proj(out, params["wo"])
        return tp.reduce_sum([out_proj(o, wo) for o, wo in zip(
            tp.slice(out, -2), params["wo"])])

    # The keys and values whole where the queries are: a head_dim-cut
    # cache's slices gathered, or each column's own copy.
    def whole(name):
        parts = [col[name] for col in cols]
        if not hd_cut:
            return parts
        if wq_cut:
            return tp.all_gather(parts, dim=-1)
        return [tp.gather(parts, dim=-1)]

    gk, gv = whole("k"), whole("v")
    if not wq_cut:              # the home attends alone
        out = attend(_fold(query(0, x, params["wq"])), _fold(gk[0]),
                     _fold(gv[0]), positions, cols[0]["kpos"],
                     causal=causal, window=window)
        return out_proj(out, params["wo"])
    ys = []
    for c, col in enumerate(cols):
        wq = params["wq"][c]
        hc = wq.shape[2]
        lo, hi, idx = _kv_heads_of(c, hc, rep)
        kc, vc = gk[c].narrow(-2, lo, hi - lo), gv[c].narrow(-2, lo, hi - lo)
        if not (hc % (hi - lo) == 0
                and idx == [j // (hc // (hi - lo)) for j in range(hc)]):
            kc = torch.cat([kc.narrow(-2, i, 1) for i in idx], dim=-2)
            vc = torch.cat([vc.narrow(-2, i, 1) for i in idx], dim=-2)
        out = attend(_fold(query(c, xs[c], wq)), _fold(kc), _fold(vc),
                     poss[c], col["kpos"], causal=causal, window=window)
        ys.append(out_proj(out, params["wo"][c]))
    return tp.reduce_sum(ys)
