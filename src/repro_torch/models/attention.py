"""Attention: GQA/MQA, qk-norm, RoPE, sliding-window, cross-attn, KV cache
— the port of the JAX package's ``models/attention.py``.

The score computation is *streaming*: an online softmax over KV chunks of
``KV_CHUNK`` (a Python loop over the chunks where the reference scans),
queries in blocks of ``Q_CHUNK``, so peak memory is bounded by chunk-sized
buffers instead of an [L, L] score matrix. The math is the reference's,
written with ``torch.einsum``; a fused attention kernel is later work.
The reference's ``DECODE_Q_SPEC`` is a sharding hint for a head_dim-
sharded cache on a mesh (ROADMAP A17): one card has no mesh, so it has
no counterpart here.

Activations carry the client axis m in front (``[m, b, L, ...]``); the
streaming core folds it into the batch (the clients never interact), and
the projections are one batched product over the clients
(``layers.mm``).

KV cache layout (decode), per client and layer:
  {"k": [m, b, S_alloc, KV, hd], "v": same, "kpos": [S_alloc] int32}
``kpos`` stores the absolute position held in each slot (-2^30 = empty),
which uniformly handles full caches (S_alloc = max_seq, slot = pos) and
sliding-window ring buffers (S_alloc = window, slot = pos % window):
masking is always "kpos <= q_pos and q_pos - kpos < window". The clients
decode in step, so one ``kpos`` serves them all.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import prng
from .layers import Params, apply_rope, dense_init, mm, rms_norm_headdim

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

def _attend_qchunk(q, k, v, q_pos, k_pos, *, window: int, causal: bool,
                   scale: float) -> torch.Tensor:
    """q: [B, Lq, KV, rep, hd]; k/v: [B, S, KV, hd]; q_pos: [Lq];
    k_pos: [S]. Returns [B, Lq, KV, rep, hd] (f32)."""
    b, lq, kvh, rep, hd = q.shape
    s = k.shape[1]
    ck = min(KV_CHUNK, s)
    n_chunks = -(-s // ck)
    pad = n_chunks * ck - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=_EMPTY)
    qf = q.to(torch.float32)
    m = torch.full((b, lq, kvh, rep), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, lq, kvh, rep), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, lq, kvh, rep, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        kch = k[:, c * ck:(c + 1) * ck].to(torch.float32)
        vch = v[:, c * ck:(c + 1) * ck].to(torch.float32)
        pch = k_pos[c * ck:(c + 1) * ck]
        scores = torch.einsum("blgrd,bsgd->blgrs", qf, kch) * scale
        valid = (pch != _EMPTY)[None, :]                # [1, ck]
        if causal:
            valid = valid & (pch[None, :] <= q_pos[:, None])
        if window > 0:
            valid = valid & (q_pos[:, None] - pch[None, :] < window)
        # A Python scalar, not a host tensor: no copy to the card (which
        # would wait for it, and which a CUDA graph cannot hold).
        scores = scores.masked_fill(~valid[None, :, None, None, :], _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("blgrs,bsgd->blgrd", p,
                                                   vch)
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l[..., None]


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
    return {
        "k": torch.zeros((m, batch, s_alloc, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((m, batch, s_alloc, n_kv, head_dim), dtype=dtype,
                         device=device),
        "kpos": torch.full((s_alloc,), _EMPTY, dtype=torch.int32,
                           device=device),
    }


def _fold(t: torch.Tensor) -> torch.Tensor:
    """[m, b, ...] -> [m*b, ...]."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


def apply_attention(params: Params, x: torch.Tensor, *, n_heads: int,
                    n_kv: int, qk_norm: bool, rope_theta: float,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, cache: Params | None = None,
                    cross_kv: torch.Tensor | None = None,
                    kv_positions: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, Params | None]:
    """x: [m, b, Lq, d_model]; positions: [Lq] absolute positions of x.

    cross_kv: encoder states [m, b, S_enc, kd] for cross-attention.
    Returns (out [m, b, Lq, d_model], updated cache or None).
    """
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
            s_alloc = cache["k"].shape[2]
            # The reference's dynamic_update_slice at positions[0] %
            # s_alloc (its start clamped so the update fits), as an
            # index copy on the device (no host read of the position).
            start = torch.clamp(positions[:1].long() % s_alloc,
                                max=s_alloc - lq)
            slots = start + torch.arange(lq, device=x.device)
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
