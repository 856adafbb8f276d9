"""Mixture-of-Experts FFN: top-k router + capacity-bounded expert dispatch
— the port of the JAX package's ``models/moe.py`` (``_moe_grouped``).

Dispatch is sort-based (dropless up to a capacity factor) and
**gather-only**: tokens are ranked within their expert by a stable
argsort and *gathered* into an ``[g, E, capacity, d]`` buffer; the combine
gathers each token's slots back and sums them. The group axis g is the
client axis: every client routes its own tokens against its own experts,
which is what the reference's ``vmap`` over clients of one group does.

Tie rule: ``jax.lax.top_k`` breaks ties towards the lower expert index;
here a stable descending sort of the router probabilities does the same
on the CPU and the card (``torch.topk`` promises no order among ties).

The reference's ``MOE_GROUPS`` (GShard-style dispatch groups) and
``MOE_SHARD_MAP`` (the shard_map MoE) are mesh layouts set by
``launch/build.py`` (ROADMAP A17); one card runs the one-group path.

Load-balance auxiliary loss: Switch-style ``E * sum_e f_e * p_e``, one a
client.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng
from .layers import Params, dense_init


def init_moe(key: torch.Tensor, d_model: int, n_experts: int, d_ff: int,
             dtype) -> Params:
    k1, k2, k3, k4 = prng.split(key, 4)
    return {
        "router": dense_init(k1, (d_model, n_experts), torch.float32),
        "wg": dense_init(k2, (n_experts, d_model, d_ff), dtype,
                         fan_in=d_model),
        "wu": dense_init(k3, (n_experts, d_model, d_ff), dtype,
                         fan_in=d_model),
        "wd": dense_init(k4, (n_experts, d_ff, d_model), dtype, fan_in=d_ff),
    }


def router_top_k(probs: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(params: Params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [m, b, l, d]. Returns (out [m, b, l, d], load-balance loss [m])."""
    m, b, l, d = x.shape
    out, aux = moe_grouped(params, x.reshape(m, b * l, d), top_k=top_k,
                           capacity_factor=capacity_factor)
    return out.reshape(m, b, l, d), aux


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)``: x [g, t, d], idx
    [g, n] -> [g, n, d]."""
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def moe_grouped(params: Params, xg: torch.Tensor, *, top_k: int,
                capacity_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Route grouped tokens. xg: [g, tg, d] -> ([g, tg, d], aux [g])."""
    g, tg, d = xg.shape
    e = params["router"].shape[-1]
    k = top_k
    dev = xg.device

    logits = torch.einsum("gtd,gde->gte", xg.to(torch.float32),
                          params["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)                     # [g, tg, e]
    gate_vals, idx = router_top_k(probs, k)                  # [g, tg, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # ---- load-balance loss (Switch): E * sum_e f_e * p_e ---------------
    me = probs.mean(dim=1)                                    # [g, e]
    ce = F.one_hot(idx[..., 0], e).to(torch.float32).mean(dim=1)
    aux = e * (me * ce).sum(dim=-1)

    # ---- capacity & ranking (per group) ---------------------------------
    cap = max(1, int(capacity_factor * k * tg / e))
    tk = tg * k
    flat_e = idx.reshape(g, tk)                               # [g, tk]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    erange = torch.arange(e, device=dev).expand(g, e).contiguous()
    grp_start = torch.searchsorted(sorted_e, erange, side="left")
    grp_end = torch.searchsorted(sorted_e, erange, side="right")
    rank_sorted = (torch.arange(tk, device=dev)[None, :]
                   - grp_start.gather(1, sorted_e))
    inv = torch.argsort(order, dim=-1, stable=True)
    rank = rank_sorted.gather(1, inv)
    keep = rank < cap                                         # [g, tk]
    safe_rank = torch.where(keep, rank, 0)

    # ---- dispatch: batched gather into [g, e, cap, d] -------------------
    pos = grp_start[:, :, None] + torch.arange(cap, device=dev)[None, None]
    valid = pos < grp_end[:, :, None]                         # [g, e, cap]
    pos_flat = torch.clamp(pos.reshape(g, e * cap), 0, tk - 1)
    src_tok = order.gather(1, pos_flat) // k                  # token ids
    buf = _gather_rows(xg, src_tok).reshape(g, e, cap, d)
    buf = torch.where(valid[..., None], buf,
                      torch.zeros((), dtype=buf.dtype, device=dev))

    # ---- expert FFN (batched over groups x experts; SwiGLU) -------------
    hg = torch.einsum("gecd,gedf->gecf", buf, params["wg"])
    hu = torch.einsum("gecd,gedf->gecf", buf, params["wu"])
    hidden = F.silu(hg) * hu
    out_buf = torch.einsum("gecf,gefd->gecd", hidden, params["wd"])

    # ---- combine: batched gather; token-ordered reshape+sum -------------
    slot = flat_e * cap + safe_rank                           # [g, tk]
    gathered = _gather_rows(out_buf.reshape(g, e * cap, d), slot)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=dev))
    weighted = gathered * gate_vals.reshape(g, tk, 1).to(gathered.dtype)
    out = weighted.reshape(g, tg, k, d).sum(dim=2)
    return out.to(xg.dtype), aux
