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

With a column group ``tp`` (``sharding.tensor_parallel``) the experts'
weights arrive cut over the model columns, in one of the two ways the
strategy-A rules cut them. **Experts cut** (the count divides mp): each
column computes its slice of the router logits, the ``[g, tg, e]``
logits meet at home, where the softmax, the top-k, the aux loss and the
capacity ranking run as above; each column then gathers the tokens
routed to its own experts into its ``[g, e / mp, cap, d]`` buffer, runs
its SwiGLU and combines its slots, gated, into a partial output, and the
partials are summed at home. **mlp cut** (it does not, ``moe_d_ff``
does): the router is replicated, routing and dispatch run at home, each
column runs the column/row-parallel SwiGLU on its ``moe_d_ff`` slice,
and the buffers' partials are summed at home before the combine.
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
              capacity_factor: float = 1.25, tp=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [m, b, l, d]. Returns (out [m, b, l, d], load-balance loss [m]).
    ``tp``: a column group, the experts' leaves cut (module docstring)."""
    m, b, l, d = x.shape
    out, aux = moe_grouped(params, x.reshape(m, b * l, d), top_k=top_k,
                           capacity_factor=capacity_factor, tp=tp)
    return out.reshape(m, b, l, d), aux


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)``: x [g, t, d], idx
    [g, n] -> [g, n, d]."""
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def _router_logits(xg: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    return torch.einsum("gtd,gde->gte", xg.to(torch.float32),
                        router.to(torch.float32))


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU, batched over groups x experts: buf [g, e,
    cap, d] -> [g, e, cap, d]."""
    hg = torch.einsum("gecd,gedf->gecf", buf, wg)
    hu = torch.einsum("gecd,gedf->gecf", buf, wu)
    return torch.einsum("gecf,gefd->gecd", F.silu(hg) * hu, wd)


def _dispatch(xg: torch.Tensor, src_tok: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """The tokens ``src_tok`` [g, e * cap] gathered into [g, e, cap, d],
    the slots past an expert's tokens (``valid`` [g, e, cap] false)
    zero."""
    g, e, cap = valid.shape
    buf = _gather_rows(xg, src_tok).reshape(g, e, cap, xg.shape[-1])
    return torch.where(valid[..., None], buf,
                       torch.zeros((), dtype=buf.dtype, device=buf.device))


def _combine(out_buf: torch.Tensor, slot: torch.Tensor, keep: torch.Tensor,
             gate_vals: torch.Tensor, tg: int) -> torch.Tensor:
    """Each token's kept slots of ``out_buf`` [g, e, cap, d] (``slot`` and
    ``keep`` [g, tg * k]) gated by ``gate_vals`` [g, tg, k] and summed
    over k in token order -> [g, tg, d]."""
    g, e, cap, d = out_buf.shape
    gathered = _gather_rows(out_buf.reshape(g, e * cap, d), slot)
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    weighted = gathered * gate_vals.reshape(g, -1, 1).to(gathered.dtype)
    return weighted.reshape(g, tg, -1, d).sum(dim=2)


def moe_grouped(params: Params, xg: torch.Tensor, *, top_k: int,
                capacity_factor: float, tp=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route grouped tokens. xg: [g, tg, d] -> ([g, tg, d], aux [g]).
    ``tp``: a column group, the experts' leaves cut (module docstring)."""
    g, tg, d = xg.shape
    k = top_k
    dev = xg.device
    router = params["router"]
    # The strategy-A rules cut the router exactly where they cut the
    # experts' own dim (both "experts").
    experts_cut = isinstance(router, list)
    xs = tp.broadcast(xg) if experts_cut else None

    if experts_cut:                   # each column its experts' logits
        logits = tp.gather([_router_logits(xc, r)
                            for xc, r in zip(xs, router)], dim=-1)
    else:
        logits = _router_logits(xg, router)
    e = logits.shape[-1]
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
    slot = flat_e * cap + safe_rank                           # [g, tk]

    if experts_cut:
        # Experts cut: column c holds experts [lo, lo + el).
        parts = []
        for c, (xc, gv) in enumerate(zip(xs, tp.broadcast(gate_vals))):
            w = [params[n][c] for n in ("wg", "wu", "wd")]
            el = w[0].shape[1]
            lo, cd = c * el, xc.device
            buf = _dispatch(xc, src_tok[:, lo * cap:(lo + el) * cap].to(cd),
                            valid[:, lo:lo + el].to(cd))
            mine = (flat_e >= lo) & (flat_e < lo + el)
            parts.append(_combine(
                _experts(buf, *w), torch.where(mine, slot - lo * cap,
                                               0).to(cd),
                (keep & mine).to(cd), gv, tg))
        out = tp.reduce_sum(parts)
    else:
        buf = _dispatch(xg, src_tok, valid)
        if tp is not None and isinstance(params["wd"], list):
            # moe_d_ff cut: column-parallel wg / wu, row-parallel wd
            out_buf = tp.reduce_sum([
                _experts(bc, *(params[n][c] for n in ("wg", "wu", "wd")))
                for c, bc in enumerate(tp.broadcast(buf))])
        else:
            out_buf = _experts(buf, params["wg"], params["wu"], params["wd"])
        out = _combine(out_buf, slot, keep, gate_vals, tg)
    return out.to(xg.dtype), aux
