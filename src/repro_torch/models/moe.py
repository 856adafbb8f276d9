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

Two context variables change the grouping, as the reference's do:

* ``MOE_GROUPS`` ``(g, hint)``: each client's t tokens route in g
  GShard-style dispatch groups of t/g (capacity and ranking per group;
  the load-balance loss pools a client's tokens over its groups, as the
  reference's mean over ``(0, 1)`` does). ``hint`` is the reference's
  sharding constraint on the grouped tokens, a layout that changes no
  value; it is accepted and not used. Nothing sets it in the reference
  (its docstring says ``launch.build`` does); ``launch.build`` does not
  here either.
* ``MOE_SHARD_MAP`` ``(mesh, data_axes, model_axes)``: the grouping the
  reference's ``shard_map`` MoE computes (``_moe_shard_mapped``), one
  dispatch group a data shard (g the data axes' size), each group's
  load-balance loss its own and the client's the mean of its groups'
  (the reference's ``pmean``). It applies where the reference's does
  (g > 1, g divides t, the model axes divide ``moe_d_ff``), else the
  path above runs. On the cells of ``launch.build``'s train step under
  B2 and B3 each data row holds only its own shard of the batch and
  routes it as the one dispatch group it is, with no variable set: the
  rows are the groups, each row's load-balance loss is its own, the
  client's loss their mean through the step's weighting of the rows,
  and the reference's ``psum`` over the model axes is the column
  group's sum. The variable is set where one program holds more than
  one shard's tokens: ``launch.build``'s rows of a batch the data axis
  does not divide (each routing the whole batch), and the global
  program the cells are held against. Under B the batch is not cut:
  every row routes the whole batch as one group, the global program's
  routing.

A serving step on a mesh (``launch.build`` on a
``launch.mesh.ServeMesh``) runs its batch as blocks, one a data row, and
the reference's serving routes the whole batch as one dispatch group.
``MOE_ROWS`` (a :class:`RowRouting`, which ``launch.build`` sets) keeps
that grouping: the capacity is the whole batch's, and a block's tokens
rank in an expert after every earlier block's, so a block learns, at
each MoE layer, the earlier blocks' per-expert counts (an all-gather of
``[e]`` counts over its data column; no activations move). A row's
buffer holds min(capacity, its tokens) slots an expert, the most of its
own tokens an expert can keep, so the rows of a long prefill together
compute up to their count times the whole batch's expert slots.

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

import contextvars

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from ..launch import hlo_stats
from .layers import Params, dense_init

MOE_GROUPS: contextvars.ContextVar = contextvars.ContextVar(
    "MOE_GROUPS", default=None)
MOE_SHARD_MAP: contextvars.ContextVar = contextvars.ContextVar(
    "MOE_SHARD_MAP", default=None)
MOE_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "MOE_ROWS", default=None)
# The MoE layer a block call runs (``transformer.apply_stage``'s stage
# and layer), which ``RowRouting`` keys its counts by.
MOE_LAYER: contextvars.ContextVar = contextvars.ContextVar(
    "MOE_LAYER", default=None)


class RowRouting:
    """A batch's ``n_blocks`` blocks (in batch order, one a data row)
    routed as one dispatch group a client (module docstring). The rows
    run their steps one after another, each announced by :meth:`enter`;
    a block's ranks read only the blocks before it, so the rows run in
    batch order. ``whole_aux`` (a train step's rows, routed once before
    any row's backward): a block's load-balance loss reads the whole
    batch's top-1 fractions. A MoE layer is known by ``MOE_LAYER``
    (``transformer.apply_stage`` sets it, so a remat'd block's
    recomputation finds its layer)."""

    def __init__(self, n_blocks: int, whole_aux: bool = False):
        self.n_blocks = n_blocks
        self.whole_aux = whole_aux
        self.block = 0
        self._seen: dict = {}   # a MoE layer -> block -> (counts, top-1)

    def enter(self, block: int) -> None:
        """A row serving block ``block`` starts its step."""
        self.block = block

    def __enter__(self) -> "RowRouting":
        """The routing as ``MOE_ROWS`` inside a ``with`` block."""
        self._token = MOE_ROWS.set(self)
        return self

    def __exit__(self, *exc) -> None:
        MOE_ROWS.reset(self._token)

    def route(self, counts: torch.Tensor, top1: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The row's per-expert slot counts and top-1 counts [g, e] at
        one MoE layer -> the earlier blocks' slot counts summed there
        ([g, e] on its device: the row's share of an all-gather of every
        block's counts, recorded when the block first routes the layer)
        and, with ``whole_aux``, the top-1 counts of every block routed
        so far summed in block order (the whole batch's, once every row
        has routed), else None."""
        key = MOE_LAYER.get()
        if key is None:
            raise ValueError("a MoE routed over rows runs inside a stage "
                             "(transformer.apply_stage sets MOE_LAYER)")
        seen = self._seen.setdefault(key, {})
        if self.block not in seen:
            seen[self.block] = (counts, top1)
            sent = counts.numel() * counts.element_size()
            if self.whole_aux:
                sent += top1.numel() * top1.element_size()
            hlo_stats.record("all-gather", sent * self.n_blocks,
                             self.n_blocks, senders=1)
        earlier = [c for blk, (c, _) in sorted(seen.items())
                   if blk < self.block]
        if len(earlier) != self.block:
            raise ValueError("the rows of a MoE routing group run in batch "
                             "order")
        off = torch.zeros_like(counts)
        for c in earlier:
            off = off + c.to(off.device)
        if not self.whole_aux:
            return off, None
        total = torch.zeros_like(top1)
        for blk in sorted(seen):
            total = total + seen[blk][1].to(total.device)
        return off, total


def init_moe(key: torch.Tensor, d_model: int, n_experts: int, d_ff: int,
             dtype) -> Params:
    """A MoE layer's weights from ``key``: the f32 router [d_model, n_experts]
    and each expert's gate, up and down."""
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
    t = b * l
    g, pooled = _grouping(params, t)
    out, aux = moe_grouped(params, x.reshape(m * g, t // g, d), top_k=top_k,
                           capacity_factor=capacity_factor, tp=tp, groups=g,
                           pool_aux=pooled)
    return out.reshape(m, b, l, d), aux


def _moe_d_ff(params: Params) -> int:
    """The experts' full hidden width, also from a column group's view
    (``wg`` a list of slices: cut on the experts or on ``moe_d_ff``)."""
    wg = params["wg"]
    if not isinstance(wg, list):
        return wg.shape[-1]
    router = params["router"]
    e = (sum(r.shape[-1] for r in router) if isinstance(router, list)
         else router.shape[-1])
    return (sum(w.shape[-1] for w in wg) if wg[0].shape[1] == e
            else wg[0].shape[-1])


def _grouping(params: Params, t: int) -> tuple[int, bool]:
    """The dispatch groups a client's t tokens route in, and whether its
    load-balance loss pools its groups (``MOE_GROUPS``) or averages
    their own (``MOE_SHARD_MAP``): (1, True) when neither applies."""
    smap = MOE_SHARD_MAP.get()
    if smap is not None:
        mesh, data_axes, model_axes = smap
        sizes = dict(zip(mesh.axis_names, np.asarray(mesh.devices).shape))
        g = int(np.prod([sizes[a] for a in data_axes])) if data_axes else 1
        msz = int(np.prod([sizes[a] for a in model_axes])) \
            if model_axes else 1
        f = _moe_d_ff(params)
        if g > 1 and t % g == 0 and f % msz == 0:
            return g, False
    grouping = MOE_GROUPS.get()
    if grouping is not None:
        gg, _hint = grouping
        if t % gg == 0 and t // gg > 0:
            return gg, True
    return 1, True


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)``: x [g, t, d], idx
    [g, n] -> [g, n, d]."""
    return x.gather(1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def _router_logits(xg: torch.Tensor, router: torch.Tensor,
                   groups: int = 1) -> torch.Tensor:
    """xg [m * groups, tg, d] against each client's router [m, d, e]."""
    g, tg, d = xg.shape
    x = xg.reshape(-1, groups * tg, d) if groups > 1 else xg
    logits = torch.einsum("gtd,gde->gte", x.to(torch.float32),
                          router.to(torch.float32))
    return logits.reshape(g, tg, -1) if groups > 1 else logits


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """The experts' SwiGLU, batched over groups x experts: buf [m *
    groups, e, cap, d] -> the same shape, each client's groups through
    its own experts (w* [m, e, ...])."""
    g, e, cap, d = buf.shape
    if groups > 1:        # a client's groups side by side in its slots
        buf = buf.reshape(-1, groups, e, cap, d).transpose(1, 2).reshape(
            -1, e, groups * cap, d)
    hg = torch.einsum("gecd,gedf->gecf", buf, wg)
    hu = torch.einsum("gecd,gedf->gecf", buf, wu)
    out = torch.einsum("gecf,gefd->gecd", F.silu(hg) * hu, wd)
    if groups > 1:
        out = out.reshape(-1, e, groups, cap, d).transpose(1, 2).reshape(
            g, e, cap, d)
    return out


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
                capacity_factor: float, tp=None, groups: int = 1,
                pool_aux: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route grouped tokens. xg: [m * groups, tg, d], each client's
    ``groups`` dispatch groups in a row, the params one a client ->
    ([m * groups, tg, d], aux [m]): a client's load-balance loss pools
    its groups' tokens (``pool_aux``) or is the mean of its groups' own.
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
        logits = tp.gather([_router_logits(xc, r, groups)
                            for xc, r in zip(xs, router)], dim=-1)
    else:
        logits = _router_logits(xg, router, groups)
    e = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)                     # [g, tg, e]
    gate_vals, idx = router_top_k(probs, k)                  # [g, tg, k]
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)

    # ---- capacity & ranking (per group) ---------------------------------
    rows = MOE_ROWS.get()
    if rows is not None and groups != 1:
        raise ValueError("a row of one routing group routes one dispatch "
                         "group a client")
    t_all = tg if rows is None else tg * rows.n_blocks
    cap = max(1, int(capacity_factor * k * t_all / e))
    # A buffer's slots an expert: a row's own tokens only, of which an
    # expert takes at most tg.
    width = cap if rows is None else min(cap, tg)
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
    top1 = F.one_hot(idx[..., 0], e).to(torch.float32)       # [g, tg, e]
    # A row's slots of an expert follow the earlier blocks'.
    off, whole = (None, None) if rows is None else rows.route(
        grp_end - grp_start, top1.sum(dim=1))
    keep = (rank if off is None
            else rank + off.gather(1, flat_e)) < cap          # [g, tk]
    safe_rank = torch.where(keep, rank, 0)

    # ---- load-balance loss (Switch): E * sum_e f_e * p_e ---------------
    # A train row of one routing group: f_e the whole batch's, p_e its
    # own tokens' mean (the rows' weighted sum is the batch's loss).
    pool = groups if pool_aux else 1
    me = probs.reshape(-1, pool * tg, e).mean(dim=1)
    ce = (top1.reshape(-1, pool * tg, e).mean(dim=1) if whole is None
          else whole / t_all)
    aux = e * (me * ce).sum(dim=-1)
    if not pool_aux and groups > 1:
        aux = aux.reshape(-1, groups).mean(dim=1)

    # ---- dispatch: batched gather into [g, e, width, d] -----------------
    slots = torch.arange(width, device=dev)[None, None]
    pos = grp_start[:, :, None] + slots
    valid = pos < grp_end[:, :, None]                       # [g, e, width]
    if off is not None:
        valid = valid & (slots + off[:, :, None] < cap)
    pos_flat = torch.clamp(pos.reshape(g, e * width), 0, tk - 1)
    src_tok = order.gather(1, pos_flat) // k                  # token ids
    slot = flat_e * width + safe_rank                         # [g, tk]

    if experts_cut:
        # Experts cut: column c holds experts [lo, lo + el).
        parts = []
        for c, (xc, gv) in enumerate(zip(xs, tp.broadcast(gate_vals))):
            w = [params[n][c] for n in ("wg", "wu", "wd")]
            el = w[0].shape[1]
            lo, cd = c * el, xc.device
            buf = _dispatch(xc,
                            src_tok[:, lo * width:(lo + el) * width].to(cd),
                            valid[:, lo:lo + el].to(cd))
            mine = (flat_e >= lo) & (flat_e < lo + el)
            parts.append(_combine(
                _experts(buf, *w, groups),
                torch.where(mine, slot - lo * width, 0).to(cd),
                (keep & mine).to(cd), gv, tg))
        out = tp.reduce_sum(parts)
    else:
        buf = _dispatch(xg, src_tok, valid)
        if tp is not None and isinstance(params["wd"], list):
            # moe_d_ff cut: column-parallel wg / wu, row-parallel wd
            out_buf = tp.reduce_sum([
                _experts(bc, *(params[n][c] for n in ("wg", "wu", "wd")),
                         groups)
                for c, bc in enumerate(tp.broadcast(buf))])
        else:
            out_buf = _experts(buf, params["wg"], params["wu"], params["wd"],
                               groups)
        out = _combine(out_buf, slot, keep, gate_vals, tg)
    return out.to(xg.dtype), aux
