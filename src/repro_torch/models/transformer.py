"""Transformer block zoo + stages, the port of the JAX package's
``models/transformer.py``.

Block kinds (cfg.block_pattern()):
  dense  — self-attn + MLP                       (llama/olmo/gemma/qwen...)
  moe    — self-attn + MoE FFN                   (mixtral, qwen3-moe)
  ssm    — Mamba2 mixer block                    (mamba2)
  shared — zamba2 shared attn block over concat(h, h0); weights shared
           across all its occurrences, each occurrence has its OWN cache
  xattn  — gated cross-attn + MLP                (llama-3.2-vision layers)
  cross  — self-attn + cross-attn + MLP          (whisper decoder)
  enc    — non-causal self-attn + MLP            (whisper encoder)

Layers of one *stage* (a run of identical kinds) are stacked on a
"layers" axis, right after the client axis: a stage leaf is ``[m, n,
...]`` (``[n, ...]`` before the clients are stacked). ``apply_stage``
loops over the layers where the reference runs ``lax.scan``; it unbinds
each leaf once, so the backward stacks the layers' gradients in one
allocation. ``cfg.remat`` wraps a block in
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``, which
recomputes the forward in the backward, in the forward's context
variables, and does not change the numbers.
A stage's decode cache is stacked on a leading layer axis: ``[n, m, ...]``
(``kpos`` ``[n, S]``).

A column group ``tp`` (``sharding.tensor_parallel``) reaches every
block's attention (self and cross), MLP, MoE and Mamba2 mixer, whose cut
leaves are lists of column slices (a stage leaf's slices each carry the
layer axis), and the shared block's ``down``, row-parallel over
``concat(x, x_first)`` sliced across the columns; norms, residuals and
the gates run once, at home. A mesh row's view may hold weights cut
over the data axis (``sharding.tensor_parallel.DataCut``): each layer's
are gathered just before it runs and dropped after it (inside a remat'd
block, so its backward gathers them again), and its cache (a
list a leaf, one copy or slice a column) is updated in place by its
attention or mixer, so a stage returns the cache it was given.
"""
from __future__ import annotations

import contextvars

import torch
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..configs.base import ArchConfig
from .attention import apply_attention, init_attention, init_kv_cache
from .layers import (Params, apply_mlp, apply_norm, dense_init, init_mlp,
                     init_norm, mm_rows, prefixed, sub)
from .moe import MOE_LAYER, apply_moe, init_moe
from .ssm import apply_mamba2, init_mamba2, init_mamba2_cache
from ..sharding.tensor_parallel import gather_data

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"float32"``,
    ``"bfloat16"``)."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Per-kind block init
# ---------------------------------------------------------------------------

def init_block(key: torch.Tensor, cfg: ArchConfig, kind: str) -> Params:
    """One block's flat leaves (no client or layer axis), drawn from
    ``split(key, 6)`` as the reference's ``init_block``."""
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    ks = prng.split(key, 6)
    dev = key.device

    def attn(k, d_model, kv_dim=None):
        return init_attention(k, d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, qk_norm=cfg.qk_norm, dtype=dtype,
                              kv_input_dim=kv_dim)

    def norm(width):
        return {n: t.to(dev) for n, t in
                init_norm(cfg.norm, width, dtype).items()}

    if kind in ("dense", "enc"):
        return {**prefixed("ln1", norm(d)), **prefixed("attn", attn(ks[0], d)),
                **prefixed("ln2", norm(d)),
                **prefixed("mlp", init_mlp(ks[1], d, cfg.d_ff, cfg.mlp,
                                           dtype))}
    if kind == "moe":
        return {**prefixed("ln1", norm(d)), **prefixed("attn", attn(ks[0], d)),
                **prefixed("ln2", norm(d)),
                **prefixed("moe", init_moe(ks[1], d, cfg.n_experts,
                                           cfg.moe_d_ff, dtype))}
    if kind == "ssm":
        return {**prefixed("ln", norm(d)),
                **prefixed("mixer", init_mamba2(
                    ks[0], d, cfg.ssm_state, expand=cfg.ssm_expand,
                    head_dim=cfg.ssm_head_dim, dtype=dtype))}
    if kind == "xattn":
        return {**prefixed("ln1", norm(d)),
                **prefixed("xattn", attn(ks[0], d, kv_dim=d)),
                **prefixed("ln2", norm(d)),
                **prefixed("mlp", init_mlp(ks[1], d, cfg.d_ff, cfg.mlp,
                                           dtype)),
                "gate_attn": torch.zeros((1,), dtype=dtype, device=dev),
                "gate_mlp": torch.zeros((1,), dtype=dtype, device=dev)}
    if kind == "cross":
        return {**prefixed("ln1", norm(d)), **prefixed("attn", attn(ks[0], d)),
                **prefixed("lnx", norm(d)),
                **prefixed("xattn", attn(ks[1], d, kv_dim=d)),
                **prefixed("ln2", norm(d)),
                **prefixed("mlp", init_mlp(ks[2], d, cfg.d_ff, cfg.mlp,
                                           dtype))}
    if kind == "shared":
        d2 = 2 * d
        return {**prefixed("ln1", norm(d2)),
                **prefixed("attn", attn(ks[0], d2)),
                **prefixed("ln2", norm(d2)),
                **prefixed("mlp", init_mlp(ks[1], d2, cfg.d_ff, cfg.mlp,
                                           dtype)),
                "down": dense_init(ks[2], (d2, d), dtype, fan_in=d2)}
    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------------------
# Per-kind block apply
# ---------------------------------------------------------------------------

def _gate(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """tanh of a per-client gate [m, 1], in x's dtype, shaped for x."""
    t = torch.tanh(g.to(torch.float32)).to(x.dtype)
    return t.reshape((t.shape[0],) + (1,) * (x.dim() - 1))


def apply_block(params: Params, x: torch.Tensor, *, cfg: ArchConfig,
                kind: str, positions: torch.Tensor,
                cache: Params | None = None,
                cross_kv: torch.Tensor | None = None,
                x_first: torch.Tensor | None = None, tp=None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """x [m, b, l, d]. Returns (x_out, new_cache, aux_loss [m])."""
    rope = cfg.rope_theta if cfg.pos == "rope" else 0.0
    zero = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)

    def self_attn(p, h, cache, causal=True, window=None):
        return apply_attention(
            p, h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            qk_norm=cfg.qk_norm, rope_theta=rope, positions=positions,
            causal=causal,
            window=cfg.sliding_window if window is None else window,
            cache=cache, tp=tp)

    def norm(name, h):
        return apply_norm(cfg.norm, sub(params, name), h)

    def cross_attn(h):
        return apply_attention(
            sub(params, "xattn"), h, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, qk_norm=cfg.qk_norm, rope_theta=0.0,
            positions=positions, cross_kv=cross_kv, tp=tp)[0]

    def mlp(h):
        return apply_mlp(cfg.mlp, sub(params, "mlp"), h, tp=tp)

    if kind in ("dense", "enc"):
        h, nc = self_attn(sub(params, "attn"), norm("ln1", x), cache,
                          causal=(kind == "dense"))
        x = x + h
        x = x + mlp(norm("ln2", x))
        return x, nc, zero

    if kind == "moe":
        h, nc = self_attn(sub(params, "attn"), norm("ln1", x), cache)
        x = x + h
        mo, aux = apply_moe(sub(params, "moe"), norm("ln2", x),
                            top_k=cfg.experts_per_token,
                            capacity_factor=cfg.moe_capacity_factor, tp=tp)
        return x + mo, nc, aux

    if kind == "ssm":
        h, nc = apply_mamba2(sub(params, "mixer"), norm("ln", x),
                             head_dim=cfg.ssm_head_dim, cache=cache, tp=tp)
        return x + h, nc, zero

    if kind == "xattn":
        x = x + _gate(params["gate_attn"], x) * cross_attn(norm("ln1", x))
        x = x + _gate(params["gate_mlp"], x) * mlp(norm("ln2", x))
        return x, cache, zero   # cache passes through untouched

    if kind == "cross":
        h, nc = self_attn(sub(params, "attn"), norm("ln1", x), cache)
        x = x + h
        x = x + cross_attn(norm("lnx", x))
        x = x + mlp(norm("ln2", x))
        return x, nc, zero

    if kind == "shared":
        h2 = torch.cat([x, x_first], dim=-1)
        a_out, nc = self_attn(sub(params, "attn"), norm("ln1", h2), cache,
                              window=0)
        h2 = h2 + a_out
        h2 = h2 + mlp(norm("ln2", h2))
        return x + mm_rows(tp, h2, params["down"]), nc, zero

    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Stages (a loop over stacked layers)
# ---------------------------------------------------------------------------

def init_stage(key: torch.Tensor, cfg: ArchConfig, kind: str, n: int
               ) -> Params:
    """n blocks stacked on a leading layer axis, layer i drawn from
    ``split(key, n)[i]`` (the reference's ``vmap`` over those keys)."""
    if kind == "shared":     # params live at model level; stage is empty
        return {}
    blocks = [init_block(k, cfg, kind) for k in prng.split(key, n)]
    return {name: torch.stack([b[name] for b in blocks])
            for name in blocks[0]}


def _layers_of(t) -> list:
    """A stage leaf [m, n, ...] as its n layers; a cut leaf's column
    slices as one list of slices a layer."""
    if isinstance(t, list):
        return [list(layer) for layer in zip(*(p.unbind(1) for p in t))]
    return t.unbind(1)


def _layer_caches(cache: Params | None, n: int) -> list:
    """A stage cache [n, ...] as its n layers' caches (views); a serving
    row's list-valued leaves as one list of column views a layer."""
    if cache is None:
        return [None] * n
    parts = {name: [list(layer) for layer in zip(*(c.unbind(0)
                                                   for c in t))]
             if isinstance(t, list) else t.unbind(0)
             for name, t in cache.items()}
    return [{name: parts[name][i] for name in parts} for i in range(n)]


def apply_stage(stage_params: Params, x: torch.Tensor, *, cfg: ArchConfig,
                kind: str, n: int, positions: torch.Tensor,
                cache: Params | None = None,
                cross_kv: torch.Tensor | None = None,
                x_first: torch.Tensor | None = None,
                shared_params: Params | None = None, tp=None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Run a stage of n identical blocks (leaves [m, n, ...]). cache:
    stacked [n, ...] or None. Returns (x, new_cache_stacked, aux [m]);
    with ``tp`` and a cache, the cache given, updated in place."""
    if kind == "shared":
        if tp is not None:
            shared_params = {k: gather_data(t)
                             for k, t in shared_params.items()}
        return apply_block(shared_params, x, cfg=cfg, kind=kind,
                           positions=positions, cache=cache,
                           cross_kv=cross_kv, x_first=x_first, tp=tp)

    def block(p, h, c):
        return apply_block(p, h, cfg=cfg, kind=kind, positions=positions,
                           cross_kv=cross_kv, x_first=x_first, cache=c,
                           tp=tp)

    def gathered(p, h, c):
        # A data-cut layer's weights gathered inside the (recomputed)
        # block: the backward of a remat'd block gathers them again
        # rather than keeping them from the forward.
        if tp is not None:
            p = {name: gather_data(t) for name, t in p.items()}
        return block(p, h, c)

    layers = {name: _layers_of(t) for name, t in stage_params.items()}
    caches = _layer_caches(cache, n)
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    new = []
    stage = MOE_LAYER.get() or ()
    for i in range(n):
        p = {name: layers[name][i] for name in layers}
        # The layer a MoE's row routing keys its counts by.
        layer = MOE_LAYER.set(stage + (i,))
        try:
            if cfg.remat and cache is None:
                # The backward may recompute the block on autograd's
                # device thread, which does not see this one's context
                # variables (the MoE's grouping and layer): it recomputes
                # in this layer's forward's (bound now, not the loop's
                # last).
                ctx = contextvars.copy_context()
                x, nc, a = checkpoint(
                    lambda *args, ctx=ctx: ctx.run(gathered, *args), p, x,
                    None, use_reentrant=False)
            else:
                x, nc, a = gathered(p, x, caches[i])
        finally:
            MOE_LAYER.reset(layer)
        aux = aux + a
        new.append(nc)
    if cache is None:
        return x, None, aux
    if tp is not None:
        return x, cache, aux
    return x, {name: torch.stack([c[name] for c in new])
               for name in new[0]}, aux


def init_stage_cache(cfg: ArchConfig, kind: str, n: int, batch: int,
                     s_alloc: int, dtype, m: int = 1,
                     device=None) -> Params | None:
    """Stacked decode cache for one stage ([n, ...] leaves; a shared
    block's occurrence holds one)."""
    if kind == "ssm":
        one = init_mamba2_cache(batch, cfg.d_model, cfg.ssm_state,
                                expand=cfg.ssm_expand,
                                head_dim=cfg.ssm_head_dim, dtype=dtype, m=m,
                                device=device)
    elif kind in ("dense", "moe", "cross", "shared"):
        s = s_alloc
        if cfg.sliding_window and kind != "shared":
            s = min(s, cfg.sliding_window)
        one = init_kv_cache(batch, s, cfg.n_kv_heads, cfg.head_dim, dtype,
                            m=m, device=device)
    elif kind in ("xattn", "enc"):
        return None
    else:
        raise ValueError(kind)
    if kind == "shared":
        return one
    return {name: t.unsqueeze(0).expand((n,) + tuple(t.shape)).clone()
            for name, t in one.items()}
