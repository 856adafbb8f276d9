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
recomputes the forward in the backward and does not change the numbers.
A stage's decode cache is stacked on a leading layer axis: ``[n, m, ...]``
(``kpos`` ``[n, S]``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .. import prng
from ..configs.base import ArchConfig
from .attention import apply_attention, init_attention, init_kv_cache
from .layers import (Params, apply_mlp, apply_norm, dense_init, init_mlp,
                     init_norm, mm, prefixed, sub)
from .moe import apply_moe, init_moe
from .ssm import apply_mamba2, init_mamba2, init_mamba2_cache

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
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
                x_first: torch.Tensor | None = None
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
            cache=cache)

    def norm(name, h):
        return apply_norm(cfg.norm, sub(params, name), h)

    if kind in ("dense", "enc"):
        h, nc = self_attn(sub(params, "attn"), norm("ln1", x), cache,
                          causal=(kind == "dense"))
        x = x + h
        x = x + apply_mlp(cfg.mlp, sub(params, "mlp"), norm("ln2", x))
        return x, nc, zero

    if kind == "moe":
        h, nc = self_attn(sub(params, "attn"), norm("ln1", x), cache)
        x = x + h
        mo, aux = apply_moe(sub(params, "moe"), norm("ln2", x),
                            top_k=cfg.experts_per_token,
                            capacity_factor=cfg.moe_capacity_factor)
        return x + mo, nc, aux

    if kind == "ssm":
        h, nc = apply_mamba2(sub(params, "mixer"), norm("ln", x),
                             head_dim=cfg.ssm_head_dim, cache=cache)
        return x + h, nc, zero

    if kind == "xattn":
        h, _ = apply_attention(
            sub(params, "xattn"), norm("ln1", x), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, qk_norm=cfg.qk_norm, rope_theta=0.0,
            positions=positions, cross_kv=cross_kv)
        x = x + _gate(params["gate_attn"], x) * h
        mo = apply_mlp(cfg.mlp, sub(params, "mlp"), norm("ln2", x))
        x = x + _gate(params["gate_mlp"], x) * mo
        return x, cache, zero   # cache passes through untouched

    if kind == "cross":
        h, nc = self_attn(sub(params, "attn"), norm("ln1", x), cache)
        x = x + h
        hx, _ = apply_attention(
            sub(params, "xattn"), norm("lnx", x), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, qk_norm=cfg.qk_norm, rope_theta=0.0,
            positions=positions, cross_kv=cross_kv)
        x = x + hx
        x = x + apply_mlp(cfg.mlp, sub(params, "mlp"), norm("ln2", x))
        return x, nc, zero

    if kind == "shared":
        h2 = torch.cat([x, x_first], dim=-1)
        a_out, nc = self_attn(sub(params, "attn"), norm("ln1", h2), cache,
                              window=0)
        h2 = h2 + a_out
        h2 = h2 + apply_mlp(cfg.mlp, sub(params, "mlp"), norm("ln2", h2))
        return x + mm(h2, params["down"]), nc, zero

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


def _layer_caches(cache: Params | None, n: int) -> list:
    if cache is None:
        return [None] * n
    parts = {name: t.unbind(0) for name, t in cache.items()}
    return [{name: parts[name][i] for name in parts} for i in range(n)]


def apply_stage(stage_params: Params, x: torch.Tensor, *, cfg: ArchConfig,
                kind: str, n: int, positions: torch.Tensor,
                cache: Params | None = None,
                cross_kv: torch.Tensor | None = None,
                x_first: torch.Tensor | None = None,
                shared_params: Params | None = None
                ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """Run a stage of n identical blocks (leaves [m, n, ...]). cache:
    stacked [n, ...] or None. Returns (x, new_cache_stacked, aux [m])."""
    if kind == "shared":
        return apply_block(shared_params, x, cfg=cfg, kind=kind,
                           positions=positions, cache=cache,
                           cross_kv=cross_kv, x_first=x_first)

    def block(p, h, c):
        return apply_block(p, h, cfg=cfg, kind=kind, positions=positions,
                           cross_kv=cross_kv, x_first=x_first, cache=c)

    layers = {name: t.unbind(1) for name, t in stage_params.items()}
    caches = _layer_caches(cache, n)
    aux = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    new = []
    for i in range(n):
        p = {name: layers[name][i] for name in layers}
        if cfg.remat and cache is None:
            x, nc, a = checkpoint(block, p, x, None, use_reentrant=False)
        else:
            x, nc, a = block(p, x, caches[i])
        aux = aux + a
        new.append(nc)
    if cache is None:
        return x, None, aux
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
