"""Model wrappers: decoder LM, encoder-decoder (whisper), VLM (llama-3.2-v)
— the port of the JAX package's ``models/model.py``.

Public functional API (everything is (params, cfg)-explicit):

  init_model(key, cfg, device=None)       -> params (flat dict)
  forward(params, cfg, tokens, ...)       -> (logits, new_caches, aux)
  loss_fn(params, cfg, batch, rng)        -> next-token CE + moe aux
  init_decode_caches(cfg, batch, s, ...)  -> caches (stage-aligned list)
  decode_step(params, cfg, token, pos, caches, ...) -> (logits, caches)
  prefill(params, cfg, tokens, caches, ...)         -> (logits, caches)

Parameters are a flat dict in ``convert``'s names (``stages/0/attn/wq``,
a list entry's key its zero-padded index), in ``jax.tree.flatten`` order
when sorted, so ``convert.params_from_numpy`` of the reference's
``init_model`` output is this layout. Every apply takes a leading client
axis on the parameters and on its inputs (tokens ``[m, b, l]``, frontend
embeddings ``[m, b, T, d]``, caches' per-client leaves), one model a
client, or none (one model, as the reference takes it): ``loss_fn`` then
returns the per-client losses ``[m]``, so ``core.local_sgd`` runs every
client in one backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import (Params, apply_norm, dense_init, embed_tokens,
                     init_embedding, init_norm, logits_from_embedding, mm,
                     prefixed, sub)
from .transformer import (apply_stage, init_block, init_stage,
                          init_stage_cache, torch_dtype)
from ..convert import index_key

MOE_AUX_WEIGHT = 0.01
Key = torch.Tensor | int


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def stage_name(cfg: ArchConfig, si: int) -> str:
    """The flat-name prefix of stage ``si``'s leaves."""
    return f"stages/{index_key(si, len(cfg.stages()))}"


def init_model(key: Key, cfg: ArchConfig, device=None) -> Params:
    """Parameters drawn from ``key`` (a port PRNG key, or an int seed) in
    the reference's order — ``split(key, 16)``, one key a part, each stage
    from ``split(keys[2], n_stages)`` — on ``device`` (CUDA unless
    ``"cpu"``): the key chain and the normal draws run there (T1 and T4
    on the card). Returns the flat dict, without a client axis."""
    dev = resolve_device(device)
    if isinstance(key, int):
        key = prng.PRNGKey(key)
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    keys = prng.split(key.to(dev), 16)
    p: Params = {}

    def norm(prefix):
        p.update(prefixed(prefix, {n: t.to(dev) for n, t in
                                   init_norm(cfg.norm, d, dtype).items()}))

    p.update(prefixed("embed", init_embedding(keys[0], cfg.vocab_size, d,
                                              dtype)))
    if cfg.pos == "learned":
        p["pos_embed"] = dense_init(keys[1], (cfg.max_learned_pos(), d),
                                    dtype, fan_in=d)
    stages = cfg.stages()
    skeys = prng.split(keys[2], len(stages))
    for si, ((kind, n), sk) in enumerate(zip(stages, skeys)):
        p.update(prefixed(stage_name(cfg, si), init_stage(sk, cfg, kind, n)))
    if any(kind == "shared" for kind, _ in stages):
        p.update(prefixed("shared_attn", init_block(keys[3], cfg, "shared")))
    if cfg.is_encoder_decoder:
        p.update(prefixed("enc_stage", init_stage(keys[4], cfg, "enc",
                                                  cfg.encoder_layers)))
        p["enc_pos"] = dense_init(keys[5], (max(cfg.frontend_tokens, 1), d),
                                  dtype, fan_in=d)
        norm("enc_norm")
    if cfg.frontend == "vision":
        p["vis_proj"] = dense_init(keys[6], (d, d), dtype)
    norm("final_norm")
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(keys[7], (d, cfg.vocab_size), dtype)
    return {n: p[n] for n in sorted(p)}


# ---------------------------------------------------------------------------
# The client axis
# ---------------------------------------------------------------------------

def _stacked(params: Params) -> bool:
    """Whether the parameters carry a client axis (the embedding table is
    [V, d] without one)."""
    return params["embed/table"].dim() == 3


def _add_axis(params: Params, *inputs):
    """One model as a client axis of 1: params, inputs and caches (every
    cache leaf but the shared ``kpos``)."""
    out = [{n: t.unsqueeze(0) for n, t in params.items()}]
    for x in inputs:
        out.append(None if x is None else
                   [None if c is None else _cache_axis(c, 0) for c in x]
                   if isinstance(x, list) else x.unsqueeze(0))
    return out


def _cache_axis(cache: Params, drop: int) -> Params:
    """Add (``drop`` 0) or drop (1) the client axis of a stage cache: it
    follows the layer axis of a stacked stage (``kpos`` [n, S], or an ssm
    stage's leaves) and leads a shared block's (``kpos`` [S])."""
    at = 0 if "kpos" in cache and cache["kpos"].dim() == 1 else 1
    return {name: t if name == "kpos" else
            (t.squeeze(at) if drop else t.unsqueeze(at))
            for name, t in cache.items()}


# ---------------------------------------------------------------------------
# Encoder (whisper) / frontend handling
# ---------------------------------------------------------------------------

def _encode(params: Params, cfg: ArchConfig,
            frontend_embeds: torch.Tensor) -> torch.Tensor:
    t = frontend_embeds.shape[2]
    x = frontend_embeds + params["enc_pos"][:, None, :t]
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    x, _, _ = apply_stage(sub(params, "enc_stage"), x, cfg=cfg, kind="enc",
                          n=cfg.encoder_layers, positions=pos)
    return apply_norm(cfg.norm, sub(params, "enc_norm"), x)


def encode(params: Params, cfg: ArchConfig,
           frontend_embeds: torch.Tensor) -> torch.Tensor:
    """Audio stub embeddings [(m,) b, T, d] -> encoder states."""
    if _stacked(params):
        return _encode(params, cfg, frontend_embeds)
    p, fe = _add_axis(params, frontend_embeds)
    return _encode(p, cfg, fe)[0]


def cross_states(params: Params, cfg: ArchConfig,
                 frontend_embeds: torch.Tensor | None):
    """What the cross-attention layers read: the encoder's states
    (whisper), the projected patch embeddings (vlm), or None."""
    if frontend_embeds is None:
        return None
    if cfg.is_encoder_decoder:
        return encode(params, cfg, frontend_embeds)
    if cfg.frontend == "vision":
        w = params["vis_proj"]
        if w.dim() == 2:
            return frontend_embeds @ w
        return mm(frontend_embeds, w)
    return frontend_embeds


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
             positions, frontend_embeds, caches, cross_kv, last_only):
    m, b, l = tokens.shape
    if positions is None:
        positions = torch.arange(l, dtype=torch.int32, device=tokens.device)
    x = embed_tokens(sub(params, "embed"), tokens)
    if cfg.embed_scale:
        # The scale rounded to x's dtype first, as jnp.asarray(.., dtype);
        # a fill on the device, no copy from the host.
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:, positions.long()][:, None]
    x_first = x
    if cross_kv is None and frontend_embeds is not None:
        cross_kv = cross_states(params, cfg, frontend_embeds)
    stages = cfg.stages()
    shared = (sub(params, "shared_attn")
              if any(k == "shared" for k, _ in stages) else None)
    new_caches: list = []
    aux = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for si, (kind, n) in enumerate(stages):
        cache_i = caches[si] if caches is not None else None
        x, nc, a = apply_stage(
            sub(params, stage_name(cfg, si)), x, cfg=cfg, kind=kind, n=n,
            positions=positions, cache=cache_i, cross_kv=cross_kv,
            x_first=x_first, shared_params=shared)
        new_caches.append(nc)
        aux = aux + a
    if last_only:
        x = x[:, :, -1:]
    x = apply_norm(cfg.norm, sub(params, "final_norm"), x)
    if cfg.tie_embeddings:
        logits = logits_from_embedding(sub(params, "embed"), x)
    else:
        logits = mm(x, params["lm_head"])
    return logits, (new_caches if caches is not None else None), aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            frontend_embeds: torch.Tensor | None = None,
            caches: list | None = None,
            cross_states: torch.Tensor | None = None,
            last_only: bool = False):
    """tokens [(m,) b, l]. Returns (logits [(m,) b, l, vocab], caches',
    aux [(m)]). last_only: logits for the final position only (the
    prefill serving path)."""
    kw = dict(positions=positions, last_only=last_only)
    if _stacked(params):
        return _forward(params, cfg, tokens, frontend_embeds=frontend_embeds,
                        caches=caches, cross_kv=cross_states, **kw)
    p, tok, fe, cs, cc = _add_axis(params, tokens, frontend_embeds,
                                   cross_states, caches)
    logits, nc, aux = _forward(p, cfg, tok, frontend_embeds=fe, caches=cc,
                               cross_kv=cs, **kw)
    if nc is not None:
        nc = [None if c is None else _cache_axis(c, 1) for c in nc]
    return logits[0], nc, aux[0]


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: ArchConfig, batch: dict,
            rng=None) -> torch.Tensor:
    """batch: {"tokens": [(m,) b, l], "targets": same, "frontend"?:
    [(m,) b, T, d], "mask"?}. Mean next-token cross-entropy (log-softmax
    in f32) plus ``MOE_AUX_WEIGHT`` times the MoE balance loss: one a
    client ([m]) with a client axis, else a scalar."""
    del rng
    logits, _, aux = forward(params, cfg, batch["tokens"],
                             frontend_embeds=batch.get("frontend"))
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    tgt = batch["targets"]
    nll = -logp.gather(-1, tgt.long().unsqueeze(-1)).squeeze(-1)
    dims = (-2, -1)
    mask = batch.get("mask")
    if mask is not None:
        nll = torch.where(mask, nll, 0.0)
        loss = nll.sum(dim=dims) / torch.clamp(mask.sum(dim=dims), min=1)
    else:
        loss = nll.mean(dim=dims)
    return loss + MOE_AUX_WEIGHT * aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ArchConfig, batch: int, s_alloc: int,
                       dtype=None, *, m: int | None = None,
                       device=None) -> list:
    """A cache a stage (None for stages without one), for one model
    (``m`` None) or m stacked clients, on ``device`` (CUDA unless
    ``"cpu"``)."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else torch_dtype(cfg.dtype)
    caches = [init_stage_cache(cfg, kind, n, batch, s_alloc, dtype,
                               m=1 if m is None else m, device=dev)
              for kind, n in cfg.stages()]
    if m is None:
        caches = [None if c is None else _cache_axis(c, 1) for c in caches]
    return caches


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                pos, caches: list, *,
                cross_states: torch.Tensor | None = None):
    """One-token decode. token: [(m,) b]; pos: the position (an int, or
    a 0-dim int tensor on the device, which a captured step reads),
    the same for the batch. Returns (logits [(m,) b, vocab], caches)."""
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=token.device).reshape(1)
    logits, new_caches, _ = forward(params, cfg, token[..., None],
                                    positions=positions, caches=caches,
                                    cross_states=cross_states)
    return logits[..., 0, :], new_caches


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            caches: list, *, cross_states: torch.Tensor | None = None):
    """Prefill a request into the caches; returns (last logits, caches)."""
    l = tokens.shape[-1]
    positions = torch.arange(l, dtype=torch.int32, device=tokens.device)
    logits, new_caches, _ = forward(params, cfg, tokens, positions=positions,
                                    caches=caches, cross_states=cross_states)
    return logits[..., -1, :], new_caches
