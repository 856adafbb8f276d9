"""Model wrappers: decoder LM, encoder-decoder (whisper), VLM (llama-3.2-v)
— the port of the JAX package's ``models/model.py``.

Public functional API (everything is (params, cfg)-explicit):

  init_model(key, cfg, device=None)       -> params (flat dict)
  model_axes(cfg)                         -> flat name -> logical axes
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

:func:`make_loss` is the training loss the round steps take. It carries
a column-parallel form (``sharding.tensor_parallel``) for every
registered architecture: ``loss_fn(..., tp=group)`` on a 2D mesh row's
view, with the vocabulary-parallel embedding and logits, heads-cut
self- and cross-attention, the cut MLP, the MoE with its experts or
their ``moe_d_ff`` cut, the Mamba2 mixer with its inner dim cut (with
its heads or across them), the hybrid's shared block (``down``
row-parallel) and the encoder, so the round trains that row's cells
tensor-parallel. The form takes every cut the strategies' rules make
(:func:`_tp_covers`), an SSM inner dim cut across heads included
(``ssm._sub_heads``).

Serving on a mesh (``launch.build``'s prefill and decode on a
``launch.mesh.ServeMesh``): ``forward(..., caches=, tp=)``,
``prefill(..., tp=)`` and ``decode_step(..., tp=)`` take a serving row's
view (``ServeMesh.row_view``: unstacked leaves, a model-cut leaf the list
of its columns' blocks, a data-cut one a ``DataCut``) and its caches
(one copy or slice a column, updated in place); a data-cut leaf is
gathered at its use, and a vocabulary-cut head's logits are joined at
home for ``last_only`` and for a cached forward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import prng
from ..configs.base import ArchConfig
from ..device import resolve_device
from .layers import (Params, apply_norm, dense_init, embed_tokens,
                     init_embedding, init_norm, logits_from_embedding, mm,
                     prefixed, sub, vocab_logits, vocab_parallel_nll)
from .moe import MOE_LAYER
from .transformer import (apply_stage, init_block, init_stage,
                          init_stage_cache, torch_dtype)
from ..convert import index_key
from ..sharding.tensor_parallel import gather_data, with_column_parallel

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
# Logical axes (what sharding.rules maps onto a mesh)
# ---------------------------------------------------------------------------

_MLP = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
        "wd": ("mlp", "embed")}
_ATTN = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed"),
         "q_norm": ("head_dim",), "k_norm": ("head_dim",)}
# A block's leaves (a stage's carry a leading "layers" dim), by the name
# inside the block, as the reference's init_block returns them.
_BLOCK_AXES = {
    **{f"attn/{n}": a for n, a in _ATTN.items()},
    **{f"xattn/{n}": a for n, a in _ATTN.items()},
    **{f"mlp/{n}": a for n, a in _MLP.items()},
    **{f"{ln}/{p}": ("embed",) for ln in ("ln", "ln1", "ln2", "lnx")
       for p in ("scale", "bias")},
    "moe/router": ("embed", "experts"),
    "moe/wg": ("experts", "embed", "mlp"),
    "moe/wu": ("experts", "embed", "mlp"),
    "moe/wd": ("experts", "mlp", "embed"),
    "mixer/wz": ("embed", "ssm_inner"), "mixer/wx": ("embed", "ssm_inner"),
    "mixer/wB": ("embed", "ssm_state"), "mixer/wC": ("embed", "ssm_state"),
    "mixer/wdt": ("embed", "ssm_heads"),
    "mixer/conv_x": ("conv", "ssm_inner"),
    "mixer/conv_B": ("conv", "ssm_state"),
    "mixer/conv_C": ("conv", "ssm_state"),
    "mixer/dt_bias": ("ssm_heads",), "mixer/A_log": ("ssm_heads",),
    "mixer/D": ("ssm_heads",), "mixer/norm_scale": ("ssm_inner",),
    "mixer/wo": ("ssm_inner", "embed"),
    "gate_attn": (None,), "gate_mlp": (None,),
    "down": ("embed2", "embed"),
}
_TOP_AXES = {
    "embed/table": ("vocab", "embed"), "pos_embed": ("seq", "embed"),
    "enc_pos": ("seq", "embed"), "lm_head": ("embed", "vocab"),
    "vis_proj": ("embed", "embed_out"),
    **{f"{ln}/{p}": ("embed",) for ln in ("final_norm", "enc_norm")
       for p in ("scale", "bias")},
}


def _leaf_axes(name: str) -> tuple:
    if name in _TOP_AXES:
        return _TOP_AXES[name]
    parts = name.split("/")
    if parts[0] == "stages":
        return ("layers",) + _BLOCK_AXES["/".join(parts[2:])]
    if parts[0] == "enc_stage":
        return ("layers",) + _BLOCK_AXES["/".join(parts[1:])]
    if parts[0] == "shared_attn":
        return _BLOCK_AXES["/".join(parts[1:])]
    raise KeyError(f"no logical axes for leaf {name!r}")


def model_axes(cfg: ArchConfig) -> dict[str, tuple]:
    """Flat name -> the leaf's logical dim names (``"layers"`` leading a
    stage's leaves), in :func:`init_model`'s names: the reference's
    ``init_model(key, cfg)[1]`` flattened. The names come from an init on
    the ``meta`` device (nothing is allocated); every tuple has its
    leaf's rank."""
    meta = init_model(torch.zeros(2, dtype=torch.int64, device="meta"), cfg,
                      device="meta")
    out = {}
    for name, t in meta.items():
        axes = _leaf_axes(name)
        if len(axes) != t.dim():
            raise ValueError(f"{name}: axes {axes} for a rank-{t.dim()} "
                             "leaf")
        out[name] = axes
    return out


# ---------------------------------------------------------------------------
# The client axis
# ---------------------------------------------------------------------------

def _first(t):
    """A leaf, or the first column's block of a list-valued one."""
    return t[0] if isinstance(t, list) else t


def _stacked(params: Params) -> bool:
    """Whether the parameters carry a client axis (the embedding table is
    [V, d] without one, also in a column's block)."""
    return _first(params["embed/table"]).dim() == 3


def _each(fn, t):
    """``fn`` on a leaf, or on each column's block of a list-valued one."""
    return [fn(c) for c in t] if isinstance(t, list) else fn(t)


def _add_axis(params: Params, *inputs):
    """One model as a client axis of 1: params, inputs and caches (every
    cache leaf but the shared ``kpos``)."""
    out = [{n: _each(lambda t: t.unsqueeze(0), t)
            for n, t in params.items()}]
    for x in inputs:
        out.append(None if x is None else
                   [None if c is None else _cache_axis(c, 0) for c in x]
                   if isinstance(x, list) else x.unsqueeze(0))
    return out


def _cache_axis(cache: Params, drop: int) -> Params:
    """Add (``drop`` 0) or drop (1) the client axis of a stage cache: it
    follows the layer axis of a stacked stage (``kpos`` [n, S], or an ssm
    stage's leaves) and leads a shared block's (``kpos`` [S])."""
    at = 0 if "kpos" in cache and _first(cache["kpos"]).dim() == 1 else 1
    return {name: t if name == "kpos" else
            _each(lambda c: c.squeeze(at) if drop else c.unsqueeze(at), t)
            for name, t in cache.items()}


# ---------------------------------------------------------------------------
# Encoder (whisper) / frontend handling
# ---------------------------------------------------------------------------

def _encode(params: Params, cfg: ArchConfig,
            frontend_embeds: torch.Tensor, tp=None) -> torch.Tensor:
    t = frontend_embeds.shape[2]
    x = frontend_embeds + params["enc_pos"][:, None, :t]
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    x, _, _ = apply_stage(sub(params, "enc_stage"), x, cfg=cfg, kind="enc",
                          n=cfg.encoder_layers, positions=pos, tp=tp)
    return apply_norm(cfg.norm, sub(params, "enc_norm"), x)


def encode(params: Params, cfg: ArchConfig,
           frontend_embeds: torch.Tensor, tp=None) -> torch.Tensor:
    """Audio stub embeddings [(m,) b, T, d] -> encoder states. ``tp``: a
    column group, ``params`` a 2D mesh row's view (the states at
    home)."""
    if _stacked(params):
        return _encode(params, cfg, frontend_embeds, tp)
    p, fe = _add_axis(params, frontend_embeds)
    return _encode(p, cfg, fe)[0]


def cross_states(params: Params, cfg: ArchConfig,
                 frontend_embeds: torch.Tensor | None, tp=None):
    """What the cross-attention layers read: the encoder's states
    (whisper), the projected patch embeddings (vlm), or None; with a
    column group ``tp``, at home."""
    if frontend_embeds is None:
        return None
    if cfg.is_encoder_decoder:
        return encode(params, cfg, frontend_embeds, tp)
    if cfg.frontend == "vision":
        w = params["vis_proj"]
        if w.dim() == 2:
            return frontend_embeds @ w
        return mm(frontend_embeds, w)
    return frontend_embeds


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

# The leaves a stage gathers layer by layer (transformer.apply_stage).
_LAYERED = ("stages/", "enc_stage/", "shared_attn/")


def _forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
             positions, frontend_embeds, caches, cross_kv, last_only,
             tp=None):
    m, b, l = tokens.shape
    if positions is None:
        positions = torch.arange(l, dtype=torch.int32, device=tokens.device)
    if tp is not None:
        # A serving row's data-cut leaves: the small top-level ones
        # gathered now, the table and the head at their use.
        params = {n: t if n.startswith(_LAYERED)
                  or n in ("embed/table", "lm_head") else gather_data(t)
                  for n, t in params.items()}
    x = embed_tokens({"table": gather_data(params["embed/table"])}, tokens,
                     tp=tp)
    if cfg.embed_scale:
        # The scale rounded to x's dtype first, as jnp.asarray(.., dtype);
        # a fill on the device, no copy from the host.
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:, positions.long()][:, None]
    x_first = x
    if cross_kv is None and frontend_embeds is not None:
        cross_kv = cross_states(params, cfg, frontend_embeds, tp)
    stages = cfg.stages()
    shared = (sub(params, "shared_attn")
              if any(k == "shared" for k, _ in stages) else None)
    new_caches: list = []
    aux = torch.zeros((m,), dtype=torch.float32, device=x.device)
    for si, (kind, n) in enumerate(stages):
        cache_i = caches[si] if caches is not None else None
        stage = MOE_LAYER.set((si,))
        try:
            x, nc, a = apply_stage(
                sub(params, stage_name(cfg, si)), x, cfg=cfg, kind=kind,
                n=n, positions=positions, cache=cache_i, cross_kv=cross_kv,
                x_first=x_first, shared_params=shared, tp=tp)
        finally:
            MOE_LAYER.reset(stage)
        new_caches.append(nc)
        aux = aux + a
    if last_only:
        x = x[:, :, -1:]
    x = apply_norm(cfg.norm, sub(params, "final_norm"), x)
    head = gather_data(params["embed/table" if cfg.tie_embeddings
                              else "lm_head"])
    if isinstance(head, list):
        logits = vocab_logits(tp, head, x, cfg.tie_embeddings)
        if last_only or caches is not None:     # serving: joined at home
            logits = tp.gather(logits, dim=-1)
    elif cfg.tie_embeddings:
        logits = logits_from_embedding({"table": head}, x)
    else:
        logits = mm(x, head)
    return logits, (new_caches if caches is not None else None), aux


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            frontend_embeds: torch.Tensor | None = None,
            caches: list | None = None,
            cross_states: torch.Tensor | None = None,
            last_only: bool = False, tp=None):
    """tokens [(m,) b, l]. Returns (logits [(m,) b, l, vocab], caches',
    aux [(m)]). last_only: logits for the final position only (the
    prefill serving path). ``tp``: a column group, ``params`` a 2D mesh
    row's view (``ColumnGroup.view``, stacked), or a serving row's
    (``launch.mesh.ServeMesh.row_view``, unstacked, its ``caches`` one
    copy or slice a column, updated in place); with a cut vocabulary the
    logits are the columns' slices, a list, joined at home for
    ``last_only`` and for a cached forward."""
    kw = dict(positions=positions, last_only=last_only)
    if _stacked(params):
        return _forward(params, cfg, tokens, frontend_embeds=frontend_embeds,
                        caches=caches, cross_kv=cross_states, tp=tp, **kw)
    p, tok, fe, cs, cc = _add_axis(params, tokens, frontend_embeds,
                                   cross_states, caches)
    logits, nc, aux = _forward(p, cfg, tok, frontend_embeds=fe, caches=cc,
                               cross_kv=cs, tp=tp, **kw)
    if nc is not None:
        nc = [None if c is None else _cache_axis(c, 1) for c in nc]
    return logits[0], nc, aux[0]


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: ArchConfig, batch: dict,
            rng=None, tp=None) -> torch.Tensor:
    """batch: {"tokens": [(m,) b, l], "targets": same, "frontend"?:
    [(m,) b, T, d], "mask"?}. Mean next-token cross-entropy (log-softmax
    in f32) plus ``MOE_AUX_WEIGHT`` times the MoE balance loss: one a
    client ([m]) with a client axis, else a scalar. With a column group
    ``tp`` (``params`` a 2D mesh row's view) a cut vocabulary's
    log-softmax runs across the columns (``layers.vocab_parallel_nll``)."""
    del rng
    logits, _, aux = forward(params, cfg, batch["tokens"],
                             frontend_embeds=batch.get("frontend"), tp=tp)
    tgt = batch["targets"]
    if isinstance(logits, list):
        nll = vocab_parallel_nll(tp, logits, tgt)
    else:
        logp = F.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -logp.gather(-1, tgt.long().unsqueeze(-1)).squeeze(-1)
    dims = (-2, -1)
    mask = batch.get("mask")
    if mask is not None:
        nll = torch.where(mask, nll, 0.0)
        loss = nll.sum(dim=dims) / torch.clamp(mask.sum(dim=dims), min=1)
    else:
        loss = nll.mean(dim=dims)
    return loss + MOE_AUX_WEIGHT * aux


# The block leaves the column-parallel form takes cut (the strategy-A
# rules cut each where its dim divides by the model axis), by their name
# inside the block: attention's projections (self and cross), the MLP,
# the MoE's router and experts, the Mamba2 mixer's inner dim and heads,
# and the shared block's ``down``.
_SSM_INNER = ("wz", "wx", "conv_x", "norm_scale", "wo")
_TP_LEAVES = frozenset(
    [f"{a}/{w}" for a in ("attn", "xattn")
     for w in ("wq", "wk", "wv", "wo")]
    + [f"mlp/{w}" for w in ("wg", "wu", "wd")]
    + [f"moe/{w}" for w in ("router", "wg", "wu", "wd")]
    + [f"mixer/{w}" for w in _SSM_INNER + ("wdt", "dt_bias", "A_log", "D")]
    + ["down"])
# A flat name's block prefix: a stage's leaves carry its index.
_BLOCK_DEPTH = {"stages": 2, "enc_stage": 1, "shared_attn": 1}


def _tp_covers(name: str, dims: dict) -> bool:
    """Whether the column-parallel form takes leaf ``name`` cut (``dims``
    every leaf's cut dim): the vocabulary's (the table, ``lm_head``) and
    the block leaves of ``_TP_LEAVES``, under a stage, the encoder's
    stage or the shared block. An SSM mixer's inner-dim leaves are taken
    with its heads cut or not (where the model axis divides ``ssm_inner``
    but not ``ssm_heads`` a column's channels cross heads, which
    ``ssm._sub_heads`` reads as sub-heads)."""
    del dims
    if name in ("embed/table", "lm_head"):
        return True
    parts = name.split("/")
    depth = _BLOCK_DEPTH.get(parts[0])
    return depth is not None and "/".join(parts[depth:]) in _TP_LEAVES


def _tp_heads(name: str) -> bool:
    """Whether the column-parallel form reads leaf ``name``'s column as a
    contiguous block of channels: an SSM mixer's inner-dim leaves (a cut
    over ``("data", "model")``, strided across the columns, is re-cut to
    the column's contiguous channels at the row's gather, whether or not
    they end on head boundaries)."""
    parts = name.split("/")
    depth = _BLOCK_DEPTH.get(parts[0])
    return (depth is not None and len(parts) == depth + 2
            and parts[depth] == "mixer" and parts[-1] in _SSM_INNER)


def make_loss(cfg: ArchConfig):
    """The round's ``loss(params, batch, rng) -> [m]`` (:func:`loss_fn`),
    carrying its column-parallel form (``loss_fn(..., tp=group)``, the
    leaves it takes cut :func:`_tp_covers`)."""
    def loss(p, b, r):
        return loss_fn(p, cfg, b, r)

    return with_column_parallel(
        loss, lambda g, view, b, r: loss_fn(view, cfg, b, r, tp=g),
        _tp_covers, _tp_heads)


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
                cross_states: torch.Tensor | None = None, tp=None):
    """One-token decode. token: [(m,) b]; pos: the position (an int, or
    a 0-dim int tensor on the device, which a captured step reads),
    the same for the batch. ``tp``: a column group, ``params`` and
    ``caches`` a serving row's view (:func:`forward`). Returns (logits
    [(m,) b, vocab], caches)."""
    positions = torch.as_tensor(pos, dtype=torch.int32,
                                device=token.device).reshape(1)
    logits, new_caches, _ = forward(params, cfg, token[..., None],
                                    positions=positions, caches=caches,
                                    cross_states=cross_states, tp=tp)
    return logits[..., 0, :], new_caches


def prefill(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
            caches: list, *, cross_states: torch.Tensor | None = None,
            tp=None):
    """Prefill a request into the caches; returns (last logits, caches).
    ``tp``: as :func:`decode_step`'s; only the last position's logits
    are computed then (the reference's ``last_only``)."""
    l = tokens.shape[-1]
    positions = torch.arange(l, dtype=torch.int32, device=tokens.device)
    logits, new_caches, _ = forward(params, cfg, tokens, positions=positions,
                                    caches=caches, cross_states=cross_states,
                                    last_only=tp is not None, tp=tp)
    return logits[..., -1, :], new_caches
