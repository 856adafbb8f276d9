"""Builders shared by the dry-run and the chip checks: a step function,
its ``meta`` inputs and its shardings for every (arch x input-shape x
mesh) combination — the port of the JAX package's ``launch/build.py``.

A mesh here is a ``launch.mesh.ServeMesh``: the production stand-in
(``launch.mesh.make_production_mesh``, ``meta`` cells) or
``launch.mesh.make_named_mesh`` of real devices (``(4, 2)`` ``("data",
"model")`` cells of one card, or distinct cards, one a cell).

The train step under strategy A runs on a ``ClientMesh`` mapped from the
mesh's client axes (the strategy's, one shard a client-axis cell) by its
``"model"`` axis, the parameters laid out by the strategy's specs
(``sharding.rules``). Under strategies B, B2 and B3 it runs on the
mesh's own cells (``Built.mesh`` the ``ServeMesh``;
``core.make_cells_round_step``), the stacked params laid out exactly as
the reference's specs say: B cuts ``"embed"`` over ``"data"`` and the
batch is whole on every data row; B2 cuts ``"mlp"`` and ``"ssm_inner"``
over ``("data", "model")`` and the batch over ``"data"``; B3 cuts
weights over ``"model"`` alone and the batch over ``"data"``. Every data
row trains as a column group on its batch block
(``core.local_sgd.local_train_rows``: data-cut weights gathered at their
use, an SSM's inner dim re-cut to contiguous channels there, their
gradients reduce-scattered, or kept as the row's own slice under B; the
other gradients all-reduced over the data column under B2 and B3), B3
runs once a local step a cell. On one pod (two clients, no client axis)
the dense mix runs on each cell, fp32 or quantized, and the fused round
is the reference's dense fused tail on the cells; on the multi-pod mesh
(its clients on ``"pod"``, one a pod) each pod trains its client on its
cells and the ring gossips over ``"pod"`` within each ``(data, model)``
position (``meta["mixer"]`` ``"ring"``), or with ``mixer_impl="dense"``
each cell mixes the pods' blocks of its position (``"dense"``), fp32 or
quantized; the fused round there is refused with the reference's
reason. A MoE's data rows route their own tokens, one dispatch group a
row, as the reference's ``shard_map``'d MoE does; where the model axis
does not divide ``moe_d_ff`` (the reference's ``shard_map`` then
declines) the rows of a cut batch route as the one group a client the
reference routes (``models.moe.RowRouting`` with ``whole_aux``).

The serving steps run model-sharded on the mesh's cells (a
``ServeMesh``; ``Built.mesh``), laid out exactly as the reference's
specs say: the params by ``_serve_param_specs`` (``RULES_SERVE``, or
``RULES_SERVE_2D`` for Mixtral: weights cut over ``"data"`` too), the
caches by ``_cache_specs`` and the tokens by ``_dp_axes``. ``fn`` runs
every data row as a column group (``sharding.tensor_parallel``): the
row's batch rows, its weights' model columns (a data-cut weight gathered
at its use, layer by layer) and its caches' columns, which it updates in
place and returns; rows never exchange activations. It takes the whole
param dict and cache tree (laid out on each call, uncounted: the
reference's ``in_shardings``) or their ``Cells`` (``Built.mesh.shard``;
what it returns); so does a train step on cells, its state's params.
``build_decode_step``'s ``Built.prefill`` is the
cache-filling prefill on the decode's layout (``model.prefill(...,
tp=)``, the last position's logits only), which the reference gets from
GSPMD on sharded inputs. On ``meta`` cells every row repeats the first
one's work, which ``cost_model`` replays. ``Built.args`` are ``meta``
tensors of the reference's ``ShapeDtypeStruct`` shapes and dtypes (PRNG
keys int64 ``[2]``, the port's layout of the reference's uint32 key), so
evaluating ``fn`` on them allocates nothing; on a mesh of real devices
``fn`` takes real tensors of those shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..configs.base import INPUT_SHAPES, ArchConfig, InputShape
from ..core import (DFedAvgMConfig, MixingSpec, RoundState,
                    make_cells_round_step, make_round_step)
from ..models import model as M
from ..models.moe import MOE_ROWS, RowRouting
from ..models.transformer import torch_dtype
from ..sharding.rules import (RULES_SERVE, RULES_SERVE_2D, P,
                              ShardingStrategy, model_sharded_dims,
                              shapes_and_axes, specs_for_tree, stack_shapes)
from . import cost_model
from .mesh import Cells, ClientMesh, ServeMesh

__all__ = ["Built", "build_train_step",
           "build_decode_step", "build_prefill_step", "build_step",
           "skip_reason"]


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, np.asarray(mesh.devices).shape))


def _device(mesh) -> torch.device:
    return torch.device(np.asarray(mesh.devices).flat[0])


def _dp_axes(mesh, batch: int) -> tuple[str, ...]:
    sizes = _sizes(mesh)
    cands = [a for a in ("pod", "data") if a in sizes]
    total = int(np.prod([sizes[a] for a in cands])) if cands else 1
    if cands and batch % total == 0:
        return tuple(cands)
    if "data" in sizes and batch % sizes["data"] == 0:
        return ("data",)
    return ()


def _dp_spec(axes: tuple[str, ...]):
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


@dataclasses.dataclass
class Built:
    """A built step: ``fn(*args)``, its ``meta`` arguments of the reference's
    shapes, the reference's meta dict, the mesh ``fn`` runs on, the (in, out)
    ``PartitionSpec``s and, for a decode step, its cache-filling prefill."""
    fn: Any                       # the step: fn(*args)
    args: tuple                   # meta tensors (lower(*args) in the reference)
    meta: dict
    # The mesh fn runs on (a strategy-A train step's ClientMesh; a B, B2
    # or B3 train step's ServeMesh; a serving step's ServeMesh),
    # and (in_specs, out_specs): the reference's in_shardings /
    # out_shardings as PartitionSpecs.
    mesh: ClientMesh | ServeMesh | None = None
    specs: Any = None
    # build_decode_step's cache-filling prefill on the decode's layout:
    # prefill(params, tokens, caches, cross=None) -> (last logits, Cells).
    prefill: Any = None


def _meta_like(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _client_mesh(mesh, client_axes: tuple[str, ...]) -> ClientMesh:
    """The ``ClientMesh`` of ``mesh``'s client axes (their cells
    row-major, one shard each) by its ``"model"`` axis, on the mesh's
    first device."""
    sizes = _sizes(mesh)
    n_shards = int(np.prod([sizes[a] for a in client_axes]))
    mp = sizes.get("model", 1)
    grid = np.empty((n_shards, mp), dtype=object)
    for i in np.ndindex(grid.shape):
        grid[i] = _device(mesh)
    if mp == 1:
        return ClientMesh(devices=grid[:, 0])
    return ClientMesh(devices=grid, axis_names=("clients", "model"))


def _model_shapes(cfg: ArchConfig) -> tuple[dict, dict]:
    return shapes_and_axes(lambda k: (M.init_model(k, cfg, device="meta"),
                                      M.model_axes(cfg)))


# ---------------------------------------------------------------------------
# Training round step (DFedAvgM over the model)
# ---------------------------------------------------------------------------

def _check_cells_layout(pspecs: dict, axes: dict) -> None:
    """Refuse a layout the train step on cells would compute otherwise
    than the reference: an MLP or expert block whose gate, up and down
    weights cut their ``"mlp"`` dim unalike (a strided partition of the
    hidden dim is exact only when all three share it). An SSM inner dim
    cut over ``("data", "model")`` is re-cut to the column's contiguous
    channels at its row's gather (``launch.mesh.ServeMesh.row_cells``)."""
    by_block: dict = {}
    for name, names in axes.items():
        spec = pspecs[name]
        for i, logical in enumerate(names):
            entry = spec.names(i + 1)
            if logical == "mlp":
                by_block.setdefault(name.rsplit("/", 1)[0], set()).add(entry)
    for block, entries in by_block.items():
        if len(entries) > 1:
            raise ValueError(f"{block}: its weights cut the mlp dim "
                             f"unalike ({sorted(entries)})")


def build_train_step(cfg: ArchConfig, mesh, shape: InputShape, *,
                     strategy: str | None = None,
                     dfed: DFedAvgMConfig | None = None) -> Built:
    """The DFedAvgM round of ``cfg`` over ``mesh`` under the strategy
    (``ShardingStrategy.for_arch``; module docstring): strategy A on a
    ``ClientMesh`` of the mesh's client axes, B, B2 and B3 on the mesh's
    own cells, on one pod or on the pod mesh, fp32 or quantized, unfused
    or (one pod) fused. ``Built.args`` are ``meta`` (state, batches) of
    the reference's shapes."""
    strat = ShardingStrategy.for_arch(cfg.name, mesh, strategy=strategy)
    m = strat.num_clients
    if dfed is None:
        dfed = DFedAvgMConfig(eta=1e-3, theta=0.9, local_steps=2,
                              mixer_impl="ring" if strat.client_axes
                              else "dense")
    elif not strat.client_axes and dfed.mixer_impl != "dense":
        # strategy B on a single pod: no client mesh axis -> dense mixer
        dfed = dataclasses.replace(dfed, mixer_impl="dense")
    K = dfed.local_steps
    local_bs = max(1, shape.global_batch // m)
    seq = shape.seq_len
    dev = _device(mesh)

    shapes, axes = _model_shapes(cfg)
    stacked = stack_shapes(shapes, m)
    pspecs = specs_for_tree(axes, stacked, strat.rules, mesh,
                            leading_client=strat.client_axes)

    sizes = _sizes(mesh)
    ba0 = tuple(a for a in strat.batch_axes if a in sizes)
    ba = ba0
    if ba and local_bs % int(np.prod([sizes[a] for a in ba])) != 0:
        ba = ()
    spec = MixingSpec.ring(m)
    loss = M.make_loss(cfg)
    # Strategy A's clients lie on the mesh's client axes; B, B2 and B3
    # train on the mesh's own cells (their clients on "pod", if any).
    on_cells = strat.name != "A"
    cmesh = None
    if on_cells:
        _check_cells_layout(pspecs, axes)
        # The reference's MoE routes a cut batch as one group where the
        # model axis does not divide moe_d_ff (its shard_map declines):
        # the rows route their blocks as one group a client.
        one_group = (cfg.n_experts and ba
                     and cfg.moe_d_ff % sizes["model"] != 0)
        step = make_cells_round_step(
            loss, dfed, spec, mesh, pspecs, batch_axes=ba,
            routing=((lambda n: RowRouting(n, whole_aux=True))
                     if one_group else None))
    else:
        cmesh = _client_mesh(mesh, strat.client_axes)
        step = make_round_step(loss, dfed, spec, device=dev, mesh=cmesh,
                               param_specs=pspecs, with_metrics=True)
    lay = mesh if on_cells else cmesh       # where the params are laid out

    smap = None
    if cfg.n_experts > 0 and ba0 and not (on_cells and ba):
        # The reference's shard_map'd MoE for a data-sharded batch: one
        # dispatch group a data shard (models.moe.MOE_SHARD_MAP). On
        # cells a cut batch's rows are those groups already.
        smap = (mesh, ba0, tuple(a for a in ("model",) if a in sizes))

    def fn(state: RoundState, batches: dict):
        if lay is not None and isinstance(state.params, dict):
            with cost_model.uncounted():
                state = state._replace(params=lay.shard(state.params,
                                                        pspecs))
        if smap is None:
            return step(state, batches)
        from ..models.moe import MOE_SHARD_MAP
        tok = MOE_SHARD_MAP.set(smap)
        try:
            return step(state, batches)
        finally:
            MOE_SHARD_MAP.reset(tok)

    fn.step = step              # the round step (its ``local_step`` kind)

    tok_sds = torch.empty((m, K, local_bs, seq), dtype=torch.int32,
                          device="meta")
    batch_sds = {"tokens": tok_sds, "targets": _meta_like(tok_sds, "meta")}
    ca = _dp_spec(strat.client_axes)
    bspec = _dp_spec(ba)
    tok_spec = P(ca, None, bspec, None)
    batch_specs = {"tokens": tok_spec, "targets": tok_spec}
    if cfg.frontend is not None:
        batch_sds["frontend"] = torch.empty(
            (m, K, local_bs, cfg.frontend_tokens, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device="meta")
        batch_specs["frontend"] = P(ca, None, bspec, None, None)

    state_sds = RoundState(
        params={n: _meta_like(t, "meta") for n, t in stacked.items()},
        rng=torch.empty((2,), dtype=torch.int64, device="meta"),
        round=torch.empty((), dtype=torch.int32, device="meta"))
    state_specs = RoundState(params=pspecs, rng=P(), round=P())
    metrics_specs = {"loss": P(), "consensus_dist": P(), "local_drift": P()}
    meta = dict(kind="train", m=m, K=K, local_bs=local_bs, seq=seq,
                strategy=strat.name, client_axes=strat.client_axes,
                tokens_per_step=m * K * local_bs * seq,
                mixer=(dfed.mixer_config().resolved_impl(spec, lay)
                       if strat.client_axes else "dense"),
                quant_bits=(dfed.quant.bits if dfed.quant else 32))
    return Built(fn=fn, args=(state_sds, batch_sds), meta=meta, mesh=lay,
                 specs=((state_specs, batch_specs),
                        (state_specs, metrics_specs)))


# ---------------------------------------------------------------------------
# Serving: consensus-model prefill / decode
# ---------------------------------------------------------------------------

def _serve_param_specs(cfg: ArchConfig, mesh, shapes, axes):
    rules = RULES_SERVE_2D if cfg.name.startswith("mixtral") else RULES_SERVE
    return specs_for_tree(axes, shapes, rules, mesh, leading_client=None)


def _cache_specs(caches_shapes: list, mesh, dp, *,
                 kv_fallback_headdim: bool = True) -> list:
    """Stage-aligned cache sharding by leaf name (a stage without a cache
    keeps None).

    kv_fallback_headdim: when kv_heads doesn't divide the model axis (GQA
    kv < 16), shard the cache on head_dim instead of replicating it —
    contraction-dim sharding turns cache-sized all-gathers into
    score-sized all-reduces.
    """
    dps = _dp_spec(dp)
    model_sz = _sizes(mesh).get("model", 1)

    def by_name(name, leaf):
        shp = leaf.shape
        if name == "kpos":
            return P(*([None] * len(shp)))
        if name in ("k", "v"):          # [n, b, S, kv, hd] or [b, S, kv, hd]
            kv, hd = shp[-2], shp[-1]
            if kv % model_sz == 0:
                kvs, hds = "model", None
            elif kv_fallback_headdim and hd % model_sz == 0:
                kvs, hds = None, "model"
            else:
                kvs, hds = None, None
            if len(shp) == 5:
                return P(None, dps, None, kvs, hds)
            return P(dps, None, kvs, hds)   # shared block: unstacked
        if name in ("conv_x", "conv_B", "conv_C"):   # [n, b, 3, c]
            c = shp[-1]
            return P(None, dps, None,
                     "model" if c % model_sz == 0 else None)
        if name == "ssm":               # [n, b, h, n_state, p]
            h = shp[-3]
            return P(None, dps,
                     "model" if h % model_sz == 0 else None, None, None)
        return P(*([None] * len(shp)))

    return [None if c is None else {n: by_name(n, t) for n, t in c.items()}
            for c in caches_shapes]


def _nbytes(caches: list) -> int:
    return sum(t.numel() * t.element_size() for c in caches
               if c is not None for t in c.values())


@cost_model.repeats_on_meta
def _serve_row(kind: str, cfg: ArchConfig, group, view: dict, tokens,
               pos, caches, cross):
    """One serving row's step on its column group: ``"prefill"`` the last
    position's logits of a whole forward, ``"fill"`` a cache-filling
    prefill's, ``"decode"`` one token's (the row's caches updated in
    place). Returns [b_row, vocab] at the row's home."""
    if kind == "prefill":
        logits, _, _ = M.forward(view, cfg, tokens, frontend_embeds=cross,
                                 last_only=True, tp=group)
        return logits[:, 0]
    if kind == "fill":
        return M.prefill(view, cfg, tokens, caches, cross_states=cross,
                         tp=group)[0]
    return M.decode_step(view, cfg, tokens, pos, caches, cross_states=cross,
                         tp=group)[0]


def _run_rows(smesh: ServeMesh, kind: str, cfg: ArchConfig, dp: tuple,
              pcells: Cells, pspecs: dict, tokens, pos=None,
              ccells: Cells | None = None, cspecs=None, cross=None):
    """``kind`` on every row of ``smesh`` (its batch rows by ``dp``; the
    whole batch on every row when ``dp`` is empty) -> the logits of the
    whole batch on the first cell's device. A MoE routes the rows'
    blocks as the one dispatch group of the whole batch
    (``models.moe.MOE_ROWS``)."""
    dims = model_sharded_dims(pspecs, "model")
    b = tokens.shape[0]
    starts = sorted({smesh.batch_rows(r, dp, b).start for r in smesh.rows()})
    routing = (RowRouting(len(starts)) if cfg.n_experts and len(starts) > 1
               else None)
    outs = {}
    reset = MOE_ROWS.set(routing)
    try:
        with torch.no_grad():
            for row in smesh.rows():
                group = smesh.row_group(row, dims)
                rows = smesh.batch_rows(row, dp, b)
                if routing is not None:
                    routing.enter(starts.index(rows.start))
                with cost_model.uncounted():
                    tok = tokens[rows].to(group.home)
                    cr = (None if cross is None
                          else cross[rows].to(group.home))
                    p = None if pos is None else pos.to(group.home)
                view = smesh.row_view(pcells, pspecs, row)
                cv = (None if ccells is None else
                      smesh.row_view(ccells, cspecs, row, every_column=True))
                out = _serve_row(kind, cfg, group, view, tok, p, cv, cr)
                outs.setdefault(rows.start, out)
    finally:
        MOE_ROWS.reset(reset)
    with cost_model.uncounted():
        home = smesh.devices.flat[0]
        return torch.cat([outs[s].to(home) for s in starts], dim=0)


def _laid_out(smesh: ServeMesh, tree, specs) -> Cells:
    """``tree`` as cells: as given when it is already, else laid out
    (uncounted: the reference's in_shardings)."""
    if isinstance(tree, Cells):
        return tree
    with cost_model.uncounted():
        return smesh.shard(tree, specs)


def build_decode_step(cfg: ArchConfig, mesh, shape: InputShape, *,
                      cache_headdim: bool = True) -> Built:
    """One decode step of ``cfg`` on ``mesh``'s cells (module docstring):
    params by the serving rules, caches by ``_cache_specs``, tokens by the
    data axes; ``Built.prefill`` fills the caches on the same layout."""
    from ..models.attention import DECODE_Q_SPEC

    b = shape.global_batch
    s_alloc = shape.seq_len
    dp = _dp_axes(mesh, b)
    dps = _dp_spec(dp)

    shapes, axes = _model_shapes(cfg)
    pspecs = _serve_param_specs(cfg, mesh, shapes, axes)
    params = dict(shapes)

    caches_shapes = M.init_decode_caches(cfg, b, s_alloc, device="meta")
    total_cache_bytes = _nbytes(caches_shapes)
    # hd-sharding only pays when the cache is big (replicating a small
    # cache is free; hd-sharding it adds score all-reduces).
    cache_headdim = cache_headdim and total_cache_bytes > 1 << 30
    cspecs = _cache_specs(caches_shapes, mesh, dp,
                          kv_fallback_headdim=cache_headdim)

    needs_cross = cfg.frontend is not None
    model_sz = _sizes(mesh).get("model", 1)
    hd_fallback = (cache_headdim and cfg.n_kv_heads
                   and cfg.n_kv_heads % model_sz != 0
                   and cfg.head_dim % model_sz == 0)
    q_hint = P(dps, None, None, None) if hd_fallback else None

    def hinted(kind, params, tokens, pos, caches, cross):
        pc = _laid_out(mesh, params, pspecs)
        cc = _laid_out(mesh, caches, cspecs)
        tok = DECODE_Q_SPEC.set(q_hint)
        try:
            logits = _run_rows(mesh, kind, cfg, dp, pc, pspecs, tokens,
                               pos, cc, cspecs, cross)
        finally:
            DECODE_Q_SPEC.reset(tok)
        return logits, cc

    def fn(params, token, pos, caches, cross=None):
        return hinted("decode", params, token, pos, caches, cross)

    def fill(params, tokens, caches, cross=None):
        return hinted("fill", params, tokens, None, caches, cross)

    args = (params, torch.empty((b,), dtype=torch.int32, device="meta"),
            torch.empty((), dtype=torch.int32, device="meta"),
            caches_shapes)
    in_specs = (pspecs, P(dps), P(), cspecs)
    if needs_cross:
        args += (torch.empty((b, cfg.frontend_tokens, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device="meta"),)
        in_specs += (P(dps, None, None),)
    meta = dict(kind="decode", batch=b, s_alloc=s_alloc, dp=dp,
                tokens_per_step=b, cache_bytes=total_cache_bytes)
    return Built(fn=fn, args=args, meta=meta, mesh=mesh,
                 specs=(in_specs, (P(dps, None), cspecs)), prefill=fill)


def build_prefill_step(cfg: ArchConfig, mesh, shape: InputShape) -> Built:
    """The prefill of ``cfg`` on ``mesh``'s cells: every data row's prompts
    through a column-parallel forward, the last position's logits."""
    b = shape.global_batch
    seq = shape.seq_len
    dp = _dp_axes(mesh, b)
    dps = _dp_spec(dp)

    shapes, axes = _model_shapes(cfg)
    pspecs = _serve_param_specs(cfg, mesh, shapes, axes)
    params = dict(shapes)

    def fn(params, tokens, fe=None):
        return _run_rows(mesh, "prefill", cfg, dp,
                         _laid_out(mesh, params, pspecs), pspecs, tokens,
                         cross=fe)

    args = (params, torch.empty((b, seq), dtype=torch.int32, device="meta"))
    in_specs = (pspecs, P(dps, None))
    if cfg.frontend is not None:
        args += (torch.empty((b, cfg.frontend_tokens, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype), device="meta"),)
        in_specs += (P(dps, None, None),)
    meta = dict(kind="prefill", batch=b, seq=seq, dp=dp,
                tokens_per_step=b * seq)
    return Built(fn=fn, args=args, meta=meta, mesh=mesh,
                 specs=(in_specs, P(dps, None)))


def build_step(cfg: ArchConfig, mesh, shape_name: str, **kw) -> Built:
    """The step of input shape ``shape_name`` (``INPUT_SHAPES``): a train,
    prefill or decode build (``kw`` to the train build)."""
    shape = INPUT_SHAPES[shape_name]
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape)
    return build_decode_step(cfg, mesh, shape)


def skip_reason(cfg: ArchConfig, shape_name: str) -> str | None:
    """The reference's skips (its DESIGN.md §5)."""
    shape = INPUT_SHAPES[shape_name]
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("full-attention arch: 512k dense KV decode has no "
                "sub-quadratic path (DESIGN.md §5)")
    return None
