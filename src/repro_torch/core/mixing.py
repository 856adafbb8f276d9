"""Gossip mixing x^{t+1}(i) = sum_l w_{i,l} z^t(l)  (paper eqs. 5 and 7) —
the JAX package's ``core/mixing.py`` for a static ``MixingSpec`` and a
time-varying ``TopologySchedule``, on one device, on a 1D client mesh or
on a 2D ``(clients, model)`` mesh.

Client copies are stacked: every leaf of a parameter dict carries a
leading client axis of size m. Two backends:

  * ``dense`` — ``x' = W @ z`` as a tensordot over the client axis, and
    its quantized recursion; the reference, for any W.

  * the PLAN realization (``impl="ring"`` / ``"torus"`` for those specs,
    ``"sparse"`` for any other bounded-degree graph and every schedule)
    — the JAX package's sparse executor, whose mesh-free spec is
    ``execute_plan_reference``. Quantized, one round is: flatten to the
    planar wire buffer, encode every client in one B1 launch (which draws
    the stochastic-rounding noise itself from the per-leaf keys), then one
    B2 launch that gathers each plan step's words and scales through the
    plan's ``src`` table and decodes and applies them, own stream first.

Every plan compiles to the reference's ``BlockPlan`` over lane blocks
(``_ShardTables``), and one executor (``_make_exec``) runs it. On a 1D
client mesh (``launch.mesh.ClientMesh``: shard ``s`` holds lanes
``[s*m_local, (s+1)*m_local)`` on ``devices[s]``; the state is a list of
dicts, one a shard, :func:`split_lanes` / :func:`join_lanes`) an edge
inside a block is a lane gather on the shard, an edge that crosses
blocks is a transfer of the crossing lanes — one device copy a sub-step
and (src, dst) pair, all of a round's issued before the first decode —
that ships the reference's stream: the words, the per-leaf scales and,
for ``lemma5``, the f32 replica row. Each shard then runs B1 and B2 over
its own lanes, B2 reading a table of its own rows followed by the rows it
received, in the reference's stream order. Without a mesh the one
device is a one-shard mesh: no transfer, and a plan step's ``ppermute``
is an index gather inside B2. A
``Placement`` relabels lanes so that fewer edges cross; the callers hold
state in lane order and the quantizer keys are drawn in client order
and gathered through ``lane_to_client``, so placed runs are bitwise
unplaced ones.

On a 2D mesh (``[n_shards, mp]`` cells; ``param_specs``, flat name ->
``sharding.PartitionSpec``, say which leaves the ``"model"`` axis cuts)
the state is a list of cells, row-major (:func:`cut_columns` /
:func:`join_columns`): cell ``(s, c)`` holds shard s's lanes with every
cut leaf narrowed to column c's block. The same executor runs on every
cell; a transfer moves between the cells of one column only and ships
that cell's slice. Two fixups keep the codes the 1D layout's: the
per-leaf amaxes meet over the row (their max, order-exact, so the scales
are bitwise the 1D ones), and stochastic rounding takes the full leaf's
draw (one T2 launch a leaf over the m keys), cut as the params are and
handed to B1's tensor-noise entry. A 1D mesh is a 2D mesh of one
column, one device a one-cell mesh.

A schedule's round samples ``(W_t, active)`` on the device
(``TopologySchedule.round_event``); the plan realization then gathers
B2's ``[m, K]`` weights table from ``W_t`` (one gather over the support
plan's streams, masked edges kept at weight 0 so the combination order is
the reference's), and inactive clients' ``z`` is gated back to ``x``
(``make_event_mixer``). A cycle stacks its members' plans, padded to one
K with identity streams of weight 0, and picks its member by the round
index, a host int or a device tensor, so one CUDA graph holds every
member.

``make_fused_tail`` is the fused round's tail over the same two backends
(B4 encodes, drawing its noise from the keys as B1 does; B5 decodes and
applies the deferred last step).

Semantics, as in the JAX package:
  unquantized (Alg. 1, eq. 5):  x' = W @ z
  quantized, ``eq7``:           x' = x + W @ Q(z - x)
  quantized, ``lemma5``:        x' = W @ (x + Q(z - x))
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from .. import prng
from ..device import resolve_device
from .gossip_plan import GossipPlan
from .local_sgd import loss_and_grad
from .quantize import QuantConfig, dequantize_int, quantize_int
from .topology import MixingSpec, TopologySchedule, _at, _on
from .wire_layout import WireLayout

Params = dict[str, torch.Tensor]

__all__ = ["MixerConfig", "make_mixer", "make_scheduled_mixer",
           "make_plan_mixer", "make_event_mixer", "make_fused_tail",
           "execute_plan_reference", "mix_dense", "consensus_distance",
           "split_lanes", "join_lanes", "cut_columns", "join_columns"]

_IMPLS = ("auto", "dense", "ring", "torus", "sparse")
_WIRES = ("auto", "seq", "planar")


def _clients_per_shard(mesh, m: int) -> int | None:
    """Lanes a shard of the client ``mesh`` holds (``m_local``) when its
    shards — the rows along its client axis, ``mesh.axis_names[0]`` —
    divide ``m``, else None (the mesh does not fit); None for no mesh."""
    if mesh is None:
        return None
    n_shards = int(np.asarray(mesh.devices).shape[0])
    if m % n_shards:
        return None
    return m // n_shards


@dataclasses.dataclass(frozen=True)
class MixerConfig:
    """Gossip mixer selection.

    impl:  "auto" | "dense" | "ring" | "torus" | "sparse". "dense" is
           the tensordot reference; "ring"/"torus"/"sparse" run the
           compiled GossipPlan (the plan realization); "auto" picks the
           plan realization for every schedule and every static graph
           but a complete one — on one device always, on a client mesh
           when the mesh fits (its shards divide m), as the JAX package
           does.
    quant: None disables Algorithm 2.
    wire:  "auto" | "seq" | "planar", the reference's codec choice. The
           reference's "seq" is the pure-XLA lowering of its Pallas
           kernels; the port has one codec, so every value runs the same
           path: the CUDA kernels (B1 and B2; B4 and B5 in the fused
           tail) on CUDA tensors, their plain versions on CPU tensors.
    """

    impl: str = "auto"
    quant: QuantConfig | None = None
    wire: str = "auto"

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(
                f"unknown mixer impl {self.impl!r}; allowed impls: "
                + " | ".join(repr(i) for i in _IMPLS))
        check_wire(self.wire)

    def resolved_impl(self, spec: MixingSpec | TopologySchedule,
                      mesh=None) -> str:
        if self.impl != "auto":
            return self.impl
        if mesh is not None and _clients_per_shard(mesh, spec.m) is None:
            return "dense"
        if isinstance(spec, TopologySchedule):
            return "sparse"
        if spec.kind in ("ring", "torus"):
            return spec.kind
        if int(spec.graph.degrees().max()) < spec.m - 1:
            return "sparse"
        return "dense"


def check_wire(wire: str) -> None:
    """Refuse a wire codec other than ``_WIRES``, with the reference's
    message."""
    if wire not in _WIRES:
        raise ValueError(f"unknown wire codec {wire!r}; allowed: "
                         + " | ".join(repr(w) for w in _WIRES))


def mix_dense(W, stacked: Params) -> Params:
    """Eq. 5 reference: x' = W @ z per leaf, f32 over the client axis.

    ``W`` is numpy, as in the JAX package, or an f32 tensor already on
    the leaves' device (what the mixers and DSGD pass: built once, so a
    round copies nothing from the host)."""
    out = {}
    for name, z in stacked.items():
        Wt = _device_w(W, z.device)
        out[name] = torch.tensordot(Wt, z.to(torch.float32),
                                    dims=([1], [0])).to(z.dtype)
    return out


def _device_w(W, dev: torch.device) -> torch.Tensor:
    """``W`` as an f32 tensor on ``dev``: converted from numpy, or a
    tensor already there (no copy)."""
    if isinstance(W, torch.Tensor):
        if W.dtype != torch.float32 or W.device != dev:
            raise ValueError(f"W must be f32 on {dev}, got {W.dtype} on "
                             f"{W.device}")
        return W
    return torch.as_tensor(np.asarray(W), dtype=torch.float32, device=dev)


def _key_on(key: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """The mixing key, which must already lie on the parameters' device:
    a host key would cost a pageable copy every round and cannot be
    captured in a CUDA graph."""
    if key is None or key.device != dev:
        raise ValueError(f"the quantizer key must be on {dev}, got "
                         f"{None if key is None else key.device}")
    return key


def _quant_leaf_keys(key: torch.Tensor, n_leaves: int, m: int
                     ) -> torch.Tensor:
    """How a mixing key becomes per-leaf, per-client quantizer keys —
    shared by the dense reference and the plan realization so both draw
    identical stochastic-rounding bits: [n_leaves, m, 2]."""
    return prng.split(key, n_leaves * m).reshape(n_leaves, m, 2)


def _mix_dense_quantized(W, x: Params, z: Params, quant: QuantConfig,
                         key: torch.Tensor | None,
                         leaf_keys: torch.Tensor | None = None) -> Params:
    """Eq. 7 / Lemma 5 with dense W (numpy, or f32 on the leaves'
    device), quantizing per client and leaf. ``leaf_keys`` [n_leaves, m,
    2] replaces the keys drawn from ``key``: the pooled cohort draws them
    at the full logical width and gathers its rows, so a [k, k] sub-mix
    rounds exactly as the resident [m, m] mix does."""
    names = sorted(x)
    m = x[names[0]].shape[0]
    dev = x[names[0]].device
    Wt = _device_w(W, dev)
    keys = None
    if quant.stochastic and quant.enabled:
        keys = (_on(leaf_keys, dev, "leaf_keys") if leaf_keys is not None
                else _quant_leaf_keys(_key_on(key, dev), len(names), m))
    out = {}
    for li, name in enumerate(names):
        xl, zl = x[name], z[name]
        delta = (zl - xl).to(torch.float32)            # [m, ...]
        if quant.enabled:
            code, s = quantize_int(delta.reshape(m, -1), quant,
                                   None if keys is None else keys[li])
            q = dequantize_int(code, s).reshape(delta.shape)
        else:
            q = delta
        if quant.delta_mode == "lemma5":
            mixed = torch.tensordot(Wt, xl.to(torch.float32) + q,
                                    dims=([1], [0]))
            out[name] = mixed.to(xl.dtype)
        else:
            mixed = torch.tensordot(Wt, q, dims=([1], [0]))
            out[name] = (xl.to(torch.float32) + mixed).to(xl.dtype)
    return out


def _weighted_replica_base(X: torch.Tensor, weights: torch.Tensor,
                           src: torch.Tensor) -> torch.Tensor:
    """The ``lemma5`` base ``sum_k w[c, k] * X[src[k, c]]`` in k order
    (own replica first): X [m, per, W], weights [m, K], src [K, m]."""
    base = weights[:, 0, None, None] * X[src[0].long()]
    for j in range(1, src.shape[0]):
        base = base + weights[:, j, None, None] * X[src[j].long()]
    return base


def _live_steps(plan: GossipPlan) -> list[int]:
    """The plan steps that move anything, in order: a client's streams
    are its own, then one a live step."""
    return [k for k in range(plan.n_steps) if plan.wire_pairs(k)]


class _PlanTables:
    """A plan's streams over all m lanes: ``src`` int32 [K, m] — row 0
    the identity (a client's own stream), then one row per live plan
    step — and, for a static plan, its weights f32 [m, K].
    :meth:`weights` gathers a round's table from a sampled ``W_t`` on the
    device: column 0 ``W[c, c]``, column k ``W[c, src[k, c]]``, idle
    slots 0, the reference's ``gather_weights`` over the same live steps.
    A placed plan's lanes read the client-space ``W_t`` through
    ``lane_to_client`` at both ends."""

    def __init__(self, plan: GossipPlan, dev: torch.device):
        live = _live_steps(plan)
        ident = np.arange(plan.m)
        src = np.stack([ident] + [plan.src[k] for k in live])
        idle = np.ascontiguousarray(src.T == ident[:, None])
        idle[:, 0] = False
        self.src = torch.as_tensor(src.astype(np.int32), device=dev)
        lane = plan.lane_to_client
        # Row-major, as B2 reads the table the gather writes.
        idx = src.T if lane is None else lane[src.T]
        self._idx = torch.as_tensor(np.ascontiguousarray(idx, np.int64),
                                    device=dev)
        self._rows = (None if lane is None else
                      torch.as_tensor(lane.astype(np.int64), device=dev))
        self._idle = torch.as_tensor(idle, device=dev)
        self.static = None
        if plan.is_static:
            w_self, w_steps = plan.static_weights()
            w = np.stack([w_self] + [w_steps[k] for k in live], axis=1)
            self.static = torch.as_tensor(w.astype(np.float32), device=dev)

    def weights(self, W: torch.Tensor) -> torch.Tensor:
        if self._rows is not None:
            W = W.index_select(0, self._rows)
        return torch.where(self._idle, 0.0, W.gather(1, self._idx))


def _plan_tables(plan: GossipPlan, dev: torch.device
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A static plan's ``src`` int32 [K, m] and weights f32 [m, K]."""
    tables = _PlanTables(plan, dev)
    if tables.static is None:
        raise ValueError(f"plan {plan.name!r} has no static weights")
    return tables.src, tables.static


def _planar_delta(layout: WireLayout, x: Params, z: Params
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The planar buffer X [lanes, per, W] and the planar delta z - x
    (the leaf-dtype subtraction before the f32 cast, as in the
    reference)."""
    return (layout.to_planar_stacked(x),
            layout.to_planar_stacked({n: z[n] - x[n] for n in x}))


def _encode_lanes(layout: WireLayout, x: Params, z: Params,
                  quant: QuantConfig, keys: torch.Tensor | None):
    """The quantized wire's send side over stacked lanes: the planar
    buffer X [lanes, per, W], the delta's per-leaf scales [lanes, nl]
    and its words (one B1 launch, drawing the noise from ``keys`` [nl,
    lanes, 2] when stochastic).
    Returns (X, words, scales)."""
    X, delta = _planar_delta(layout, x, z)
    scales = layout.leaf_scales(delta, quant)
    return X, layout.encode(delta, scales, quant, keys=keys), scales


def _column_noise(layout: WireLayout, xs: list[Params],
                  keys: list[torch.Tensor], dims: dict, wire: "_Wire"
                  ) -> list[torch.Tensor]:
    """The stochastic-rounding noise of a 2D mesh's cells, planar [lanes,
    per, W] each: for every leaf (``layout`` order, which picks its key
    row) the FULL leaf's ``uniform(key[leaf, lane], (n,))`` over the m
    lanes — one T2 launch a leaf, on the first device, the keys already
    in lane order (``keys`` the cells' [n_leaves, m_local, 2], row s's
    first cell holding shard s's) — reshaped to the leaf's geometry, cut
    as the params are cut (``cut_columns``) and staged planar per cell.
    A cut leaf's element keeps the noise of its flat index in the full
    leaf, so the codes are the 1D keyed B1's position by position."""
    mp, dev0 = wire.mp, wire.devs[0]
    full = torch.cat([keys[s * mp].to(dev0) for s in range(wire.n_shards)],
                     dim=1)                                # [nl, m, 2]
    rows = [{} for _ in range(wire.n_shards)]
    for li, name in enumerate(layout.names):
        shape = list(xs[0][name].shape[1:])
        d = dims.get(name)
        if d is not None:
            shape[d - 1] *= mp
        n = int(np.prod(shape)) if shape else 1
        u = prng.uniform(full[li].contiguous(), (n,))       # [m, n]
        u = u.reshape([-1] + shape)
        for s, row in enumerate(rows):
            row[name] = u[s * wire.m_local:(s + 1) * wire.m_local]
    grid = np.array(wire.devs, dtype=object).reshape(wire.n_shards, mp)
    return [layout.to_planar_stacked(c)
            for c in cut_columns(rows, dims, grid)]


def _combine_rows(w: torch.Tensor, own: torch.Tensor, rows: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """The fp32 wire's mix over flat rows: ``w[:, 0] * own + sum_j w[:, j]
    * rows[src[j]]`` in stream order (``rows`` the table ``src`` indexes:
    the own rows, then on a mesh shard the received ones)."""
    acc = w[:, 0, None] * own
    for j in range(1, src.shape[0]):
        acc = acc + w[:, j, None] * rows[src[j].long()]
    return acc


# ---------------------------------------------------------------------------
# Lane blocks: one block a shard of a client mesh, one block on one device
# ---------------------------------------------------------------------------

def _mesh_devices(mesh) -> list[torch.device]:
    """Every cell's device, row-major (a 1D mesh: its shards')."""
    return [torch.device(d) for d in np.asarray(mesh.devices).flat]


def _mesh_grid(mesh) -> np.ndarray:
    """The mesh's devices as an [n_shards, model_parallel] object array
    (one column on a 1D mesh)."""
    devs = np.asarray(mesh.devices)
    return devs.reshape(devs.shape[0], -1)


def _model_parallel(mesh) -> int:
    return 1 if mesh is None else int(_mesh_grid(mesh).shape[1])


def _column_dims(mesh, param_specs) -> dict | None:
    """Flat name -> the stacked leaf's dim that a 2D mesh's model axis
    cuts (None: the leaf is whole on every column); None itself without
    a mesh or on a 1D one. ``param_specs`` None replicates every leaf."""
    if _model_parallel(mesh) == 1:
        return None
    from ..sharding.rules import model_sharded_dims
    return model_sharded_dims(param_specs or {}, mesh.axis_names[1])


def _any_cut(dims: dict | None) -> bool:
    return dims is not None and any(d is not None for d in dims.values())


def cut_columns(rows: list[Params], dims: dict | None, grid: np.ndarray
                ) -> list[Params]:
    """One dict a client shard -> one dict a cell of the ``[n_shards,
    mp]`` device ``grid``, row-major: cell ``(s, c)`` holds shard s's
    lanes with every leaf that ``dims`` cuts narrowed to column c's
    contiguous block (made contiguous) and every other leaf whole, on
    ``grid[s, c]``. A 1D grid (``dims`` None) returns ``rows``."""
    if dims is None:
        return rows
    mp = grid.shape[1]
    cells = []
    for s, row in enumerate(rows):
        for c in range(mp):
            cell = {}
            for n, t in row.items():
                d = dims.get(n)
                if d is not None:
                    w = t.shape[d] // mp
                    t = t.narrow(d, c * w, w)
                cell[n] = t.to(grid[s, c]).contiguous()
            cells.append(cell)
    return cells


def join_columns(cells: list[Params], dims: dict | None, grid: np.ndarray
                 ) -> list[Params]:
    """The inverse of :func:`cut_columns`: each row's cells joined into
    the shard's full lanes on its first cell's device ``grid[s, 0]`` (a
    cut leaf concatenated along its dim, a whole one taken from column
    0). A 1D grid returns ``cells``."""
    if dims is None:
        return cells
    mp = grid.shape[1]
    rows = []
    for s in range(grid.shape[0]):
        row, dev = cells[s * mp:(s + 1) * mp], grid[s, 0]
        rows.append({n: row[0][n] if dims.get(n) is None else torch.cat(
            [c[n].to(dev) for c in row], dim=dims[n]) for n in row[0]})
    return rows


def _blocks(devs: Sequence[torch.device], m: int
            ) -> list[tuple[int, int, torch.device]]:
    """(lo, hi, device) of every shard's lane block: shard s holds lanes
    ``[s * m_local, (s+1) * m_local)`` on ``devs[s]``."""
    ml = m // len(devs)
    return [(s * ml, (s + 1) * ml, d) for s, d in enumerate(devs)]


def _split_blocks(x: torch.Tensor, blocks) -> list[torch.Tensor]:
    """A lane-order [m, ...] tensor -> one piece a block (cell), on the
    block's device."""
    return [x[lo:hi].to(d) for lo, hi, d in blocks]


def split_lanes(x, devs: Sequence[torch.device]) -> list:
    """A [m, ...] tensor, or a dict of them, -> its lane blocks, one a
    shard on the shard's device (views where a shard lies on ``x``'s
    device: a caller that needs its own storage clones)."""
    if isinstance(x, dict):
        parts = {n: split_lanes(t, devs) for n, t in x.items()}
        return [{n: p[s] for n, p in parts.items()}
                for s in range(len(devs))]
    return _split_blocks(x, _blocks(devs, x.shape[0]))


def join_lanes(parts: list, dev: torch.device):
    """The inverse of :func:`split_lanes`: shards (tensors, or dicts of
    them) -> one, lane blocks in order, on ``dev``; a lone shard already
    on ``dev`` comes back as it is."""
    if isinstance(parts[0], dict):
        return {n: join_lanes([p[n] for p in parts], dev) for n in parts[0]}
    if len(parts) == 1 and parts[0].device == dev:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts])


def _shards(mesh, device, m: int, what: str
            ) -> tuple[list[torch.device], int]:
    """The devices of a realization's cells (row-major; on a 1D mesh its
    shards, one device without a mesh) and the lanes of each."""
    if mesh is None:
        return [resolve_device(device)], m
    m_local = _clients_per_shard(mesh, m)
    if m_local is None:
        raise ValueError(
            f"{what} needs a mesh carrying a client block per shard: m={m} "
            f"does not block over {_mesh_grid(mesh).shape[0]} shards")
    return _mesh_devices(mesh), m_local


def _as_shards(mesh, x) -> list:
    """A mixer's argument as shards: on one device a one-element list."""
    return x if mesh is not None else [x]


def _from_shards(mesh, xs: list):
    return xs if mesh is not None else xs[0]


class _Wire:
    """The cells an executor runs over and the transfers between them
    (none on one device). ``devs`` holds every cell's device row-major
    over ``[n_shards, mp]`` (``mp`` = 1: a 1D mesh's shards, or the one
    device); ``blocks[i]`` is cell i's ``(lo, hi, device)``: the lanes of
    its shard. ``transfers``: ``(i_src, i_dst, lanes)`` between two cells
    of one column, ``lanes`` the source's local lanes that cross, int64
    on its device; ``shipped_bytes`` the bytes of the payloads the last
    round's :func:`_exchange` sent, counted from the payloads
    themselves, and ``column_bytes`` the same bytes by column (a device
    column's wire on a 2D mesh)."""

    def __init__(self, devs: Sequence[torch.device], m_local: int,
                 mp: int = 1):
        self.devs, self.m_local, self.mp = list(devs), m_local, mp
        self.n_shards = len(self.devs) // mp
        self.blocks = [(s * m_local, (s + 1) * m_local, self.devs[s * mp + c])
                       for s in range(self.n_shards) for c in range(mp)]
        self.transfers: list = []
        self.shipped_bytes = 0
        self.column_bytes = [0] * mp


class _ShardTables(_Wire):
    """A plan's block realization over lane blocks (a client mesh's, or
    the one device's single block), built once on the host and uploaded
    once.

    For shard ``s``: ``rows[s]`` = R_s, its m_local own lanes followed
    by the boundary lanes it receives in transfer order; ``src[s]`` int32
    [K, m_local], the extended table B2 reads — row 0 the identity (own
    stream), row j the source row of live plan step j, an intra-block
    edge pointing at an own row and a crossing edge at a received row —
    so the streams combine in the reference's order whatever row a lane
    landed in; ``static[s]`` f32 [m_local, K], a static plan's weights.
    One transfer a sub-step and (src, dst) pair of the reference's
    ``BlockPlan`` ships the real lanes only (padded slots are dropped, as
    the reference drops them). On one block there is no transfer and
    ``src[0]`` is :class:`_PlanTables`'s.

    A list of plans (a cycle's members) lays every member's transfers out
    side by side, their received rows in ranges of their own: ``src[s]``
    is then [n, K, m_local] and ``static[s]`` [n, m_local, K], each member
    padded to one K (``k_pad``) with identity streams of weight 0.

    On a 2D mesh (``mp`` columns, ``devs`` its cells row-major) every
    column is a copy of the 1D realization: each shard's transfer runs
    once a column, from cell ``(s, c)`` to cell ``(s', c)``, and each
    cell holds its shard's tables (``rows``, ``src`` and ``static`` are
    indexed by cell)."""

    def __init__(self, plans: list[GossipPlan], devs: Sequence[torch.device],
                 m_local: int, k_pad: int | None = None, mp: int = 1):
        super().__init__(devs, m_local, mp)
        n_shards, ml = self.n_shards, m_local
        n_recv = [0] * n_shards
        exts, statics, moves = [], [], []
        for plan in plans:
            bp = plan.block_plan(n_shards)
            live = _live_steps(plan)
            ext = np.tile(np.arange(ml, dtype=np.int64),
                          (n_shards, len(live) + 1, 1))
            for j, k in enumerate(live, 1):
                ext[:, j] = bp.intra_src[k]
                for sub in bp.substeps[k]:
                    for s_src, s_dst in sub.pairs:
                        real = sub.recv_lanes[s_dst] < ml
                        send = sub.send_lanes[s_src][real]
                        recv = sub.recv_lanes[s_dst][real]
                        ext[s_dst, j, recv] = (ml + n_recv[s_dst]
                                               + np.arange(len(recv)))
                        n_recv[s_dst] += len(recv)
                        moves.append((s_src, s_dst, send))
            exts.append(ext)
            if plan.is_static:
                w_self, w_steps = plan.static_weights()
                statics.append(np.stack([w_self] + [w_steps[k]
                                                    for k in live], axis=1))
        self.rows = [ml + n_recv[i // mp] for i in range(len(self.devs))]
        self.lanes_moved = int(sum(len(t[2]) for t in moves))
        self.transfers = [(s_src * mp + c, s_dst * mp + c, torch.as_tensor(
            lanes.astype(np.int64), device=self.devs[s_src * mp + c]))
            for s_src, s_dst, lanes in moves for c in range(mp)]
        k_max = max([e.shape[1] for e in exts] + [k_pad or 0])
        ident = np.arange(ml, dtype=np.int64)
        src = np.stack([np.concatenate(
            [e, np.broadcast_to(ident, (n_shards, k_max - e.shape[1], ml))],
            axis=1) for e in exts], axis=1)          # [S, n, K, ml]
        for s in range(n_shards):   # the host check of B2's row bound
            if src[s].min() < 0 or src[s].max() >= ml + n_recv[s]:
                raise ValueError(f"shard {s}: a stream row outside its "
                                 f"{ml + n_recv[s]} rows")
        single = len(plans) == 1
        cells = [(i // mp, d) for i, d in enumerate(self.devs)]
        self.src = [torch.as_tensor(
            (src[s, 0] if single else src[s]).astype(np.int32), device=d)
            for s, d in cells]
        self.static = None
        if len(statics) == len(plans):
            w = np.stack([np.pad(x, ((0, 0), (0, k_max - x.shape[1])))
                          for x in statics]).astype(np.float32)  # [n, m, K]
            self.static = [torch.as_tensor(
                w[0, s * ml:(s + 1) * ml] if single
                else w[:, s * ml:(s + 1) * ml], device=d) for s, d in cells]
        # The round's weights gathered from a sampled W (one plan only).
        self._glob = _PlanTables(plans[0], self.devs[0]) if single else None

    def weights(self, W) -> list[torch.Tensor]:
        """A round's client-space ``W`` (f32 [m, m] on the first device)
        -> each cell's block of the lane-order weights table [m_local,
        K] (its shard's)."""
        return _split_blocks(self._glob.weights(_device_w(W, self.devs[0])),
                             self.blocks)


def _exchange(wire: _Wire, streams: list[list[torch.Tensor]]
              ) -> list[list[torch.Tensor]]:
    """Issue every transfer of a round: ``streams[s]`` holds shard s's
    stream as row-aligned parts ([m_local, L_i] each; int32 on the
    quantized wire: the words, the per-leaf scales' bits and, for
    ``lemma5``, the f32 replica row's bits — the reference's stream).
    Returns each shard's received rows [n, sum L_i], in its table's row
    order. A transfer gathers only its crossing lanes on the source into
    one payload and, when the shards lie on two devices, copies that
    payload once between them; ``wire.shipped_bytes`` is set to the
    payloads' bytes."""
    got: list[list[torch.Tensor]] = [[] for _ in wire.devs]
    column = [0] * wire.mp
    for s_src, s_dst, idx in wire.transfers:
        parts = [p.index_select(0, idx) for p in streams[s_src]]
        payload = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        column[s_src % wire.mp] += payload.numel() * payload.element_size()
        got[s_dst].append(payload.to(wire.devs[s_dst], non_blocking=True))
    wire.shipped_bytes, wire.column_bytes = sum(column), column
    return got


def _shard_keys(key, n_leaves: int, m: int, lane: torch.Tensor | None,
                blocks, leaf_keys: torch.Tensor | None = None
                ) -> list[torch.Tensor]:
    """The stochastic-rounding keys of every shard: drawn full width in
    client space (``_quant_leaf_keys``; ``leaf_keys`` [n_leaves, m, 2]
    replaces that draw), gathered to lane order through
    ``lane_to_client`` for a placed plan, sliced by block: [n_leaves,
    m_local, 2] each (on one block the keys themselves)."""
    keys = (_quant_leaf_keys(key, n_leaves, m) if leaf_keys is None
            else _on(leaf_keys, blocks[0][2], "leaf_keys"))
    if lane is not None:
        keys = keys.index_select(1, lane)
    return [keys[:, lo:hi].to(d).contiguous() for lo, hi, d in blocks]


def _stream_parts(words: torch.Tensor, scales: torch.Tensor,
                  X: torch.Tensor | None) -> list[torch.Tensor]:
    """One shard's wire stream as row-aligned int32 views (no copy): the
    words, the per-leaf scales' bits and, for ``lemma5``, the f32
    replica row's bits."""
    parts = [words, scales.view(torch.int32)]
    if X is not None:
        parts.append(X.reshape(X.shape[0], -1).view(torch.int32))
    return parts


def _unpack_rows(own_words, own_scales, own_X, got, layout: WireLayout):
    """A shard's R-row tables from its own rows and the streams it
    received: words [R, W], per-leaf scales [R, n_leaves] and (``lemma5``)
    replicas [R, per, W]."""
    if not got:
        return own_words, own_scales, own_X
    Wd, nl = layout.total_words, layout.n_leaves
    words = torch.cat([own_words] + [g[:, :Wd] for g in got])
    scales = torch.cat([own_scales]
                       + [g[:, Wd:Wd + nl].view(torch.float32) for g in got])
    X = None
    if own_X is not None:
        X = torch.cat([own_X.reshape(own_X.shape[0], -1)]
                      + [g[:, Wd + nl:].view(torch.float32) for g in got]
                      ).reshape(-1, layout.per, Wd)
    return words, scales, X


def _layouts(quant: QuantConfig | None) -> Callable:
    """``layout_for(x)``: the planar wire layout of a stacked dict's
    leaves (whatever its lane count), built once a leaf signature."""
    layouts: dict = {}
    bits = quant.bits if quant is not None and quant.enabled else 32

    def layout_for(x: Params) -> WireLayout:
        sig = tuple((n, tuple(x[n].shape[1:]), x[n].dtype) for n in sorted(x))
        if sig not in layouts:
            layouts[sig] = WireLayout.for_tree(x, bits, stacked=True)
        return layouts[sig]

    return layout_for


def _make_exec(wire: _Wire, m: int, quant: QuantConfig | None,
               lane: torch.Tensor | None = None,
               dims: dict | None = None) -> Callable:
    """The sparse executor over lane blocks: ``ex(xs, zs, ws, srcs, key,
    leaf_keys=None) -> xs'`` over one dict a cell (a 1D mesh's shards;
    one dict on one device), ``ws[i]`` [m_local, K] and ``srcs[i]`` the
    cell's table.
    Quantized, per shard: the planar buffer and one B1 launch over its
    lanes (drawing the noise from the full-width per-leaf keys:
    ``leaf_keys`` [n_leaves, m, 2] when given, else drawn from ``key``);
    then every transfer; then per shard one B2 launch that gathers each
    stream's words and scales through its table (own rows, then received
    ones) and decodes and applies them in stream order. The fp32 wire
    ships the f32 rows and accumulates leaf by leaf in the same order.
    Each lane's arithmetic is the same on every block layout, so a mesh's
    result is bitwise the one device's; B1 and B2 treat lanes
    independently, so a cohort's lanes under the full width's gathered
    keys give the full width's words and values.

    On a 2D mesh (``wire.mp`` columns; ``dims`` from
    :func:`_column_dims`, some leaf cut) every cell holds its model slice
    and runs the same code over it; the transfers stay within a column.
    Two fixups keep the codes the 1D layout's position by position: a
    cell's per-leaf amaxes meet their row's (a device copy each to the
    row's first cell, their max, the scales copied back: max is
    order-exact, so the scales are the 1D ones bitwise), and stochastic
    rounding takes a noise tensor (:func:`_column_noise`: each leaf's
    full draw, cut as the params are) through B1's tensor-noise entry.
    The fp32 wire, the ``lemma5`` replicas and B2 work elementwise on the
    slices as they are."""
    layout_for = _layouts(quant)
    quant_on = quant is not None and quant.enabled
    lemma5 = quant_on and quant.delta_mode == "lemma5"
    cut = _any_cut(dims)
    mp = wire.mp

    def mix_fp32(zs, ws, srcs):
        names = list(zs[0])
        rows = [[z[n].to(torch.float32).reshape(z[n].shape[0], -1)
                 for n in names] for z in zs]                # [m_local, d_l]
        got = _exchange(wire, rows)
        out = []
        for z, parts, g, w, src in zip(zs, rows, got, ws, srcs):
            res, off = {}, 0
            for n, zf in zip(names, parts):
                d = zf.shape[1]
                table = (torch.cat([zf] + [r[:, off:off + d] for r in g])
                         if g else zf)
                off += d
                acc = _combine_rows(w, zf, table, src)
                res[n] = acc.reshape(z[n].shape).to(z[n].dtype)
            out.append(res)
        return out

    def row_scales(layout: WireLayout, deltas) -> list[torch.Tensor]:
        """Each cell's per-leaf scales from its row's amaxes (their max
        on the row's first cell, copied back to the others)."""
        amax = [layout.leaf_amax(d) for d in deltas]
        out = []
        for s in range(wire.n_shards):
            row = amax[s * mp:(s + 1) * mp]
            top = row[0]
            for a in row[1:]:
                top = torch.maximum(top, a.to(top.device))
            sc = layout.scales_from_amax(top, quant)
            out += [sc.to(wire.devs[s * mp + c]) for c in range(mp)]
        return out

    def ex(xs: list[Params], zs: list[Params], ws, srcs, key,
           leaf_keys: torch.Tensor | None = None) -> list[Params]:
        if not quant_on:
            return mix_fp32(zs, ws, srcs)
        layout = layout_for(xs[0])
        keys = noise = [None] * len(xs)
        if quant.stochastic:     # B1 draws the noise from the keys
            keys = _shard_keys(
                None if leaf_keys is not None
                else _key_on(key, wire.devs[0]), layout.n_leaves, m, lane,
                wire.blocks, leaf_keys=leaf_keys)
        if quant.stochastic and cut:   # ... or takes it cut to the cells
            noise = _column_noise(layout, xs, keys, dims, wire)
            keys = [None] * len(xs)
        if cut:
            staged = [_planar_delta(layout, x, z) for x, z in zip(xs, zs)]
            deltas = [d for _, d in staged]
            scales = (row_scales(layout, deltas)
                      if quant.scale_mode != "fixed" else
                      [layout.leaf_scales(d, quant) for d in deltas])
            own = [(X, layout.encode(d, sc, quant, noise=nz), sc)
                   for (X, d), sc, nz in zip(staged, scales, noise)]
        else:
            own = [_encode_lanes(layout, x, z, quant, k)
                   for x, z, k in zip(xs, zs, keys)]
        got = _exchange(wire, [_stream_parts(w, sc, X if lemma5 else None)
                               for X, w, sc in own])
        out = []
        for (X, words, scales), g, w, src in zip(own, got, ws, srcs):
            words_r, scales_r, X_r = _unpack_rows(
                words, scales, X if lemma5 else None, g, layout)
            base = _weighted_replica_base(X_r, w, src) if lemma5 else X
            res = layout.decode_apply(base, words_r, scales_r, w, src, quant)
            out.append(layout.from_planar_stacked(res))
        return out

    return ex


def _make_plan_exec(m: int, quant: QuantConfig | None,
                    dev: torch.device) -> Callable:
    """:func:`_make_exec` on one device's m lanes: ``ex(x, z, w, src, key,
    leaf_keys=None) -> x'`` over stacked dicts, for any table ``src``
    [K, m] (the pooled cohort's, built each round)."""
    ex = _make_exec(_Wire([dev], m), m, quant)

    def one(x: Params, z: Params, w: torch.Tensor, src: torch.Tensor, key,
            leaf_keys: torch.Tensor | None = None) -> Params:
        return ex([x], [z], [w], [src], key, leaf_keys)[0]

    return one


def _lane_tensor(plan: GossipPlan, dev: torch.device):
    return (None if plan.lane_to_client is None else torch.as_tensor(
        plan.lane_to_client.astype(np.int64), device=dev))


def _refuse_placed(plan: GossipPlan, mesh) -> None:
    if mesh is None and plan.lane_to_client is not None:
        raise ValueError("a placed plan needs a client mesh (placement "
                         "relabels the lanes of shard blocks)")


def _dense_on_mesh(mixer: Callable, mesh, param_specs=None) -> Callable:
    """A one-device mixer over a mesh's lanes: gather the cells to the
    first device, mix there, hand each cell its block back (the dense
    reference's all-gather). ``mixed.tables.shipped_bytes`` counts the
    bytes of every other cell's x, z and x' that the last call moved."""
    grid = _mesh_grid(mesh)
    dims = _column_dims(mesh, param_specs)
    devs = list(grid[:, 0])
    wire = _Wire(list(grid.flat), 1, grid.shape[1])

    def whole(cells):
        return join_lanes(join_columns(cells, dims, grid), devs[0])

    def mixed(xs, zs, *args, **kw):
        out = cut_columns(split_lanes(mixer(whole(xs), whole(zs), *args,
                                            **kw), devs), dims, grid)
        # What leaves a cell other than the first and comes back to it.
        column = [0] * wire.mp
        for i in range(1, len(out)):
            column[i % wire.mp] += sum(
                t.numel() * t.element_size()
                for c in (xs[i], zs[i], out[i]) for t in c.values())
        wire.shipped_bytes, wire.column_bytes = sum(column), column
        return out

    mixed.tables = wire
    return mixed


def make_plan_mixer(plan: GossipPlan, quant: QuantConfig | None = None,
                    device=None, *, mesh=None, param_specs=None) -> Callable:
    """Static plan (baked weights) -> mixer(x, z, key=None, t=None) -> x'.

    The JAX package's sparse executor: the streams a client combines are
    its own followed by one per live plan step. Without a mesh every
    step's ``ppermute`` is an index gather on the device (inside B2 for
    the quantized wire); on a client ``mesh`` it is the block
    realization (x and z lists of shard dicts, in lane order for a placed
    plan). On a 2D ``(clients, model)`` mesh x and z are lists of cell
    dicts (``ClientMesh.shard(tree, param_specs)``) and ``param_specs``
    (flat name -> ``sharding.PartitionSpec``) says which leaves are cut
    over the model axis. ``mixer.tables`` is its :class:`_ShardTables`.
    """
    _refuse_placed(plan, mesh)
    devs, m_local = _shards(mesh, device, plan.m, "sparse mixer")
    tabs = _ShardTables([plan], devs, m_local, mp=_model_parallel(mesh))
    if tabs.static is None:
        raise ValueError(f"plan {plan.name!r} has no static weights")
    ex = _make_exec(tabs, plan.m, quant, _lane_tensor(plan, devs[0]),
                    _column_dims(mesh, param_specs))

    def mixer(x, z, key=None, t=None):
        del t
        return _from_shards(mesh, ex(_as_shards(mesh, x), _as_shards(mesh, z),
                                     tabs.static, tabs.src, key))

    mixer.tables = tabs
    return mixer


def execute_plan_reference(plan: GossipPlan, W, stacked: Params,
                           x: Params | None = None,
                           quant: QuantConfig | None = None,
                           key: torch.Tensor | None = None) -> Params:
    """The plan realization's math as one function, the JAX package's
    mesh-free ``execute_plan_reference``: the round's weights gathered
    from ``W`` (numpy, or f32 [m, m] on the leaves' device) over the
    plan's streams (own stream first, then one a live step, idle slots at
    weight 0), then the fp32 accumulation, or with ``quant`` the planar
    wire (B1 encode under ``key``'s per-leaf keys, B2 decode-apply) over
    the held state ``x``."""
    dev = next(iter(stacked.values())).device
    if quant is not None and quant.enabled and x is None:
        raise ValueError("quantized plan reference needs the held state x")
    tables = _PlanTables(plan, dev)
    ex = _make_plan_exec(plan.m, quant, dev)
    return ex(stacked if x is None else x, stacked,
              tables.weights(_device_w(W, dev)), tables.src, key)


def _gate_z(active: torch.Tensor, z: Params, x: Params) -> Params:
    """Inactive clients send nothing: their ``z`` falls back to ``x``."""
    return {n: torch.where(active.reshape((-1,) + (1,) * (z[n].dim() - 1))
                           > 0, z[n], x[n]) for n in z}


def make_event_mixer(m: int, quant: QuantConfig | None = None,
                     plan: GossipPlan | None = None, gate: bool = True,
                     device=None, *, mesh=None, param_specs=None
                     ) -> Callable:
    """Build mix_event(x, z, W, active, key=None) -> x' for a mixing
    event sampled outside the mixer: ``W`` [m, m] f32 and ``active`` [m]
    f32, both on the device (another device is refused, never copied).
    This is how a stateful walk and the compute-skip round hand the
    round's event over.

    ``plan=None`` runs the dense reference (any W); a plan (its support
    covering W's off-diagonal) runs the plan realization with the round's
    weights gathered from ``W``. ``gate=False`` skips the inactive-client
    z gate (events that never sideline a client). On a client ``mesh``, x
    and z are lists of shard dicts (of cell dicts on a 2D mesh, cut by
    ``param_specs``), ``W`` (client space) and ``active`` (lane order)
    lie on the mesh's first device, and a placed plan reads ``W`` through
    its ``lane_to_client``."""
    if plan is None:
        if mesh is not None:
            return _dense_on_mesh(make_event_mixer(
                m, quant=quant, gate=gate,
                device=_mesh_devices(mesh)[0]), mesh, param_specs)
        dev = resolve_device(device)

        def mix_dense_event(x, z, W, active, key=None):
            z_eff = _gate_z(_on(active, dev, "active"), z, x) if gate else z
            W = _device_w(W, dev)
            if quant is None or not quant.enabled:
                return mix_dense(W, z_eff)
            return _mix_dense_quantized(W, x, z_eff, quant, key)

        return mix_dense_event
    if plan.m != m:
        raise ValueError(f"plan has m={plan.m}, expected {m}")
    _refuse_placed(plan, mesh)
    devs, m_local = _shards(mesh, device, m, "sparse mixer")
    tabs = _ShardTables([plan], devs, m_local, mp=_model_parallel(mesh))
    ex = _make_exec(tabs, m, quant, _lane_tensor(plan, devs[0]),
                    _column_dims(mesh, param_specs))

    def mix_event(x, z, W, active, key=None):
        xs, zs = _as_shards(mesh, x), _as_shards(mesh, z)
        if gate:
            acts = _split_blocks(_on(active, devs[0], "active"),
                                 tabs.blocks)
            zs = [_gate_z(a, zz, xx) for a, zz, xx in zip(acts, zs, xs)]
        return _from_shards(mesh, ex(xs, zs, tabs.weights(W), tabs.src,
                                     key))

    mix_event.tables = tabs
    return mix_event


def _gate_tail(active: torch.Tensor, x: Params, y: Params, v: Params,
               g: Params) -> tuple[Params, Params, Params]:
    """Inactive clients publish ``y = x`` and apply ``v = g = 0``; v and g
    are multiplied by ``active`` (the reference's signed zeros)."""
    y = _gate_z(active, y, x)
    return y, _scale_by(v, active), _scale_by(g, active)


def _scale_by(tree: Params, active: torch.Tensor) -> Params:
    return {n: (t * active.reshape((-1,) + (1,) * (t.dim() - 1)))
            .to(t.dtype) for n, t in tree.items()}


def make_fused_tail(loss_fn: Callable, m: int, *, eta: float, theta: float,
                    quant: QuantConfig | None = None,
                    plan: GossipPlan | None = None,
                    W=None, device=None, gate: bool = False,
                    mesh=None, param_specs=None) -> Callable:
    """Fused-round tail: the round's last two local steps, the wire
    encode and the combined decode-apply — the JAX package's
    ``make_fused_tail``.

    The returned ``tail(x, y, v, g, batch_last, keys_last, key_q,
    active=None, W=None)`` consumes
    :func:`~repro_torch.core.local_sgd.local_train_deferred`'s output
    (``y``/``v``/``g`` the un-applied penultimate step, stacked over
    clients) and returns ``(x_next, y_pub, loss_last)``:

      1. SEND — ``v' = theta*v - eta*g; y' = y + v'`` and ``pack(Q(y' -
         x))`` in one pass (B4); the published z is ``y'``.
      2. The round's LAST gradient ``g_K = grad(y')``.
      3. RECEIVE — ``x' = [base + sum_k w_k*deq(stream_k)] + (theta*v' -
         eta*g_K)`` in one pass (B5), each plan step's stream gathered
         through ``src``.

    An algorithm variant: neighbours see y_{K-1}, not y_K; at ``eta ==
    0`` it equals the unfused round bitwise. ``plan=None`` is the dense
    reference (tree-level, any ``W``); a :class:`GossipPlan` runs the
    plan body (plain torch on the fp32 wire, B4 and B5 on the quantized
    wire). ``loss_last`` [m] holds the last step's losses.

    A round's own ``W`` (a schedule's ``W_t``, f32 on the device)
    replaces the ``W`` given here; on a structure-only plan it is needed,
    and its weights are gathered each round. With ``gate=True`` inactive
    clients (``active`` [m] f32) gate to ``y = x, v = g = 0`` before the
    encode, so they publish ``Q(0)``, apply a zero deferred update and
    are held exactly.

    On a client ``mesh`` x, y, v, g and the published z are lists of
    shard dicts, ``batch_last`` a list of shard batches and
    ``keys_last`` a list of shard keys; per shard B4 encodes, every
    boundary transfer is issued, then the shard's last gradient and B5
    (its own and received rows). ``loss_last`` comes back [m] on the
    first device; ``active`` lies there in lane order. Without a plan the
    dense tail runs on the gathered lanes.

    On a 2D ``(clients, model)`` mesh whose ``param_specs`` cut no leaf
    every column holds the whole model, and each column runs a copy of
    the 1D realization: x, y, v, g, ``batch_last``, ``keys_last`` and the
    results are lists of cells (row-major), each cell encodes its shard's
    lanes (B4, the shard's keys drawn as on the 1D mesh, the same in
    every column), exchanges within its column, takes the last gradient
    and decodes (B5), so every column's result is bitwise the 1D mesh's;
    ``loss_last`` comes from column 0. The plan tail repeats its work on
    every column because each column is the 1D realization on cards of
    its own: on distinct cards the columns run side by side, and a cell
    keeps its state without a copy from another column. The dense tail
    (no plan) is the reference fallback, as ``_dense_on_mesh`` is for the
    unfused mixer: it gathers column 0's lanes on the first card, runs
    once and copies its results to every column. As in the reference,
    specs that cut a leaf over the model axis are refused: the tail's
    last gradient would see one column's slice of the parameters.
    """
    if _any_cut(_column_dims(mesh, param_specs)):
        raise ValueError(
            "fuse_round is not supported with model-sharded params on a "
            "2D (clients, model) mesh: the fused tail computes the round's "
            "last gradient inside the mixer, where a cell holds only its "
            "model slice of the params. Run the unfused round "
            "(fuse_round=False), whose local step joins each shard's "
            "cells.")
    mp = _model_parallel(mesh)
    eta_f, theta_f = float(np.float32(eta)), float(np.float32(theta))
    et = (eta_f, theta_f)
    quant_on = quant is not None and quant.enabled
    lemma5 = quant_on and quant.delta_mode == "lemma5"
    layout_for = _layouts(quant)
    if plan is None:
        return _dense_fused_tail(loss_fn, quant, W, device, gate, mesh, et)
    if plan.m != m:
        raise ValueError(f"plan has m={plan.m}, expected {m}")
    _refuse_placed(plan, mesh)
    devs, m_local = _shards(mesh, device, m, "fused sparse tail")
    dev0 = devs[0]
    tabs = _ShardTables([plan], devs, m_local, mp=mp)
    lane = _lane_tensor(plan, dev0)

    def shard_weights(W):
        if W is not None:
            return tabs.weights(W)
        if tabs.static is None:
            raise ValueError(f"plan {plan.name!r} has no static weights: "
                             "pass the round's W")
        return tabs.static

    def gated(active) -> list:
        if not gate:
            return [None] * len(devs)
        if active is None:
            raise ValueError("a gated tail needs the round's active mask")
        return _split_blocks(_on(active, dev0, "active"), tabs.blocks)

    def fp32_tail(xs, ys, vs, gs, batch_last, keys_last, key_q, acts, ws):
        del key_q
        layout = layout_for(xs[0])
        staged = []
        for x, y, v, g, a in zip(xs, ys, vs, gs, acts):
            if a is not None:
                y, v, g = _gate_tail(a, x, y, v, g)
            y1, v1 = _penultimate(y, v, g, et)
            staged.append((y1, v1, layout.flatten_f32(y1)))
        got = _exchange(tabs, [[z] for _, _, z in staged])
        out, pubs, losses = [], [], []
        for (y1, v1, z), rows, w, src, bl, kl, a in zip(
                staged, got, ws, tabs.src, batch_last, keys_last, acts):
            loss_last, gK = loss_and_grad(loss_fn, y1, bl, kl)
            if a is not None:
                gK = _scale_by(gK, a)
            acc = _combine_rows(w, z, torch.cat([z] + rows) if rows else z,
                                src)
            out.append(_deferred(layout.unflatten(acc), v1, gK, et))
            pubs.append(y1)
            losses.append(loss_last)
        return out, pubs, join_lanes(losses[::mp], dev0)

    def quant_tail(xs, ys, vs, gs, batch_last, keys_last, key_q, acts, ws):
        layout = layout_for(xs[0])
        keys = [None] * len(xs)
        if quant.stochastic:     # B4 draws the noise from the keys
            keys = _shard_keys(_key_on(key_q, dev0), layout.n_leaves, m,
                               lane, tabs.blocks)
        enc = [_encode_tail(layout, x, y, v, g, a, quant, et, k)
               for x, y, v, g, a, k in zip(xs, ys, vs, gs, acts, keys)]
        got = _exchange(tabs, [_stream_parts(wd, sc, X if lemma5 else None)
                               for X, wd, sc, _, _ in enc])
        out, pubs, losses = [], [], []
        for (X, words, scales, y_out, v_out), rows, w, src, bl, kl, a in zip(
                enc, got, ws, tabs.src, batch_last, keys_last, acts):
            words_r, scales_r, X_r = _unpack_rows(
                words, scales, X if lemma5 else None, rows, layout)
            base = _weighted_replica_base(X_r, w, src) if lemma5 else X
            x_next, y_pub, loss_last = _decode_tail(
                layout, loss_fn, y_out, v_out, a, bl, kl, base, words_r,
                scales_r, w, src, quant, et)
            out.append(x_next)
            pubs.append(y_pub)
            losses.append(loss_last)
        return out, pubs, join_lanes(losses[::mp], dev0)

    body = quant_tail if quant_on else fp32_tail

    def tail(x, y, v, g, batch_last, keys_last, key_q, active=None, W=None):
        ws = shard_weights(W)
        out, pubs, loss_last = body(
            *(_as_shards(mesh, t) for t in (x, y, v, g, batch_last,
                                            keys_last)),
            key_q, gated(active), ws)
        return _from_shards(mesh, out), _from_shards(mesh, pubs), loss_last

    tail.tables = tabs
    return tail


def _penultimate(y: Params, v: Params, g: Params, et):
    v1 = {n: et[1] * v[n].to(torch.float32)
          - et[0] * g[n].to(torch.float32) for n in y}
    y1 = {n: (y[n].to(torch.float32) + v1[n]).to(y[n].dtype) for n in y}
    return y1, v1


def _deferred(mixed: Params, v1: Params, gK: Params, et) -> Params:
    return {n: (mixed[n].to(torch.float32) + et[1] * v1[n]
                - et[0] * gK[n].to(torch.float32)).to(mixed[n].dtype)
            for n in mixed}


def _dense_fused_tail(loss_fn, quant, W, device, gate, mesh, et) -> Callable:
    """:func:`make_fused_tail` without a plan: the dense reference, on the
    gathered lanes of a mesh (a 2D mesh's column 0, its results handed
    to every column)."""
    quant_on = quant is not None and quant.enabled
    grid = (_mesh_grid(mesh) if mesh is not None else
            np.array([[resolve_device(device)]], dtype=object))
    devs, mp = list(grid[:, 0]), grid.shape[1]
    dims = {} if mp > 1 else None
    dev = devs[0]
    W0 = None if W is None else _device_w(W, dev)

    def dense_tail(x, y, v, g, batch_last, keys_last, key_q, active=None,
                   W=None):
        Wr = W0 if W is None else _device_w(W, dev)
        if Wr is None:
            raise ValueError("the dense fused tail needs W")
        act = None
        if gate:
            if active is None:
                raise ValueError("a gated tail needs the round's active "
                                 "mask")
            act = _on(active, dev, "active")
            y, v, g = _gate_tail(act, x, y, v, g)
        y1, v1 = _penultimate(y, v, g, et)
        loss_last, gK = loss_and_grad(loss_fn, y1, batch_last, keys_last)
        if act is not None:
            gK = _scale_by(gK, act)
        mixed = (_mix_dense_quantized(Wr, x, y1, quant, key_q)
                 if quant_on else mix_dense(Wr, y1))
        return _deferred(mixed, v1, gK, et), y1, loss_last

    if mesh is None:
        return dense_tail

    def dense_mesh_tail(xs, ys, vs, gs, batch_last, keys_last, key_q,
                        active=None, W=None):
        x_next, y_pub, loss_last = dense_tail(
            *(join_lanes(t[::mp], dev) for t in (xs, ys, vs, gs, batch_last,
                                                 keys_last)),
            key_q, active, W)
        return (cut_columns(split_lanes(x_next, devs), dims, grid),
                cut_columns(split_lanes(y_pub, devs), dims, grid), loss_last)

    return dense_mesh_tail


def _encode_tail(layout: WireLayout, x: Params, y: Params, v: Params,
                 g: Params, act: torch.Tensor | None, quant: QuantConfig,
                 et, keys: torch.Tensor | None):
    """The fused tail's send side over stacked lanes (B4): inactive lanes
    (``act`` [lanes] f32, None for none) gated to y = x, v = g = 0, the
    scales of the resulting delta in B4's expression order, then the
    penultimate step applied and the words emitted in one pass. Returns
    (X, words, scales, y', v')."""
    X = layout.to_planar_stacked(x)                      # [lanes, per, W]
    y2d = layout.to_planar_stacked(y)
    v2d = layout.to_planar_stacked(v)
    g2d = layout.to_planar_stacked(g)
    if act is not None:
        am = act[:, None, None]
        y2d = torch.where(am > 0, y2d, X)
        v2d = v2d * am
        g2d = g2d * am
    delta = (y2d + (et[1] * v2d - et[0] * g2d)) - X
    scales = layout.leaf_scales(delta, quant)            # [lanes, nl]
    y_out, v_out, words = layout.encode_momentum(
        y2d, v2d, g2d, X, scales, et, quant, keys=keys)
    return X, words, scales, y_out, v_out


def _decode_tail(layout: WireLayout, loss_fn, y_out, v_out, act, batch,
                 keys_last, base, words, scales, w, src, quant, et):
    """The fused tail's receive side over stacked lanes: the last
    gradient at the published y' (zero on inactive lanes), then B5 mixes
    the streams of ``words``/``scales`` (the rows ``src`` indexes) onto
    ``base`` and applies the deferred step. Returns (x', y', losses)."""
    y_pub = layout.from_planar_stacked(y_out)
    loss_last, gK = loss_and_grad(loss_fn, y_pub, batch, keys_last)
    gK2d = layout.to_planar_stacked(gK)
    if act is not None:
        gK2d = gK2d * act[:, None, None]
    out = layout.decode_apply_momentum(base, words, scales, w, src, v_out,
                                       gK2d, et, quant)
    return layout.from_planar_stacked(out), y_pub, loss_last


def _make_cycle_mixer(schedule: TopologySchedule, quant: QuantConfig | None,
                      dev: torch.device, mesh=None,
                      placement=None, param_specs=None) -> Callable:
    """The plan realization of a cycle: each member's static plan (its
    own support, baked weights), their tables stacked and padded to the
    largest K with identity streams of weight 0 (after the member's own
    streams, so its combination order is its plan's), and the member
    picked by ``t mod n`` — a host int, or a device tensor in a captured
    round: one graph holds every member, where the reference switches
    between per-member programs.

    On a client mesh (members placed alike when ``placement`` is given)
    a host-int round runs its member's own transfers only, as the
    reference's switch does; a device-tensor round (a captured graph)
    issues every member's transfers, each into rows of its own, and reads
    only its member's rows, so the result is the same."""
    plans = schedule.gossip_plans()
    if placement is not None:
        plans = [p.placed(placement) for p in plans]
    m = schedule.m
    ones = schedule.tables(dev)["ones"]
    n = len(plans)
    devs, m_local = _shards(mesh, dev, m, "sparse mixer")
    mp, dims = _model_parallel(mesh), _column_dims(mesh, param_specs)
    k_max = max(len(_live_steps(p)) + 1 for p in plans)
    union = _ShardTables(plans, devs, m_local, mp=mp)
    lane = _lane_tensor(plans[0], devs[0])
    ex_union = _make_exec(union, m, quant, lane, dims)
    each = ex_each = None
    if union.transfers:
        each = [_ShardTables([p], devs, m_local, k_pad=k_max, mp=mp)
                for p in plans]
        ex_each = [_make_exec(t, m, quant, lane, dims) for t in each]

    def mixer(x, z, key, t):
        xs, zs = _as_shards(mesh, x), _as_shards(mesh, z)
        if each is None or isinstance(t, torch.Tensor):
            out = ex_union(xs, zs, [_at(w, t, n) for w in union.static],
                           [_at(s, t, n) for s in union.src], key)
        else:
            i = int(t) % n
            out = ex_each[i](xs, zs, each[i].static, each[i].src, key)
        return _from_shards(mesh, out), ones

    mixer.tables = union
    return mixer


def _schedule_plan(schedule: TopologySchedule, cfg: MixerConfig, mesh=None
                   ) -> GossipPlan | None:
    """The support plan a schedule's rounds run on (impl ``"sparse"``,
    which ``"auto"`` picks), or None for the dense reference."""
    if cfg.impl not in ("auto", "dense", "sparse"):
        raise ValueError("time-varying schedules support impl 'dense', "
                         f"'sparse' or 'auto', got impl={cfg.impl!r}")
    return (schedule.gossip_plan()
            if cfg.resolved_impl(schedule, mesh) == "sparse" else None)


def make_scheduled_mixer(schedule: TopologySchedule, cfg: MixerConfig,
                         device=None, *, mesh=None,
                         placement=None, param_specs=None) -> Callable:
    """Build mixer(x, z, key, t) -> (x', active) for a time-varying
    topology: ``(W_t, active, key_q) = schedule.round_event(key, t)`` on
    the device, inactive clients' z gated back to x, then gossip with
    W_t through the chosen backend (``dense``, or ``sparse``: the support
    plan with the round's weights gathered from W_t; ``auto`` is
    ``sparse``). ``key`` lies on the device; ``t`` is the round, a host
    int or a 0-dim device tensor. The schedule's tables go to the device
    here, once.

    On a client ``mesh`` x and z are lists of shard dicts (cell dicts on
    a 2D mesh, cut by ``param_specs``) and the device is the mesh's
    first. ``placement`` (a ``gossip_plan.Placement``,
    sparse only) runs the support plan placed: client state lives in lane
    order, so the schedule's client-order ``active`` is gathered to lane
    order, for the gate and in the returned pair.

    As in the reference, the ``eq7`` recursion is only stable for PSD
    W_t, which a sampled Metropolis W_t need not be: prefer ``lemma5``.
    """
    dev = (_mesh_devices(mesh)[0] if mesh is not None
           else resolve_device(device))
    schedule.tables(dev)
    plan = _schedule_plan(schedule, cfg, mesh)
    if placement is not None and plan is None:
        impl = cfg.resolved_impl(schedule, mesh)
        raise ValueError(f"placement requires the sparse backend, got "
                         f"impl={impl!r}")
    if placement is not None and mesh is None:
        raise ValueError("placement needs a usable client mesh (the dense "
                         "fallback has no lanes to place)")
    if plan is not None and schedule.kind == "cycle":
        return _make_cycle_mixer(schedule, cfg.quant, dev, mesh=mesh,
                                 placement=placement,
                                 param_specs=param_specs)
    if plan is not None and placement is not None:
        plan = plan.placed(placement)
    ev = make_event_mixer(schedule.m, quant=cfg.quant, plan=plan,
                          gate=schedule.gates_participation, device=dev,
                          mesh=mesh, param_specs=param_specs)
    perm = (None if placement is None or placement.is_identity else
            torch.as_tensor(placement.perm.astype(np.int64), device=dev))

    def mixer(x, z, key: torch.Tensor, t):
        W_t, active, key_q = schedule.round_event(_key_on(key, dev), t)
        if perm is not None:
            active = active[perm]
        return ev(x, z, W_t, active, key_q), active

    mixer.tables = getattr(ev, "tables", None)
    return mixer


def make_mixer(spec: MixingSpec | TopologySchedule, cfg: MixerConfig,
               device=None, *, mesh=None, placement=None,
               param_specs=None) -> Callable:
    """Return mixer(x_stacked, z_stacked, key=None, t=None) -> x_next for
    a static spec. Without a mesh the one device is a one-shard client
    mesh: ``"auto"`` on a ring (a torus) resolves to ``"ring"``
    (``"torus"``), the plan realization; ``"dense"`` stays available as
    the second oracle.

    On a client ``mesh`` (x and z lists of shard dicts) the sparse impls
    run the block realization, and ``placement`` (from
    ``compute_placement``, sparse impls only) runs the plan placed, with
    the callers holding state in lane order. As in the reference, a
    sparse impl on a mesh that does not fit raises, but an explicit
    quantized torus falls back to the dense reference with a warning.

    On a 2D ``(clients, model)`` mesh x and z are lists of cell dicts
    and ``param_specs`` (flat name -> ``sharding.PartitionSpec``) says
    which leaves the model axis cuts (:func:`make_plan_mixer`).

    A :class:`TopologySchedule` returns the time-varying mixer(x, z, key,
    t) -> (x', active) of :func:`make_scheduled_mixer`."""
    if isinstance(spec, TopologySchedule):
        return make_scheduled_mixer(spec, cfg, device=device, mesh=mesh,
                                    placement=placement,
                                    param_specs=param_specs)
    if not isinstance(spec, MixingSpec):
        raise TypeError(f"expected a MixingSpec or a TopologySchedule, got "
                        f"{type(spec).__name__}")
    impl = cfg.resolved_impl(spec, mesh)
    quant = cfg.quant
    if placement is not None and impl not in ("ring", "torus", "sparse"):
        raise ValueError(
            f"placement requires a sparse backend, got impl={impl!r}")
    if impl == "ring" and spec.kind == "torus":
        impl = "torus"   # the reference's alias: ring impl on a torus
    if impl in ("ring", "torus", "sparse"):
        if mesh is not None and _clients_per_shard(mesh, spec.m) is None:
            if placement is not None:
                raise ValueError(
                    "placement needs a usable client mesh (the dense "
                    f"fallback has no lanes to place): m={spec.m}")
            if impl == "torus" and quant is not None and quant.enabled:
                warnings.warn(
                    "quantized torus mixer without a usable client mesh "
                    "falls back to the DENSE reference path (all-gather "
                    "traffic, not 4 transfers); pass a mesh whose shards "
                    "divide m (a client block per shard) for the sparse "
                    "backend", UserWarning, stacklevel=2)
                Wq = _device_w(spec.W, _mesh_devices(mesh)[0])

                def mixer(x, z, key=None, t=None):
                    return _mix_dense_quantized(Wq, x, z, quant, key)
                return mixer
            raise ValueError(
                f"mixer impl {impl!r} needs a mesh with one client block "
                f"per shard (m={spec.m}, "
                f"{np.asarray(mesh.devices).size} shards)")
        if placement is not None and mesh is None:
            raise ValueError("placement needs a usable client mesh (the "
                             "dense fallback has no lanes to place)")
        if impl != "sparse" and spec.kind != impl:
            raise ValueError(f"{impl} mixer needs a {impl} MixingSpec, got "
                             f"kind={spec.kind!r}")
        plan = spec.gossip_plan()
        if placement is not None:
            plan = plan.placed(placement)
        return make_plan_mixer(plan, quant, device=device, mesh=mesh,
                               param_specs=param_specs)
    if mesh is not None:
        return _dense_on_mesh(make_mixer(spec, MixerConfig("dense", quant),
                                         device=_mesh_devices(mesh)[0]),
                              mesh, param_specs)
    Wt = _device_w(spec.W, resolve_device(device))   # once, not per round
    if quant is None or not quant.enabled:
        def mixer(x, z, key=None, t=None):
            del x, key, t
            return mix_dense(Wt, z)
        return mixer

    def mixer(x, z, key=None, t=None):
        del t
        return _mix_dense_quantized(Wt, x, z, quant, key)
    return mixer


def consensus_distance(stacked: Params | list[Params]) -> torch.Tensor:
    """(1/m) sum_i ||x(i) - xbar||^2 — Lemma 4's left-hand side, summed
    over leaves in sorted-key order.

    On a client mesh (a list of shard dicts) no shard's lanes leave it:
    each shard's f32 lane sum (one model-sized row) goes to the first
    shard's device, the mean comes back to every shard, and only the
    shards' scalar sums of squares meet again, as the reference's
    sharded mean lowers to an all-reduce of partial sums. It agrees with
    the one-device value to f32 rounding (the sums are grouped by
    shard), not bitwise; one shard is the one-device computation."""
    if isinstance(stacked, list) and len(stacked) == 1:
        stacked = stacked[0]
    if isinstance(stacked, dict):
        total = None
        for name in sorted(stacked):
            z = stacked[name]
            zb = z.mean(dim=0, keepdim=True)
            d = ((z.to(torch.float32) - zb) ** 2).sum() / z.shape[0]
            total = d if total is None else total + d
        return total
    dev0 = next(iter(stacked[0].values())).device
    m = sum(next(iter(s.values())).shape[0] for s in stacked)
    total = None
    for name in sorted(stacked[0]):
        parts = [s[name] for s in stacked]
        lane_sum = join_lanes([p.to(torch.float32).sum(dim=0, keepdim=True)
                               for p in parts], dev0).sum(dim=0,
                                                          keepdim=True)
        zb = (lane_sum / m).to(parts[0].dtype)
        sq = join_lanes([((p.to(torch.float32) - zb.to(p.device)) ** 2)
                         .sum().reshape(1) for p in parts], dev0).sum()
        d = sq / m
        total = d if total is None else total + d
    return total
