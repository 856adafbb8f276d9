"""DFedAvgM (Algorithm 1) and quantized DFedAvgM (Algorithm 2) — the
synchronous round of the JAX package's ``core/dfedavgm.py`` for a static
``MixingSpec`` or a time-varying ``TopologySchedule``, unfused or fused
(``DFedAvgMConfig.fuse_round``).

One communication round:

  1. every client i runs K heavy-ball SGD steps from x^t(i)   (local_sgd)
  2. unquantized: send z^t(i) = y^{t,K}(i); x^{t+1} = W z^t    (eq. 5)
     quantized:   send q^t(i) = Q(y^{t,K}(i) - x^t(i)) and mix (eq. 7,
                  or the Lemma-5 recursion)

Client copies are stacked on a leading axis of size m. The PRNG chain is
the JAX one: ``split(state.rng, 3)`` gives the round, mixing and next
keys, and ``split(key_round, m)`` the client keys. The key lives on the
parameters' device, so the chain runs there and a round copies nothing
from the host (``core.compiled`` captures it in one CUDA graph).

A schedule's round samples its event ``(W_t, active)`` on the device from
the mixing key and the round index (a host int, or in a captured round a
0-dim device tensor); a stateful walk also carries its token in
``RoundState.token``. With a statically bounded active count the round
trains only the active lanes (``skip_inactive_compute``): a fixed-size
gather and a scatter into an [m + 1] buffer whose last row takes the
padded slots, with no host sync.

On a 1D client mesh (``mesh=``, a ``launch.mesh.ClientMesh``) the
parameters are a list of dicts, one a shard (``mesh.shard``): local SGD
runs per shard on its device with the same ``local_train`` (B3 one launch
a step a shard, a compute-skip round gathering each shard's active lanes),
the client keys come from the full-width split sliced by block, and the
mixer is the block realization (``core.mixing``). With a ``placement``
the state is in lane order: each round gathers the batches, the client
keys and a schedule's active mask through ``placement.perm``, so placed
training is bitwise unplaced training with its lanes permuted.

On a 2D ``(clients, model)`` mesh (``param_specs``) the state is a list
of cells. A loss with a column-parallel form whose form covers every
cut leaf (``models.model.make_loss`` for every registered arch,
``models.paper_nets.make_2nn_loss``) trains each shard's row of cells
tensor-parallel (``sharding.tensor_parallel``), as the reference's
GSPMD partitions its step; any other loss joins each shard's cells into
its full lanes on its column-0 device and runs the 1D ``local_train``
there, bitwise the 1D mesh's round (``make_round_step``).

On a ``launch.mesh.ServeMesh`` of ``("data", "model")`` cells
(:func:`make_cells_round_step`: the reference's strategies B, B2 and B3
on one pod, ``launch.build``'s train step) the state is one dict a cell,
every cell holding both clients' blocks of each leaf as the strategy's
specs cut it. Local SGD runs every cell (``local_sgd.local_train_rows``),
the fp32 dense mix runs on each cell with no transfer, the key chain
once on the first cell's device, and the metrics meet as partial sums
over the cells.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from .. import prng
from ..device import resolve_device
from ..sharding.tensor_parallel import ColumnGroup, local_step_kind
from .comm_cost import dfedavgm_round_bits, schedule_round_bits
from .local_sgd import (local_train, local_train_deferred, local_train_rows,
                        rows_loss_and_grad)
from .mixing import (MixerConfig, _clients_per_shard, _column_dims,
                     _deferred, _gate_z, _mesh_devices, _mesh_grid,
                     _penultimate, _quant_leaf_keys,
                     _schedule_plan, _split_blocks, check_wire,
                     consensus_distance, consensus_distance_cells,
                     cut_columns, join_columns, join_lanes,
                     make_cells_mixer, make_event_mixer, make_fused_tail,
                     make_mixer, make_plan_mixer, split_lanes)
from .quantize import QuantConfig
from .topology import MixingSpec, TopologySchedule

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]

__all__ = ["DFedAvgMConfig", "RoundState", "init_round_state",
           "make_round_step", "make_cells_round_step", "average_params",
           "round_comm_bits"]


@dataclasses.dataclass(frozen=True)
class DFedAvgMConfig:
    """Hyper-parameters of Algorithms 1/2.

    eta:   local learning rate
    theta: heavy-ball momentum in [0, 1)
    local_steps: K — local iterations per communication round
    quant: None -> Algorithm 1; QuantConfig -> Algorithm 2
    mixer_impl: "auto" | "dense" | "ring" | "torus" | "sparse" (see
           MixerConfig)
    wire:  "auto" | "seq" | "planar", the reference's codec choice (see
           MixerConfig: every value runs the same kernels)
    fuse_round: the fused round (``core.mixing.make_fused_tail``): the
           last two local steps fold into the wire encode (B4) and decode
           (B5) kernels. An algorithm variant — neighbours see y_{K-1},
           not y_K — equal to the default round only at ``eta == 0``.
           Needs ``local_steps >= 2``; refuses stateful schedules and
           compute-skip gathers.
    """

    eta: float = 0.01
    theta: float = 0.9
    local_steps: int = 4
    quant: QuantConfig | None = None
    mixer_impl: str = "auto"
    wire: str = "auto"
    fuse_round: bool = False

    def __post_init__(self):
        check_wire(self.wire)

    def mixer_config(self) -> MixerConfig:
        return MixerConfig(impl=self.mixer_impl, quant=self.quant,
                           wire=self.wire)


class RoundState(NamedTuple):
    """Carried state of the synchronous round loop: stacked client
    params (a list of shard dicts on a client mesh), the key chain, the
    round counter and, for a stateful schedule, the walk token."""

    params: Params        # stacked client copies, leaves [m, ...]
    rng: torch.Tensor     # round-level key, int64 [2], on the params' device
    round: int            # a host int (a 0-dim device tensor when captured)
    token: torch.Tensor | None = None   # stateful walk: int64 0-dim


def init_round_state(params_stacked: Params | list[Params],
                     key: torch.Tensor, token: torch.Tensor | None = None,
                     mesh=None, param_specs=None) -> RoundState:
    """The round loop's first state; the key (and a stateful schedule's
    ``token``, ``schedule.init_token()``) move to the parameters' device,
    where the whole key chain then runs. On a client mesh the parameters
    are a list of shard dicts (or a stacked dict that ``mesh`` shards
    here, in lane order; on a 2D mesh into cells, cut by
    ``param_specs``) and the key chain runs on the first cell's
    device."""
    if mesh is not None and isinstance(params_stacked, dict):
        params_stacked = mesh.shard(params_stacked, param_specs)
    dev = _params_device(params_stacked)
    return RoundState(params=params_stacked, rng=key.to(dev), round=0,
                      token=None if token is None else token.to(dev))


def _params_device(params: Params | list[Params]) -> torch.device:
    """The device of the parameters (of the first shard on a mesh)."""
    first = params[0] if isinstance(params, list) else params
    return next(iter(first.values())).device


def average_params(stacked: Params | list[Params]) -> Params:
    """Consensus/average model xbar = (1/m) sum_i x(i) (shards gathered
    to the first shard's device)."""
    if isinstance(stacked, list):
        stacked = join_lanes(stacked, _params_device(stacked))
    return {n: z.to(torch.float32).mean(dim=0).to(z.dtype)
            for n, z in stacked.items()}


def _placed_boundary_lane_slots(plan, mesh) -> float | None:
    """Wire lane slots of ``plan``'s block realization on this mesh — the
    telemetry's ``placement_boundary_lanes`` (None without a mesh that
    fits)."""
    m_local = _clients_per_shard(mesh, plan.m)
    if m_local is None:
        return None
    return float(plan.block_plan(plan.m // m_local).num_wire_lane_slots)


class _Lanes:
    """How a round's client-indexed inputs reach the lanes: on one device
    as they are; on a client mesh gathered to lane order through
    ``placement.perm`` and cut into the shards' blocks
    (``core.mixing.split_lanes``). Every table is on the device from the
    step's build.

    On a 2D mesh the state is a list of cells (``mp`` a shard) and
    ``local_step`` says how a shard trains them
    (``sharding.tensor_parallel.local_step_kind``). ``"tensor_parallel"``
    (a loss whose column-parallel form covers every cut leaf):
    :meth:`train_rows` hands each shard its row of cells, ``local_train``
    runs on the row's :class:`ColumnGroup`, z stays in cells and the
    metrics meet as partial sums over the cells. ``"joined"`` (any other
    loss): ``rows`` joins each shard's cells on its first column's
    device, where local SGD runs and the metrics meet as on the 1D mesh,
    and ``cells`` cuts a shard-level result back for the mixer
    (``cut_columns``). On a 1D mesh (``"whole"``) both hand their
    argument through. ``blocks`` holds every cell's ``(lo, hi, device)``
    lane block, row-major (``_split_blocks``)."""

    def __init__(self, mesh, m: int, placement, dev: torch.device,
                 param_specs=None, loss_fn=None):
        self.devs = None
        self.grid = self.dims = self.blocks = None
        self.mp = 1
        self.groups = None
        if mesh is not None:
            self.grid = _mesh_grid(mesh)
            self.devs = list(self.grid[:, 0])
            self.mp = int(self.grid.shape[1])
            self.dims = _column_dims(mesh, param_specs)
            ml = m // len(self.devs)
            self.blocks = [(s * ml, (s + 1) * ml, d)
                           for s, row in enumerate(self.grid) for d in row]
        self.local_step = local_step_kind(loss_fn, self.dims)
        if self.tp:
            self.groups = [ColumnGroup(row, self.dims) for row in self.grid]
        self.perm = (None if placement is None or placement.is_identity
                     else torch.as_tensor(placement.perm.astype(np.int64),
                                          device=dev))
        self.dev = dev

    @property
    def tp(self) -> bool:
        return self.local_step == "tensor_parallel"

    def rows(self, params) -> list[Params]:
        """The state's parameters as one dict a shard (a one-element list
        on one device)."""
        return join_columns(self.shards(params), self.dims, self.grid)

    def cells(self, rows: list[Params]):
        """Shard dicts -> the state's layout: cells on a 2D mesh, the
        list on a 1D one, the one dict on one device."""
        return self.join(cut_columns(rows, self.dims, self.grid))

    def train_rows(self, params) -> list:
        """What each shard's local step trains: its row of cells on the
        tensor-parallel step, else its (joined) lanes."""
        if self.tp:
            return [params[s * self.mp:(s + 1) * self.mp]
                    for s in range(len(self.devs))]
        return self.rows(params)

    def trained(self, zs: list):
        """The shards' local-step results -> the state's layout."""
        if self.tp:
            return [c for row in zs for c in row]
        return self.cells(zs)

    def train(self, loss_fn, s: int, x, batches: Params, keys, *, eta,
              theta: float):
        """``local_train`` of shard s (its row's group on the
        tensor-parallel step)."""
        return local_train(loss_fn, x, batches, keys, eta=eta, theta=theta,
                           group=None if self.groups is None
                           else self.groups[s])

    def consensus(self, params) -> torch.Tensor:
        """``consensus_distance`` of a state-layout tree: per cell on the
        tensor-parallel step, else on the joined rows."""
        if self.tp:
            return consensus_distance(params, dims=self.dims, mp=self.mp)
        return consensus_distance(self.join(self.rows(params)))

    def order(self, t: torch.Tensor) -> torch.Tensor:
        """A client-order [m, ...] tensor in lane order."""
        return t if self.perm is None else t[self.perm]

    def split(self, x) -> list:
        """A [m, ...] tensor or a dict of them -> one a shard."""
        return [x] if self.devs is None else split_lanes(x, self.devs)

    def shards(self, params) -> list[Params]:
        return params if self.devs is not None else [params]

    def join(self, shards: list[Params]):
        return shards if self.devs is not None else shards[0]

    def cat(self, parts: list[torch.Tensor]) -> torch.Tensor:
        return join_lanes(parts, self.dev)

    def gate(self, active: torch.Tensor, z, x):
        """``_gate_z`` over the lanes (lane-order ``active`` on the first
        device), shard by shard."""
        return self.join([_gate_z(a, zz, xx) for a, zz, xx in zip(
            self.split(active), self.shards(z), self.shards(x))])


def round_comm_bits(spec: MixingSpec | TopologySchedule, n_params: int,
                    quant: QuantConfig | None, t: int | None = None,
                    plan=None) -> float:
    """Bits moved on the graph in ONE round (paper §3.2 accounting):
    every participating client sends its (possibly quantized) message
    across each live directed edge. A schedule bills the expectation over
    its sampled edges (exact for the deterministic kinds; ``t`` picks a
    cycle's round). ``plan`` does not change the bill."""
    del plan
    if isinstance(spec, TopologySchedule):
        return schedule_round_bits(spec, n_params, quant, t)
    return dfedavgm_round_bits(spec.graph, n_params, quant)


def _check_spec(spec) -> bool:
    """Whether ``spec`` is a schedule (True) or a static spec (False)."""
    if isinstance(spec, TopologySchedule):
        return True
    if not isinstance(spec, MixingSpec):
        raise TypeError(f"expected a MixingSpec or a TopologySchedule, got "
                        f"{type(spec).__name__}")
    return False


def _weighted_mean(losses: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The mean of ``losses`` over the lanes ``w`` marks (at least 1)."""
    return (losses * w).sum() / torch.clamp(w.sum(), min=1.0)


def _active_lanes(active: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``nonzero(active, size=k, fill_value=m)`` without a
    host sync: a stable sort puts the active lanes first, in order; slots
    past the round's active count get the index m. Returns (idx [k], safe
    [k] = min(idx, m - 1), valid [k] f32)."""
    m = active.shape[0]
    order = torch.sort((active == 0).to(torch.int32), stable=True).indices
    first = order[:k]
    idx = torch.where(active[first] != 0, first, m)
    return idx, torch.clamp(idx, max=m - 1), (idx < m).to(torch.float32)


def make_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                    spec: MixingSpec | TopologySchedule,
                    *, device=None, with_metrics: bool = True,
                    with_telemetry: bool = False,
                    skip_inactive_compute: bool | str = "auto",
                    async_cfg=None, placement=None,
                    mesh=None, param_specs=None) -> Callable:
    """Build round_step(state, batches) -> (state', metrics).

    ``batches``: dict with leaves [m, K, ...] on ``device`` (client
    order; on a client mesh on its first device). ``loss_fn`` (params,
    batch, rng) returns the per-client losses [m]. ``device``
    defaults to CUDA; pass ``"cpu"`` to run the plain versions of the
    kernels on the CPU. Metrics are 0-dim tensors on the device: ``loss``
    (mean over the participating clients of the mean local loss), and
    with ``with_metrics`` ``consensus_dist`` of x^{t+1}, ``local_drift``
    of z^t and, for a schedule, ``active_frac``.

    ``with_telemetry`` adds ``metrics["telemetry"]``, a
    :class:`~repro_torch.telemetry.Telemetry` of device tensors computed
    inside the round (inside its graph when captured): consensus and
    drift, the round's live edges and wire bits (of W_t on a schedule),
    and on a quantized wire the quantizer's observed error, its
    Assumption-4 bound and saturated share, replayed over
    ``QUANT_SAMPLE_LANES`` strided lanes (weighted by ``active`` on a
    gated schedule; the fused round leaves these three None); on a client
    mesh also ``placement_boundary_lanes``, the block realization's wire
    lane slots. The parameters are bitwise those of the step built
    without it. The stages carry ``torch.profiler`` ranges:
    ``round/local_sgd``, ``round/mix``, ``round/telemetry``.

    ``spec`` may be a :class:`TopologySchedule`: the round index picks
    the event, inactive clients are held exactly, and a stateful walk
    threads its token (``init_round_state(..., token=spec.init_token())``).
    ``skip_inactive_compute``: with a statically bounded active count
    (``partial(exact=True)``, ``partial(cap_slack=...)``, walks) the round
    trains only those lanes and scatters them back; ``"auto"`` does so
    whenever the bound is below m, True insists, False keeps the full
    width. Parameters and ``loss`` are the same either way;
    ``local_drift`` then counts only the effective z (with skip off it
    includes inactive lanes' discarded updates). On a mesh each shard
    trains its own active lanes, at most ``min(bound, m_local)``.

    ``mesh`` (a 1D client mesh) runs the round on its shards: the state
    is a list of shard dicts (``init_round_state(..., mesh=mesh)``).
    ``placement`` (a ``gossip_plan.Placement``, sparse impls on a mesh
    only) runs the plan placed: the state is in lane order, each round's
    batches, client keys and active mask are gathered through
    ``placement.perm``. Metrics need no shard's lanes elsewhere:
    consensus and drift meet as partial sums (``consensus_distance``) and
    the telemetry's quantizer replay runs on each shard's sampled lanes.

    On a 2D ``(clients, model)`` mesh the state is a list of cells cut
    by ``param_specs`` (flat name -> ``sharding.PartitionSpec``;
    ``init_round_state(..., mesh=mesh, param_specs=specs)``). The
    reference leaves its local step there to GSPMD's partitioner. The
    port's step is ``round_step.local_step``:

    * ``"tensor_parallel"`` when ``loss_fn`` carries a column-parallel
      form covering every cut leaf (``models.model.make_loss`` for every
      registered arch, ``models.paper_nets.make_2nn_loss``): each
      shard's row of cells trains on its own slices (``local_train(...,
      group=)``; B3 once a step a cell), z goes to the mixer as cells,
      and ``consensus_dist`` and ``local_drift`` meet as partial sums
      over the cells. Row- and column-parallel sums change float order,
      so the round is within rounding of the 1D mesh's, not bitwise.
    * ``"joined"`` for any other loss (an opaque callable, or a cut a
      form declines; ``make_loss``'s takes every cut the rules make, an
      SSM inner dim cut across heads included): a shard's local SGD
      joins its cells into its full lanes on column 0's device, runs the 1D
      ``local_train`` there (B3 once a step), and cuts z back into the
      cells; the round and its metrics are bitwise the 1D mesh's, but the
      working set is a shard's full lanes on column 0.

    Either way the mixer's wire, scales and noise keep the 1D codes, the
    telemetry's quantizer replay reads joined rows, and its
    ``wire_bits`` is the per-column bill (``model_parallel`` = mp). Off a
    2D mesh ``local_step`` is ``"whole"``. The fused round refuses
    model-sharded specs; with specs that cut no leaf (or none) each
    column runs the 1D fused tail on the whole model
    (``make_fused_tail``).

    ``async_cfg`` (an :class:`~repro_torch.core.async_gossip.AsyncConfig`)
    returns the async engine's event step instead
    (``make_async_round_step``, on an ``AsyncRoundState``).
    """
    scheduled = _check_spec(spec)
    if placement is not None and async_cfg is not None:
        raise ValueError("placement is not supported with the async "
                         "engine (its lane bookkeeping is client-order)")
    if async_cfg is not None:
        from .async_gossip import make_async_round_step
        return make_async_round_step(loss_fn, cfg, spec, async_cfg,
                                     device=device,
                                     with_metrics=with_metrics,
                                     with_telemetry=with_telemetry,
                                     mesh=mesh, param_specs=param_specs)
    if placement is not None and mesh is None:
        raise ValueError("placement needs a usable client mesh (the lanes "
                         "it relabels are a mesh's shard blocks)")
    if cfg.fuse_round:
        return _make_fused_round_step(
            loss_fn, cfg, spec, device=device, with_metrics=with_metrics,
            with_telemetry=with_telemetry,
            skip_inactive_compute=skip_inactive_compute,
            placement=placement, mesh=mesh, param_specs=param_specs)
    m = spec.m
    dev = (_mesh_devices(mesh)[0] if mesh is not None
           else resolve_device(device))
    lanes = _Lanes(mesh, m, placement, dev, param_specs, loss_fn)
    stateful = scheduled and spec.is_stateful
    k_active = spec.static_active_count if scheduled else None
    if skip_inactive_compute == "auto":
        skip = k_active is not None and k_active < m
    else:
        skip = bool(skip_inactive_compute)
        if skip and k_active is None:
            raise ValueError(
                "skip_inactive_compute=True needs a schedule with a "
                "statically bounded per-round active count "
                "(partial(..., exact=True), partial(..., cap_slack=...) "
                "or random_walk); got "
                f"{getattr(spec, 'name', spec)!r}")
        skip = skip and k_active < m
    mcfg = cfg.mixer_config()
    plan = _schedule_plan(spec, mcfg, mesh) if scheduled else None
    if plan is not None and placement is not None:
        plan = plan.placed(placement)
    if placement is not None and scheduled and plan is None:
        impl = mcfg.resolved_impl(spec, mesh)
        raise ValueError(f"placement requires the sparse backend, got "
                         f"impl={impl!r}")
    # Telemetry reads the round's W_t and quantizer key: the round draws
    # its event and hands it to the event mixer (the scheduled mixer's own
    # two halves, so the parameters are bitwise the same), one draw. A
    # cycle on its plans keeps its mixer; its event is an index, no draw.
    event_first = stateful or skip or (
        scheduled and with_telemetry
        and not (spec.kind == "cycle" and plan is not None))
    if event_first:
        # The event is sampled before local training (it gates compute)
        # and handed to the event mixer: one draw a round.
        spec.tables(dev)
        event_mixer = make_event_mixer(
            m, quant=cfg.quant, plan=plan,
            gate=stateful or spec.gates_participation, device=dev,
            mesh=mesh, param_specs=param_specs)
    else:
        mixer = make_mixer(spec, mcfg, device=dev, placement=placement,
                           mesh=mesh, param_specs=param_specs)
    if with_telemetry:
        tel = _telemetry_parts(spec, cfg, m, dev, lanes=lanes,
                               boundary=_boundary_lanes(
                                   spec, mcfg, placement, mesh))

    def round_step(state: RoundState, batches: Params):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = lanes.order(prng.split(key_round, m))
        if lanes.perm is not None:
            batches = {n: lanes.order(b) for n, b in batches.items()}
        token_next = state.token
        active = None
        if stateful:
            if state.token is None:
                raise ValueError(
                    "stateful schedule: seed the walk with "
                    "init_round_state(..., token=spec.init_token())")
            W_t, active, key_q, token_next = spec.token_event(key_mix,
                                                              state.token)
        elif event_first:
            W_t, active, key_q = spec.round_event(key_mix, state.round)
        elif scheduled and with_telemetry:
            W_t, _, key_q = spec.round_event(key_mix, state.round)
        if active is not None:
            active = lanes.order(active)
        xs = lanes.train_rows(state.params)
        with record_function("round/local_sgd"):
            zs, losses, valid = [], [], []
            acts = lanes.split(active) if skip else [None] * len(xs)
            for s, (x, b, k, a) in enumerate(zip(
                    xs, lanes.split(batches), lanes.split(client_keys),
                    acts)):
                train = functools.partial(lanes.train, loss_fn, s,
                                          theta=cfg.theta)
                if skip:
                    z, loss, ok, _ = _train_active(train, x, b, k, a,
                                                   k_active, cfg.eta)
                    valid.append(ok)
                else:
                    z, loss = train(x, b, k, eta=cfg.eta)
                zs.append(z)
                losses.append(loss)
            losses = lanes.cat(losses)
            z_cells = lanes.trained(zs)
        with record_function("round/mix"):
            if event_first:
                x_next = event_mixer(state.params, z_cells, W_t, active,
                                     key_q)
            elif scheduled:
                x_next, active = mixer(state.params, z_cells, key_mix,
                                       state.round)
            else:
                x_next = mixer(state.params, z_cells, key_mix, state.round)
        if skip:
            metrics = {"loss": _weighted_mean(losses, lanes.cat(valid))}
        elif scheduled and spec.gates_participation:
            metrics = {"loss": _weighted_mean(losses, active)}
        else:
            metrics = {"loss": losses.mean()}
        if with_metrics and scheduled:
            metrics["active_frac"] = active.mean()
        if with_metrics or with_telemetry:
            cdist = lanes.consensus(x_next)
            drift = (lanes.consensus(z_cells) if lanes.tp
                     else consensus_distance(lanes.join(zs)))
        if with_metrics:
            metrics["consensus_dist"] = cdist
            metrics["local_drift"] = drift
        if with_telemetry:
            with record_function("round/telemetry"):
                # The quantizer replay reads whole rows: the
                # tensor-parallel step joins them here, for it alone.
                x_rows = lanes.join(lanes.rows(state.params) if lanes.tp
                                    else xs)
                z = lanes.join(lanes.rows(z_cells) if lanes.tp else zs)
                # The effective published z the codec saw: inactive lanes
                # gate to x (the compute-skip scatter already holds them
                # at x); the replay averages over participating lanes.
                z_eff, lane_w = z, None
                if scheduled and spec.gates_participation:
                    lane_w = active
                    if not skip:
                        z_eff = lanes.gate(active, z, x_rows)
                metrics["telemetry"] = tel(
                    x_rows, z_eff, cdist, drift,
                    W_t if scheduled else None,
                    key_q if scheduled else key_mix, lane_w)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1, token=token_next), metrics

    round_step.local_step = lanes.local_step
    return round_step


_POD_FUSED_REFUSAL = (
    "fuse_round is not supported with model-sharded params on a 2D "
    "(clients, model) mesh: the fused tail computes the round's last "
    "gradient INSIDE the client shard_map body, which would see only "
    "this device's model slice of the params. Run the unfused round "
    "(fuse_round=False) — its local SGD runs outside the mixer under "
    "GSPMD, which partitions the loss over the model axis automatically.")


def make_cells_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                          spec: MixingSpec, mesh, param_specs: dict, *,
                          batch_axes: tuple = (), routing=None) -> Callable:
    """Build round_step(state, batches) -> (state', metrics) on the cells
    of a ``launch.mesh.ServeMesh`` (module docstring): ``state.params``
    one dict a cell (``mesh.shard(stacked, param_specs)``), row-major,
    its key on the first cell's device; ``batches`` leaves [m, K, b, ...]
    whole, cut over ``batch_axes`` by the rows (``local_train_rows``,
    which takes ``routing``). The key chain is :func:`make_round_step`'s
    (the mixing key feeds a quantized wire).

    On one pod (``("data", "model")``: every cell all m clients' blocks)
    the mix is the dense one on each cell (``make_cells_mixer``: fp32, or
    the reference's quantized dense mix), and ``cfg.fuse_round`` runs the
    reference's dense fused tail per cell: K-2 steps and step K-2's
    gradient (``local_train_rows(..., deferred=True)``), the penultimate
    update, the last gradient at y' from the rows
    (``rows_loss_and_grad``), the mix of y', then the deferred update.
    On the pod mesh (``("pod", "data", "model")``: a pod's clients on its
    cells) each pod trains its own clients and the ring gossips over
    ``"pod"`` through the plan realization (``make_plan_mixer`` on the
    mesh: a pod's cells its columns, fp32 rows or B1 / B2 with the
    pod's amax and the cut noise), or, with ``mixer_impl="dense"``, the
    dense mix runs on every cell over the pods' blocks of its position
    (``make_cells_mixer``); the fused round is refused there, as the
    reference refuses it.
    Metrics as :func:`make_round_step`'s: ``loss`` the mean over the
    clients, ``consensus_dist`` and ``local_drift`` from the cells'
    partial sums (``consensus_distance_cells``)."""
    m = spec.m
    pods = mesh.n_pods > 1
    if pods and cfg.fuse_round:
        raise ValueError(_POD_FUSED_REFUSAL)
    if cfg.fuse_round and cfg.local_steps < 2:
        raise ValueError(
            f"fuse_round needs local_steps >= 2 (one step is deferred "
            f"past the mix), got {cfg.local_steps}")
    impl = (cfg.mixer_config().resolved_impl(spec, mesh) if pods
            else "dense")
    if impl == "dense":
        mix = make_cells_mixer(spec, mesh, param_specs, cfg.quant)
    elif impl in ("ring", "sparse") and spec.kind == "ring":
        mix = make_plan_mixer(spec.gossip_plan(), cfg.quant, mesh=mesh,
                              param_specs=param_specs)
    else:
        raise ValueError(f"the pod mesh gossips a ring over 'pod' (mixer "
                         f"'ring') or mixes densely (mixer 'dense'), got "
                         f"{impl!r} on {spec.kind!r}")
    et = (float(np.float32(cfg.eta)), float(np.float32(cfg.theta)))

    def unfused(state, batches, client_keys, key_mix):
        with record_function("round/local_sgd"):
            z, losses = local_train_rows(
                loss_fn, mesh, state.params, param_specs, batches,
                client_keys, eta=cfg.eta, theta=cfg.theta,
                batch_axes=batch_axes, routing=routing)
        with record_function("round/mix"):
            x_next = mix(state.params, z, key_mix)
        return x_next, z, losses

    def fused(state, batches, client_keys, key_mix):
        K = next(iter(batches.values())).shape[1]
        with record_function("round/local_sgd"):
            y, v, g, head = local_train_rows(
                loss_fn, mesh, state.params, param_specs, batches,
                client_keys, eta=cfg.eta, theta=cfg.theta, deferred=True,
                batch_axes=batch_axes, routing=routing)
            y1, v1 = map(list, zip(*(_penultimate(*a, et)
                                     for a in zip(y, v, g))))
            last, gK = rows_loss_and_grad(
                loss_fn, mesh, y1, param_specs,
                {n: b[:, K - 1] for n, b in batches.items()},
                prng.split(client_keys, K)[:, K - 1], batch_axes=batch_axes,
                routing=routing)
        with record_function("round/mix"):
            mixed = mix(state.params, y1, key_mix)
            x_next = [_deferred(*a, et) for a in zip(mixed, v1, gK)]
        losses = torch.cat([head, last[:, None]], dim=1).mean(dim=1)
        return x_next, y1, losses

    body = fused if cfg.fuse_round else unfused

    def round_step(state: RoundState, batches: Params):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = prng.split(key_round, m)
        x_next, z, losses = body(state, batches, client_keys, key_mix)
        metrics = {"loss": losses.mean(),
                   "consensus_dist": consensus_distance_cells(
                       x_next, mesh, param_specs),
                   "local_drift": consensus_distance_cells(
                       z, mesh, param_specs)}
        return RoundState(params=type(state.params)(x_next), rng=key_next,
                          round=state.round + 1), metrics

    round_step.local_step = "cells"
    return round_step


def _train_active(train: Callable, x, batches: Params, keys: torch.Tensor,
                  active: torch.Tensor, k_active: int, eta):
    """The compute-skip local step of one shard (or the one device): train
    the first ``min(k_active, lanes)`` active lanes (a fixed-size gather;
    ``eta`` a float or a per-lane [lanes] tensor; ``train(x, batches,
    keys, eta=) -> (z, losses)``), then scatter them back; inactive lanes
    keep x as their z, padded slots (index ``lanes``) land in a spare
    last row that is dropped. ``x`` is a dict, or a shard's row of cells
    (each gathered and scattered on its own device). Returns (z, losses
    of the slots, valid slots f32, the slots' lanes)."""
    m = active.shape[0]
    idx, safe, valid = _active_lanes(active, min(k_active, m))
    cells = x if isinstance(x, list) else [x]
    on = [next(iter(c.values())).device for c in cells]
    sub = [{n: p[safe.to(d)] for n, p in c.items()}
           for c, d in zip(cells, on)]
    z_sub, losses = train(
        sub if isinstance(x, list) else sub[0],
        {n: b[safe] for n, b in batches.items()}, keys[safe],
        eta=eta[safe] if isinstance(eta, torch.Tensor) else eta)
    z = []
    for c, zc, d in zip(cells, z_sub if isinstance(x, list) else [z_sub],
                        on):
        out, ix = {}, idx.to(d)
        for n, xl in c.items():
            buf = torch.cat([xl, xl[-1:]])
            out[n] = buf.index_copy_(0, ix, zc[n])[:m]
        z.append(out)
    return (z if isinstance(x, list) else z[0]), losses, valid, idx


def _boundary_lanes(spec, mcfg: MixerConfig, placement, mesh
                    ) -> float | None:
    """The telemetry's ``placement_boundary_lanes``: the wire lane slots of
    the (placed) plan's block realization on this mesh, for a sparse impl
    other than a cycle's switch; None without a mesh."""
    if mesh is None:
        return None
    impl = mcfg.resolved_impl(spec, mesh)
    if impl not in ("ring", "torus", "sparse") or (
            isinstance(spec, TopologySchedule) and spec.kind == "cycle"):
        return None
    plan = spec.gossip_plan()
    if placement is not None:
        plan = plan.placed(placement)
    return _placed_boundary_lane_slots(plan, mesh)


def _telemetry_parts(spec, cfg: DFedAvgMConfig, m: int, dev: torch.device,
                     replay: bool = True, lanes: _Lanes | None = None,
                     boundary: float | None = None) -> Callable:
    """The round's telemetry, built with the step: ``tel(x, z_eff, cdist,
    drift, W_t, key_q, lane_w) -> Telemetry`` over stacked dicts (a
    mesh's lists of shard dicts, in lane order: each shard replays its
    own sampled lanes; a 2D mesh's joined rows, its wire bits the
    per-column bill). Its constants live on the device from the start
    (a static spec's live-edge count, the strided lane sample of the
    quantizer replay, a mesh's boundary lane slots), so a captured round
    reads them and copies nothing from the host. ``W_t`` None means the
    static spec's graph; ``replay=False`` (the fused round) leaves the
    quantizer fields None. A placed run replays lane p with client
    ``perm[p]``'s keys, as the wire draws them."""
    from ..telemetry.metrics import (QUANT_SAMPLE_LANES, Telemetry,
                                     client_dim, live_edge_count,
                                     quant_round_telemetry, sample_lane_ids,
                                     shard_sample_ids, wire_bits_for)
    static_live = None
    if not isinstance(spec, TopologySchedule):
        static_live = torch.full((), float(spec.graph.num_directed_edges()),
                                 dtype=torch.float32, device=dev)
    quant_on = replay and cfg.quant is not None and cfg.quant.enabled
    lane_ids = None
    if quant_on:
        lane_ids = (sample_lane_ids(m, QUANT_SAMPLE_LANES, dev)
                    if lanes is None or lanes.devs is None else
                    shard_sample_ids(m, QUANT_SAMPLE_LANES, lanes.devs))
    pbl = (None if boundary is None else
           torch.full((), boundary, dtype=torch.float32, device=dev))
    perm = None if lanes is None else lanes.perm

    mp = 1 if lanes is None else lanes.mp

    def tel(x, z_eff, cdist, drift, W_t, key_q, lane_w):
        first = x[0] if isinstance(x, list) else x
        live = static_live if W_t is None else live_edge_count(W_t)
        fields = dict(consensus_dist=cdist, local_drift=drift,
                      live_edges=live,
                      wire_bits=wire_bits_for(client_dim(first), cfg.quant,
                                              live, model_parallel=mp))
        if pbl is not None:
            fields["placement_boundary_lanes"] = pbl
        if quant_on:
            leaf_keys = None
            if perm is not None and cfg.quant.stochastic:
                leaf_keys = _quant_leaf_keys(key_q, len(first), m)[:, perm]
            qe, qb, qs = quant_round_telemetry(
                x, z_eff, cfg.quant, key_q, leaf_keys=leaf_keys,
                lane_weight=lane_w, sample_lanes=lane_ids)
            fields.update(quant_err_sq=qe, quant_bound=qb,
                          quant_sat_frac=qs)
        return Telemetry(**fields)

    return tel


def _make_fused_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                           spec: MixingSpec | TopologySchedule, *,
                           device=None, with_metrics: bool = True,
                           with_telemetry: bool = False,
                           skip_inactive_compute: bool | str = "auto",
                           placement=None, mesh=None,
                           param_specs=None) -> Callable:
    """The ``cfg.fuse_round`` realization of :func:`make_round_step`: K-2
    local steps (``local_train_deferred``), then the fused tail
    (``core.mixing.make_fused_tail``) — penultimate update + encode in
    one pass (B4), the last gradient, mix + deferred last update in one
    pass (B5). Same ``round_step(state, batches)`` contract and PRNG
    chain; the ``loss`` metric averages the same K per-step losses and
    ``local_drift`` is taken of the published z = y_{K-1}. Not
    bit-compatible with the unfused round except at ``eta == 0``. A
    schedule runs at full width (no compute-skip) with its event's W_t
    and active mask; a cycle takes the dense tail, as in the reference.
    On a client mesh the head runs per shard and the tail is the block
    realization's (placed as :func:`make_round_step` describes)."""
    scheduled = _check_spec(spec)
    if scheduled and spec.is_stateful:
        raise ValueError("fuse_round does not support stateful schedules "
                         "(the walk token gates compute mid-round)")
    if skip_inactive_compute is True:
        raise ValueError("fuse_round runs the full-width client vmap; "
                         "skip_inactive_compute=True is incompatible")
    if cfg.local_steps < 2:
        raise ValueError(
            f"fuse_round needs local_steps >= 2 (one step is deferred "
            f"past the mix), got {cfg.local_steps}")
    m = spec.m
    dev = (_mesh_devices(mesh)[0] if mesh is not None
           else resolve_device(device))
    lanes = _Lanes(mesh, m, placement, dev, param_specs)
    impl = cfg.mixer_config().resolved_impl(spec, mesh)
    if impl == "ring" and not scheduled and spec.kind not in ("ring",
                                                              "torus"):
        raise ValueError(f"ring mixer needs a ring MixingSpec, got "
                         f"kind={spec.kind!r}")
    sparse = impl in ("ring", "torus", "sparse") and not (
        scheduled and spec.kind == "cycle")
    plan = spec.gossip_plan() if sparse else None
    if placement is not None:
        if plan is None:
            raise ValueError("placement requires the sparse backend, "
                             f"got impl={impl!r}")
        plan = plan.placed(placement)
    if scheduled:
        spec.tables(dev)
    gate = scheduled and spec.gates_participation
    tail = make_fused_tail(loss_fn, m, eta=cfg.eta, theta=cfg.theta,
                           quant=cfg.quant, plan=plan,
                           W=None if scheduled else spec.W, device=dev,
                           gate=gate, mesh=mesh, param_specs=param_specs)
    if with_telemetry:
        # No quantizer fields: the fused tail's wire delta (y' - x, formed
        # inside B4) never exists as a tensor to replay against.
        tel = _telemetry_parts(
            spec, cfg, m, dev, replay=False, lanes=lanes,
            boundary=None if plan is None else _placed_boundary_lane_slots(
                plan, mesh))

    def round_step(state: RoundState, batches: Params):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = lanes.order(prng.split(key_round, m))
        if lanes.perm is not None:
            batches = {n: lanes.order(b) for n, b in batches.items()}
        K = next(iter(batches.values())).shape[1]
        step_keys = prng.split(client_keys, K)           # [m, K, 2], once
        x_rows = lanes.rows(state.params)
        heads = [local_train_deferred(loss_fn, x, b, k, eta=cfg.eta,
                                      theta=cfg.theta)
                 for x, b, k in zip(x_rows, lanes.split(batches),
                                    lanes.split(step_keys))]
        y, v, g = (lanes.cells([h[i] for h in heads]) for i in range(3))
        losses_head = lanes.cat([h[3] for h in heads])   # [m, K-1]
        batch_last = {n: b[:, K - 1] for n, b in batches.items()}
        keys_last = step_keys[:, K - 1]
        if mesh is not None:
            batch_last = cut_columns(lanes.split(batch_last), lanes.dims,
                                     lanes.grid)
            keys_last = _split_blocks(keys_last, lanes.blocks)
        if scheduled:
            W_t, active, key_q = spec.round_event(key_mix, state.round)
            active = lanes.order(active)
            x_next, y_pub, loss_last = tail(state.params, y, v, g,
                                            batch_last, keys_last, key_q,
                                            active, W_t)
        else:
            x_next, y_pub, loss_last = tail(state.params, y, v, g,
                                            batch_last, keys_last, key_mix)
        losses = torch.cat([losses_head, loss_last[:, None]],
                           dim=1).mean(dim=1)
        metrics = {"loss": _weighted_mean(losses, active) if gate
                   else losses.mean()}
        if with_metrics and scheduled:
            metrics["active_frac"] = active.mean()
        if with_metrics or with_telemetry:
            cdist = consensus_distance(lanes.join(lanes.rows(x_next)))
            drift = consensus_distance(lanes.join(lanes.rows(y_pub)))
        if with_metrics:
            metrics["consensus_dist"] = cdist
            metrics["local_drift"] = drift
        if with_telemetry:
            with record_function("round/telemetry"):
                metrics["telemetry"] = tel(lanes.join(x_rows), None,
                                           cdist, drift,
                                           W_t if scheduled else None,
                                           None, None)
        return RoundState(params=x_next, rng=key_next,
                          round=state.round + 1, token=state.token), metrics

    round_step.local_step = lanes.local_step
    return round_step
