"""Event-driven asynchronous DFedAvgM with staleness-aware mixing — the
port of the JAX package's ``core/async_gossip.py``.

The synchronous round puts a barrier between local SGD and gossip, so a
round costs the fleet its slowest client. Here every client draws its
compute duration from a :class:`~repro_torch.core.event_clock.SpeedModel`
and finishes local SGD on its own virtual clock; an *event* fires when
the earliest clients finish, and they mix at once with their neighbours'
currently published parameters. A neighbour lagging ``s = version[i] -
version[j]`` local rounds is discounted by ``rho(s)`` (``1/(1+s)`` or
``gamma^s``, zero beyond ``max_staleness``), the removed mass folded into
the self weight (:func:`staleness_weights`).

One event is one :func:`make_async_round_step` call, on the parameters'
device with no host sync: the event queue is the per-client next-ready
vector of :class:`AsyncRoundState`, the keys are T1 splits, the clock's
durations one T4 normal draw, local SGD one B3 launch a step (the lane
entry when the decayed eta is a per-client vector), the mix the event
mixer (the plan realization: B1, B2) with weights gathered from the
event's ``W_eff``. :func:`make_async_engine` runs a queue of events — the
reference's ``lax.scan`` — one step (or, captured, one CUDA graph replay)
an event.

Under a constant speed model every client fires every event, no
staleness develops, and the engine reproduces the synchronous
``make_round_step`` bit for bit (same key chain, ``W_eff == W``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

from .. import prng
from ..device import resolve_device
from .dfedavgm import (DFedAvgMConfig, _active_lanes, _check_spec, _Lanes,
                       _params_device, _train_active)
from .event_clock import SpeedModel, next_event
from .local_sgd import local_train
from .mixing import _mesh_devices, consensus_distance, make_event_mixer
from .topology import MixingSpec, TopologySchedule

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]

__all__ = ["AsyncConfig", "AsyncRoundState", "init_async_state",
           "staleness_weights", "staleness_eta", "make_async_round_step",
           "make_async_engine"]

# Salt folded into the model key to derive the clock's key chain ("asyc").
_CLOCK_SALT = 0x61737963


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Asynchronous-engine knobs (the algorithm's stay in
    :class:`~repro_torch.core.dfedavgm.DFedAvgMConfig`).

    speed:         per-client compute-duration distribution.
    max_staleness: neighbours more than this many local rounds behind get
                   weight 0 (their mass folds into the self weight).
    discount:      rho(s): "inverse" -> 1/(1+s), "power" -> gamma**s.
    gamma:         base of the "power" discount.
    eta_staleness_decay:
                   client i trains with ``eta / (1 + decay * lag_i)``,
                   ``lag_i = max_j version[j] - version[i]`` (0 disables;
                   zero lag scales by exactly 1). The per-client eta is a
                   device vector that B3's lane entry reads.
    ready_capacity:
                   train at most this many ready lanes an event (a
                   gather, then a scatter back); ready lanes past it are
                   deferred to the next, zero-duration event. None trains
                   every lane.
    """

    speed: SpeedModel = SpeedModel.constant()
    max_staleness: int = 8
    discount: str = "inverse"   # inverse | power
    gamma: float = 0.5
    eta_staleness_decay: float = 0.0
    ready_capacity: int | None = None

    def __post_init__(self):
        if self.discount not in ("inverse", "power"):
            raise ValueError(f"unknown staleness discount "
                             f"{self.discount!r}; allowed: inverse | power")
        if self.max_staleness < 0:
            raise ValueError("max_staleness must be >= 0")
        if not 0.0 < self.gamma <= 1.0:
            raise ValueError("need 0 < gamma <= 1")
        if self.eta_staleness_decay < 0.0:
            raise ValueError("need eta_staleness_decay >= 0")
        if self.ready_capacity is not None and self.ready_capacity < 1:
            raise ValueError("need ready_capacity >= 1 (or None)")


class AsyncRoundState(NamedTuple):
    """``RoundState`` extended with the event clock, every field on the
    parameters' device. ``round`` counts events (int32, 0-dim)."""

    params: Params             # stacked client copies, leaves [m, ...]
    rng: torch.Tensor          # the model's key chain, int64 [2]
    round: torch.Tensor        # int32 event counter
    clock: torch.Tensor        # f32, virtual time of the last event
    next_ready: torch.Tensor   # [m] f32, each client's finish time
    version: torch.Tensor      # [m] int32, completed local rounds
    clock_rng: torch.Tensor    # the durations' key chain, int64 [2]


def init_async_state(params_stacked: Params | list[Params],
                     key: torch.Tensor, speed: SpeedModel,
                     mesh=None, param_specs=None) -> AsyncRoundState:
    """``key`` seeds the model chain as ``init_round_state`` does (so a
    constant-speed run is the synchronous run from the same key); the
    clock chain is ``split(fold_in(key, "asyc"))``. On a client mesh the
    parameters are a list of shard dicts (or a stacked dict ``mesh``
    shards here; cells cut by ``param_specs`` on a 2D mesh) and the
    clock lives on the first cell's device."""
    if mesh is not None and isinstance(params_stacked, dict):
        params_stacked = mesh.shard(params_stacked, param_specs)
    shards = (params_stacked if isinstance(params_stacked, list)
              else [params_stacked])
    dev = _params_device(params_stacked)
    mp = 1 if mesh is None else mesh.model_parallel
    m = sum(next(iter(s.values())).shape[0] for s in shards) // mp
    key = key.to(dev)
    k_dur, clock_rng = prng.split(prng.fold_in(key, _CLOCK_SALT))
    return AsyncRoundState(
        params=params_stacked, rng=key,
        round=torch.zeros((), dtype=torch.int32, device=dev),
        clock=torch.zeros((), dtype=torch.float32, device=dev),
        next_ready=speed.draw(k_dur, m),
        version=torch.zeros(m, dtype=torch.int32, device=dev),
        clock_rng=clock_rng)


def _discount(s: torch.Tensor, cfg: AsyncConfig) -> torch.Tensor:
    sf = s.to(torch.float32)
    rho = (1.0 / (1.0 + sf) if cfg.discount == "inverse"
           else torch.pow(cfg.gamma, sf))
    return torch.where(s <= cfg.max_staleness, rho, 0.0)


def staleness_weights(W: torch.Tensor, version: torch.Tensor,
                      ready: torch.Tensor, cfg: AsyncConfig
                      ) -> torch.Tensor:
    """The event matrix ``W_eff`` from a base mixing matrix ``W`` (f32 [m,
    m] on the device). A ready row i keeps ``W[i, j] * rho(s_ij)`` off the
    diagonal, ``s_ij = max(version[i] - version[j], 0)``, and takes the
    removed mass on its diagonal (``W - removed + diag(removed.sum(1))``,
    the reference's expression: with no stale neighbour it is ``W`` bit
    for bit); a busy row is ``e_i``. Row-stochastic, support inside
    ``W``'s, not symmetric."""
    m = W.shape[0]
    eye = torch.eye(m, dtype=torch.float32, device=W.device)
    s = torch.clamp(version[:, None] - version[None, :], min=0)
    removed = W * (1.0 - eye) * (1.0 - _discount(s, cfg))
    W_eff = W - removed + torch.diag(removed.sum(dim=1))
    return torch.where(ready[:, None] > 0, W_eff, eye)


def staleness_eta(eta: float, version: torch.Tensor,
                  decay: float) -> torch.Tensor:
    """Per-client local rate [m] f32: ``eta / (1 + decay * lag_i)``,
    ``lag_i = max_j version[j] - version[i]``; a true f32 division (a
    scalar over a tensor would be a reciprocal multiply in torch), so zero
    lag gives ``eta`` exactly."""
    lag = (version.max() - version).to(torch.float32)
    return torch.div(torch.full_like(lag, eta), 1.0 + decay * lag)


def make_async_round_step(loss_fn: LossFn, cfg: DFedAvgMConfig,
                          spec: MixingSpec | TopologySchedule,
                          async_cfg: AsyncConfig, *, device=None,
                          with_metrics: bool = True,
                          with_telemetry: bool = False,
                          batch_fn: Callable | None = None,
                          mesh=None, param_specs=None) -> Callable:
    """Build event_step(state: AsyncRoundState, batches) -> (state',
    metrics): ONE event of the asynchronous engine, on ``device`` (CUDA
    unless ``"cpu"``), or on a client ``mesh`` (the parameters a list
    of shard dicts; the clock, versions and metrics on the first shard's
    device; each shard trains its lanes, and with ``ready_capacity`` the
    first ``ready_capacity`` ready lanes of the whole mesh, each shard
    those of its block). On a 2D mesh the parameters are cells cut by
    ``param_specs``, and an event trains as the synchronous round does
    there (``make_round_step``): tensor-parallel on each shard's row of
    cells for a loss with a column-parallel form that takes every cut
    leaf (``models.model.make_loss``, the 2NN's), else each shard's
    cells joined on its column-0 device and z cut back for the mixer;
    ``event_step.local_step`` says which.

    ``batches`` has the synchronous layout (leaves [m, K, ...]). Every
    lane trains each event and the ready mask picks whose fresh ``z``
    enters the mix; ``AsyncConfig.ready_capacity`` trains only the first
    ``ready_capacity`` ready lanes instead. ``spec`` is a static
    :class:`MixingSpec` or a schedule without state (the event counter
    drives it; its active mask composes with the ready mask). The mixer
    is the reference's: the plan realization when the impl resolves to
    ring, torus or sparse (``"auto"`` does on every graph but a complete
    one), with the weights gathered from ``W_eff``, else dense.
    ``cfg.fuse_round`` is ignored, as in the reference: an event trains
    through ``local_train``.

    ``batch_fn(client_ids [m] int32, versions [m] int32) -> batches`` (on
    the device): the step then ignores ``batches`` and keys each
    client's data on its own pre-event version, so the data a client sees
    does not depend on how the events interleave.

    Metrics (0-dim device tensors): ``loss`` over the clients whose clock
    fired, ``clock``, ``ready_frac``, ``live_edges`` and, with
    ``with_metrics``, ``mean_staleness``, ``max_staleness`` and
    ``consensus_dist``.

    ``with_telemetry`` adds ``metrics["telemetry"]``, a
    :class:`~repro_torch.telemetry.Telemetry`: consensus and drift, the
    event's live and wire bits, the staleness histogram over the
    post-event versions, the edges the hard cutoff dropped and, on a
    quantized wire, the quantizer replay over every lane weighted by the
    lanes that published — all on the device, inside the event's graph
    when captured.
    """
    scheduled = _check_spec(spec)
    if scheduled and spec.is_stateful:
        raise ValueError("async gossip needs a data-independent schedule; "
                         "use random_walk(stateful=False) whose path does "
                         "not depend on the event clock")
    m = spec.m
    dev = (_mesh_devices(mesh)[0] if mesh is not None
           else resolve_device(device))
    lanes = _Lanes(mesh, m, None, dev, param_specs, loss_fn)
    impl = cfg.mixer_config().resolved_impl(spec, mesh)
    plan = spec.gossip_plan() if impl in ("ring", "torus", "sparse") else None
    ev = make_event_mixer(m, quant=cfg.quant, plan=plan, gate=True,
                          device=dev, mesh=mesh, param_specs=param_specs)
    if scheduled:
        spec.tables(dev)
        W_static = None
    else:
        W_static = torch.as_tensor(spec.W, dtype=torch.float32, device=dev)
    speed = async_cfg.speed
    if not speed.is_constant:
        speed.multipliers_on(m, dev)
    decay = async_cfg.eta_staleness_decay
    cap = async_cfg.ready_capacity
    skip = cap is not None and cap < m
    client_ids = torch.arange(m, dtype=torch.int32, device=dev)
    off_diag = 1.0 - torch.eye(m, dtype=torch.float32, device=dev)
    quant_on = cfg.quant is not None and cfg.quant.enabled
    if with_telemetry:
        from ..telemetry.metrics import (Telemetry, client_dim,
                                         dropped_edge_count,
                                         quant_round_telemetry,
                                         staleness_histogram, wire_bits_for)

    def event_step(state: AsyncRoundState, batches: Params | None = None):
        key_round, key_mix, key_next = prng.split(state.rng, 3)
        client_keys = prng.split(key_round, m)
        if batch_fn is not None:
            batches = batch_fn(client_ids, state.version)
        elif batches is None:
            raise ValueError("event_step needs batches (or build the step "
                             "with a version-keyed batch_fn)")
        t_now, ready = next_event(state.next_ready)
        eta = (staleness_eta(cfg.eta, state.version, decay) if decay > 0.0
               else cfg.eta)
        xs = lanes.train_rows(state.params)
        if skip and mesh is not None:
            z, losses, ready = _train_ready_shards(
                loss_fn, cfg, lanes, xs, batches, client_keys,
                ready, eta, cap)
        elif skip:
            # Train the first `cap` ready lanes; the padded slots (index m)
            # land in the spare last row of each scatter and are dropped.
            # Ready lanes past the capacity keep their clocks (`ready` is
            # clamped below) and fire in the next, zero-duration event.
            idx, safe, valid = _active_lanes(ready, cap)
            z_sub, losses_sub = local_train(
                loss_fn, {n: p[safe] for n, p in state.params.items()},
                {n: b[safe] for n, b in batches.items()}, client_keys[safe],
                eta=eta[safe] if decay > 0.0 else eta, theta=cfg.theta)
            z = {}
            for n, xl in state.params.items():
                buf = torch.cat([xl, xl[-1:]])
                z[n] = buf.index_copy_(0, idx, z_sub[n])[:m]
            spare = ready.new_zeros(m + 1)
            losses = spare.index_copy(0, idx, losses_sub * valid)[:m]
            ready = ready * spare.index_copy(0, idx, valid)[:m]
        elif mesh is not None:
            etas = (lanes.split(eta) if decay > 0.0
                    else [eta] * len(xs))
            out = [lanes.train(loss_fn, s, x, b, k, eta=e, theta=cfg.theta)
                   for s, (x, b, k, e) in enumerate(zip(
                       xs, lanes.split(batches), lanes.split(client_keys),
                       etas))]
            z = [o[0] for o in out]
            losses = lanes.cat([o[1] for o in out])
        else:
            z, losses = local_train(loss_fn, state.params, batches,
                                    client_keys, eta=eta, theta=cfg.theta)
        z_cells = lanes.trained(lanes.shards(z))

        if scheduled:
            W_t, active, key_q = spec.round_event(key_mix, state.round)
            ready_eff = ready * active
        else:
            W_t, key_q, ready_eff = W_static, key_mix, ready
        version_next = state.version + ready_eff.to(torch.int32)
        W_eff = staleness_weights(W_t, version_next, ready_eff, async_cfg)
        x_next = ev(state.params, z_cells, W_eff, ready_eff, key_q)

        k_dur, clock_rng = prng.split(state.clock_rng)
        durations = speed.draw(k_dur, m)
        next_ready = torch.where(ready > 0, t_now + durations,
                                 state.next_ready)
        # Over the clients whose clocks fired (at least one), not
        # ready_eff, which a schedule can leave empty.
        metrics = {"loss": (losses * ready).sum() / ready.sum(),
                   "clock": t_now, "ready_frac": ready_eff.mean(),
                   "live_edges": ((W_eff * off_diag) != 0.0).sum()}
        if with_metrics or with_telemetry:
            cdist = lanes.consensus(x_next)
        if with_metrics:
            lag = version_next.max() - version_next
            metrics["mean_staleness"] = lag.to(torch.float32).mean()
            metrics["max_staleness"] = lag.max()
            metrics["consensus_dist"] = cdist
        if with_telemetry:
            with record_function("round/telemetry"):
                if lanes.tp:
                    # The quantizer replay reads whole rows: the
                    # tensor-parallel step joins them here, for it alone.
                    x_rows = lanes.join(lanes.rows(state.params))
                    drift = lanes.consensus(z_cells)
                    z = lanes.join(lanes.rows(z_cells))
                else:
                    x_rows = lanes.join(xs)
                    drift = consensus_distance(z)
                S = async_cfg.max_staleness
                live = metrics["live_edges"]
                fields = dict(
                    consensus_dist=cdist,
                    local_drift=drift, live_edges=live,
                    wire_bits=wire_bits_for(
                        client_dim(lanes.shards(x_rows)[0]),
                        cfg.quant, live, model_parallel=lanes.mp),
                    staleness_hist=staleness_histogram(version_next, S),
                    dropped_edges=dropped_edge_count(W_t, version_next,
                                                     ready_eff, S))
                if quant_on:
                    # The codec saw z gated to x on lanes that did not
                    # publish; every lane is replayed (an event's ready
                    # set is sparse, a strided sample would miss it) and
                    # the means are over the ready lanes, each shard
                    # replaying its own.
                    qe, qb, qs = quant_round_telemetry(
                        x_rows, lanes.gate(ready_eff, z, x_rows),
                        cfg.quant, key_q, lane_weight=ready_eff)
                    fields.update(quant_err_sq=qe, quant_bound=qb,
                                  quant_sat_frac=qs)
                metrics["telemetry"] = Telemetry(**fields)
        return AsyncRoundState(
            params=x_next, rng=key_next, round=state.round + 1, clock=t_now,
            next_ready=next_ready, version=version_next,
            clock_rng=clock_rng), metrics

    event_step.local_step = lanes.local_step
    return event_step


def make_async_engine(loss_fn: LossFn, cfg: DFedAvgMConfig,
                      spec: MixingSpec | TopologySchedule,
                      async_cfg: AsyncConfig, *, device=None,
                      with_metrics: bool = True,
                      with_telemetry: bool = False,
                      batch_fn: Callable | None = None,
                      capture: bool = False, mesh=None,
                      param_specs=None) -> Callable:
    """A queue of events: ``run(state, batches)`` steps
    :func:`make_async_round_step` over a leading event axis (leaves
    [n_events, m, K, ...]), or ``run(state, n_events=N)`` with a
    version-keyed ``batch_fn``, and returns ``(state', metrics)`` with
    every metric stacked [n_events] (a ``Telemetry`` field by field) —
    the reference's ``lax.scan``, with no host sync between events.

    ``capture=True`` (on the card) captures the event step in one CUDA
    graph at the first call's shapes (``capture_step``) and replays it
    once an event, bitwise with the eager loop; ``run.graph`` is then the
    graph. Eager otherwise, and always on the CPU. ``mesh`` runs the
    events on a client mesh, ``param_specs`` cutting a 2D one's cells
    (:func:`make_async_round_step`)."""
    step = make_async_round_step(loss_fn, cfg, spec, async_cfg,
                                 device=device, with_metrics=with_metrics,
                                 with_telemetry=with_telemetry,
                                 batch_fn=batch_fn, mesh=mesh,
                                 param_specs=param_specs)
    captured: list = []

    def run(state: AsyncRoundState, batches: Params | None = None,
            n_events: int | None = None):
        if batch_fn is not None:
            if n_events is None:
                raise ValueError("version-keyed engine: pass n_events")
            events = [None] * n_events
        else:
            n = next(iter(batches.values())).shape[0]
            events = [{k: b[e] for k, b in batches.items()}
                      for e in range(n)]
        fn = step
        if capture and state.rng.device.type == "cuda" and events:
            if not captured:
                from .compiled import capture_step
                captured.append(capture_step(step, state, events[0]))
                run.graph = captured[0].graph
            fn = captured[0]
        history = []
        for b in events:
            state, met = fn(state, b)
            history.append(met)
        if not history:
            return state, {}
        return state, {k: _stack([h[k] for h in history])
                       for k in history[0]}

    run.graph = None
    run.local_step = step.local_step
    return run


def _train_ready_shards(loss_fn, cfg, lanes: _Lanes, xs, batches,
                        client_keys, ready, eta, cap: int):
    """``ready_capacity`` on a mesh: the first ``cap`` ready lanes of the
    whole mesh train (``ready`` is clamped to them, as on one device),
    each shard those of its block — at most ``min(cap, m_local)``, a
    fixed-size gather — and scatters them back (a 2D shard's row of
    cells on the tensor-parallel step). Returns (z shards, losses [m],
    clamped ready)."""
    m = ready.shape[0]
    idx, _, valid = _active_lanes(ready, cap)
    ready = ready * ready.new_zeros(m + 1).index_copy(0, idx, valid)[:m]
    etas = (lanes.split(eta) if isinstance(eta, torch.Tensor)
            else [eta] * len(xs))
    zs, losses = [], []
    for s, (x, b, k, r, e) in enumerate(zip(
            xs, lanes.split(batches), lanes.split(client_keys),
            lanes.split(ready), etas)):
        train = functools.partial(lanes.train, loss_fn, s, theta=cfg.theta)
        z, l_sub, ok, i = _train_active(train, x, b, k, r, cap, e)
        zs.append(z)
        losses.append(r.new_zeros(r.shape[0] + 1).index_copy(
            0, i, l_sub * ok)[:r.shape[0]])
    return zs, lanes.cat(losses), ready


def _stack(values: list):
    """Stack one metric over the events: a tensor, or a ``Telemetry``
    field by field (``None`` stays ``None``), as ``lax.scan`` stacks a
    pytree."""
    first = values[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(
            None if f is None else torch.stack([getattr(v, name)
                                                for v in values])
            for name, f in zip(first._fields, first)))
    return torch.stack(values)
