"""End-to-end DFedAvgM training driver, the port of the JAX package's
``launch/train.py``: the same flags, defaults and log records.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
      --rounds 50 --clients 8 --bits 8 [--device cpu]

It trains a registered architecture on synthetic LM data (the reduced
config: as in the reference, ``--reduced`` is always on; the full-width
config goes through the same ``run_resident`` / ``run_pooled`` with an
unreduced ``ArchConfig``, as ``chip_smoke.py`` does).

By default every client lane lives on the one device: ``--mixer-impl
auto`` and ``sparse`` run the plan realization (the reference's sparse
executor on a one-shard client mesh: B1/B2 on the quantized wire),
``dense`` the tensordot reference. ``--clients-per-shard`` below
``--clients`` asks for a 1D client mesh of ``m / clients_per_shard``
cards (``launch.mesh.make_client_mesh``), as the reference asks for
devices: with too few cards ``auto`` falls back to the dense reference
with the reference's warning and ``sparse`` exits. ``--placement
partition`` relabels lanes by ``compute_placement`` on such a mesh.
``run_resident(args, cfg, log, tracer, mesh=...)`` takes a mesh already
built — one whose shards share a card (``make_test_mesh``), as the
tests and ``chip_smoke.py`` run it. ``--model-parallel > 1`` asks for a
2D ``(clients, model)`` mesh of ``n_shards x model_parallel`` cards (the
default ``--clients-per-shard`` then puts every client in one shard):
the strategy-A rules (``sharding.RULES_A``) cut each leaf's
``mlp``/``vocab``/``heads``/... dim over the model columns when it
divides, and the run logs the reference's "2D mesh:" and per-column
wire lines, and a "local step:" line. Every registered arch trains
each shard's row of cells tensor-parallel (``models.model.make_loss``
carries a column-parallel form for the dense decoders, the MoE with its
experts or their ``moe_d_ff`` cut, the SSM, the hybrid, Whisper's
encoder and decoder and the VLM, an SSM inner dim that
``--model-parallel`` cuts across heads included: the reference's
GSPMD-partitioned step, within float rounding of the 1D mesh's losses),
and the line says "tensor_parallel"; an opaque loss joins each shard's
cells on its first column's card, bitwise the 1D mesh's losses
(``core.dfedavgm``), and the line says "joined". ``--pool``,
``--mixer-impl dense`` and ``--fuse-round`` refuse it, as in the
reference. ``--wire`` takes the reference's codec names; the port has
one codec, so ``auto``, ``seq`` and ``planar`` all run the planar buffer
kernels (B1/B2, B4/B5 fused). ``--device`` picks the card (the default)
or ``cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from .. import prng
from ..configs import get_config, reduced as make_reduced
from ..core import (AsyncConfig, CommLedger, DFedAvgMConfig, MixingSpec,
                    QuantConfig, SpeedModel, TopologySchedule,
                    async_event_bits, average_params, init_round_state,
                    make_round_step, round_comm_bits)
from ..core.async_gossip import init_async_state
from ..core.topology import erdos_renyi_graph, ring_graph
from ..data.synthetic import lm_client_batches, lm_round_batches
from ..device import resolve_device
from ..models import model as M
from ..telemetry import RunLog, Tracer, telemetry_host

# RunLog round-record fields pulled straight out of the step's metrics
# dict when present (the telemetry, if any, is merged first and wins —
# it is the realized, cross-checkable value).
_METRIC_FIELDS = ("consensus_dist", "active_frac", "clock", "ready_frac",
                  "mean_staleness", "max_staleness", "live_edges")


def _round_fields(metrics, comm_bits=None):
    """metrics dict (a step's device tensors or a pooled runner's host
    dict) -> plain python kwargs for ``RunLog.round``. One host transfer
    for the telemetry; scalar metrics are read individually only when the
    record is actually being written."""
    out = {}
    tel = metrics.get("telemetry")
    if tel is not None:
        out.update(telemetry_host(tel))
    for k in _METRIC_FIELDS:
        if k in metrics and k not in out:
            out[k] = float(metrics[k])
    for k, v in metrics.items():
        if k.startswith("pool_") or k == "cohort_size":
            out[k] = float(v) if not isinstance(v, (list, int)) else v
    if "staleness_hist" in metrics and "staleness_hist" not in out:
        out["staleness_hist"] = [int(c) for c in metrics["staleness_hist"]]
    if "wire_bits" in metrics and "wire_bits" not in out:
        out["wire_bits"] = float(metrics["wire_bits"])
    if comm_bits is not None:
        out["comm_bits"] = float(comm_bits)
    return out


def build_topology(args, m: int):
    """CLI -> static MixingSpec or time-varying TopologySchedule."""
    ring = MixingSpec.ring(m, self_weight=args.self_weight)
    if args.schedule == "static":
        return ring
    if args.schedule == "constant":
        return TopologySchedule.constant(ring)
    base = (erdos_renyi_graph(m, args.er_p, seed=args.seed)
            if args.base_graph == "er" else ring_graph(m))
    if args.schedule == "edge-sample":
        return TopologySchedule.edge_sample(base, args.edge_p)
    if args.schedule == "partial":
        return TopologySchedule.partial(base, args.p_active,
                                        exact=args.exact_partial,
                                        cap_slack=args.partial_cap_slack)
    if args.schedule == "random-walk":
        return TopologySchedule.random_walk(base, horizon=max(args.rounds, 64),
                                            seed=args.seed,
                                            stateful=args.stateful_walk)
    if args.schedule == "cycle":
        rows = next((r for r in range(int(m ** 0.5), 1, -1) if m % r == 0),
                    None)
        if rows is None:
            raise SystemExit(f"--schedule cycle needs composite m, got {m}")
        return TopologySchedule.cycle(
            [ring, MixingSpec.torus(rows, m // rows)])
    raise SystemExit(f"unknown --schedule {args.schedule!r}")


def _speed(args) -> SpeedModel:
    return {"constant": SpeedModel.constant(),
            "lognormal": SpeedModel.lognormal(),
            "straggler": SpeedModel.straggler()}[args.speed_model]


def _model_loss(cfg):
    return M.make_loss(cfg)


def _local_step_why(loss, mesh, specs, kind: str) -> str:
    """The "local step:" line's reason: the tensor-parallel step, or why
    the step joins (an opaque loss, or the cut leaves its form
    declines)."""
    if kind == "tensor_parallel":
        return "each shard's row of cells, column-parallel products"
    from ..core.mixing import _column_dims
    dims = _column_dims(mesh, specs)
    form = getattr(loss, "column_parallel", None)
    declined = [n for n, d in dims.items()
                if d is not None and form is not None
                and not form.covers(n, dims)]
    why = ("the loss has no column-parallel form" if form is None else
           f"its form declines {len(declined)} cut leaves, e.g. "
           f"{declined[0]}")
    return f"each shard's cells joined on its first column; {why}"


def run_pooled(args, cfg, log, tracer):
    """Virtual-client-pool execution: all ``--clients`` live in a host-
    side :class:`~repro_torch.core.client_pool.ClientPool`; only the
    round's cohort (``--resident-lanes`` wide) is materialized on the
    device. Data is generated per cohort, keyed on (client id, progress
    counter). With ``--telemetry`` the pooled path reports
    ``consensus_dist`` over the FULL pool (host-side, f64 accumulation)."""
    from ..core import (ClientPool, PoolSchedule, PooledAsyncRunner,
                        PooledRunner)
    from .mesh import resident_lane_capacity

    dev = resolve_device(args.device)
    m = args.clients
    quant = QuantConfig(bits=args.bits) if args.bits < 32 else None
    dfed = DFedAvgMConfig(eta=args.eta, theta=args.theta,
                          local_steps=args.local_steps, quant=quant)
    key = prng.PRNGKey(args.seed, device=dev)
    k_init, k_state, k_data = prng.split(key, 3)
    template = M.init_model(k_init, cfg, device=dev)
    d = cfg.n_params()

    lanes = args.resident_lanes
    if lanes is None:
        per_client = sum(t.numel() * t.element_size()
                         for t in template.values())
        lanes = min(m, resident_lane_capacity(per_client, device=dev))
    loss = _model_loss(cfg)
    pool = ClientPool(template, m)
    data_kw = dict(K=args.local_steps, batch=args.batch, seq=args.seq,
                   vocab=cfg.vocab_size)

    if args.async_gossip:
        acfg = AsyncConfig(speed=_speed(args),
                           max_staleness=args.max_staleness,
                           eta_staleness_decay=args.eta_staleness_decay)
        bf = lambda ids, vers: lm_client_batches(k_data, ids, vers,
                                                 **data_kw)
        runner = PooledAsyncRunner(pool, loss, dfed, acfg, bf,
                                   key=k_state, capacity=lanes,
                                   ring_self_weight=args.self_weight,
                                   telemetry=args.telemetry, tracer=tracer,
                                   device=dev)
        log.info(f"pooled async: m={m} capacity={lanes} "
                 f"speed={args.speed_model} (rounds are EVENTS)")
    else:
        if args.schedule == "random-walk":
            psched = PoolSchedule.ring_random_walk(
                m, horizon=max(args.rounds, 64), seed=args.seed)
        elif args.schedule == "partial" and args.base_graph == "er":
            # small-m only: dense base retained via the resident schedule
            psched = PoolSchedule.from_schedule(build_topology(args, m))
        else:
            psched = PoolSchedule.ring_partial(m, lanes / m)
        backend = "sparse" if args.mixer_impl == "sparse" else "dense"
        # sync cohorts are globally ordered, so (client, round) keying is
        # deterministic and prefetch-safe
        bf = lambda idx, t: lm_client_batches(
            k_data, idx, torch.full(idx.shape, t, dtype=torch.int64,
                                    device=idx.device), **data_kw)
        runner = PooledRunner(pool, psched, loss, dfed, bf, key=k_state,
                              backend=backend, telemetry=args.telemetry,
                              tracer=tracer, device=dev)
        log.info(f"pooled: m={m} schedule={psched.name} "
                 f"cohort={psched.cohort_size} backend={backend} "
                 f"(E[edges/round]={psched.expected_directed_edges():.1f})")

    metrics = {}
    async_bits = 0.0
    try:
        for t in range(args.rounds):
            metrics = (runner.step_event() if args.async_gossip
                       else runner.round())
            if args.async_gossip:
                async_bits += async_event_bits(
                    d, quant, live_edges=float(metrics["live_edges"]))
            if args.ckpt_dir and not args.async_gossip \
                    and (t + 1) % args.ckpt_every == 0:
                with tracer.span("round/checkpoint", t=t):
                    runner.save(args.ckpt_dir)
            cadence = (t % max(1, args.rounds // 10) == 0
                       or t == args.rounds - 1)
            if log.jsonl is not None or cadence:
                bits = async_bits if args.async_gossip else runner.comm_bits
                fields = _round_fields(metrics, comm_bits=bits)
                fields.setdefault("pool_materialized", int(pool.materialized))
                fields.setdefault("pool_mbytes", pool.nbytes / 2**20)
                log.round(t, float(metrics["loss"]), console=cadence,
                          **fields)
    finally:
        if hasattr(runner, "close"):
            runner.close()
    log.info(f"done; {pool.materialized} of {m} clients materialized, "
             f"{pool.nbytes/2**20:.1f}MB host params")
    bits = async_bits if args.async_gossip else runner.comm_bits
    log.end(args.rounds, comm_bits=float(bits),
            final_loss=float(metrics["loss"]) if metrics else None)
    return runner, metrics


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eta", type=float, default=3e-2)
    ap.add_argument("--theta", type=float, default=0.9)
    ap.add_argument("--bits", type=int, default=32)
    ap.add_argument("--mixer-impl", default="auto",
                    choices=["auto", "dense", "sparse"],
                    help="gossip backend: dense tensordot reference vs the "
                         "plan realization (auto and sparse: the sparse "
                         "executor on one device)")
    ap.add_argument("--clients-per-shard", type=int, default=None,
                    help="clients per device shard of the sparse backend's "
                         "client mesh (must divide --clients); the default "
                         "is all clients on one device; fewer asks for "
                         "m / clients_per_shard cards")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-parallel degree of a 2D (clients, model) "
                         "mesh: each of the model_parallel device columns "
                         "holds and ships only its 1/model_parallel slice "
                         "of every model-sharded leaf; needs n_shards x "
                         "model_parallel cards and the sparse backend; "
                         "every arch trains tensor-parallel over the "
                         "columns (an SSM inner dim cut across heads "
                         "too)")
    ap.add_argument("--placement", default="contiguous",
                    choices=["contiguous", "partition"],
                    help="client -> lane placement for the sparse backend: "
                         "contiguous keeps client c on shard "
                         "c // clients_per_shard; partition runs the "
                         "graph-partition pass (compute_placement) to cut "
                         "the boundary edges")
    ap.add_argument("--wire", default="auto",
                    choices=["auto", "seq", "planar"],
                    help="wire codec of the sparse mixer, as the "
                         "reference names them; every value runs the "
                         "planar buffer kernels (B1/B2)")
    ap.add_argument("--self-weight", type=float, default=0.5,
                    help="ring self weight (0.5 => PSD W, safe for Alg. 2)")
    ap.add_argument("--fuse-round", action="store_true",
                    help="fused round: the last local step folds into the "
                         "wire encode (B4) and the mix + momentum apply "
                         "into one decode (B5); needs --local-steps >= 2")
    ap.add_argument("--schedule", default="static",
                    choices=["static", "constant", "edge-sample", "partial",
                             "random-walk", "cycle"],
                    help="time-varying topology schedule (static = old path)")
    ap.add_argument("--base-graph", default="ring", choices=["ring", "er"],
                    help="base graph for sampled schedules")
    ap.add_argument("--edge-p", type=float, default=0.7,
                    help="per-round edge keep probability (edge-sample)")
    ap.add_argument("--p-active", type=float, default=0.7,
                    help="per-round client participation prob (partial)")
    ap.add_argument("--er-p", type=float, default=0.5,
                    help="ER base-graph edge density (--base-graph er)")
    ap.add_argument("--exact-partial", action="store_true",
                    help="partial schedule draws an EXACT cohort of "
                         "round(p_active*m) clients")
    ap.add_argument("--partial-cap-slack", type=int, default=None,
                    help="cap i.i.d. partial participation at "
                         "ceil(p_active*m)+slack clients per round")
    ap.add_argument("--stateful-walk", action="store_true",
                    help="random-walk token as RoundState instead of a "
                         "precomputed host-side path")
    ap.add_argument("--async-gossip", action="store_true",
                    help="drop the round barrier: event-driven async "
                         "engine with staleness-aware mixing")
    ap.add_argument("--speed-model", default="lognormal",
                    choices=["constant", "lognormal", "straggler"],
                    help="per-client compute-duration distribution "
                         "(--async-gossip)")
    ap.add_argument("--max-staleness", type=int, default=8,
                    help="neighbors staler than this many local rounds "
                         "get mixing weight 0 (--async-gossip)")
    ap.add_argument("--eta-staleness-decay", type=float, default=0.0,
                    help="staleness-adaptive local LR (--async-gossip)")
    ap.add_argument("--pool", action="store_true",
                    help="virtual client pool: all --clients in a host-side "
                         "COW store, only the round's cohort on the device")
    ap.add_argument("--resident-lanes", type=int, default=None,
                    help="device lanes for pooled execution; default sized "
                         "from device memory (mesh.resident_lane_capacity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save RoundState every --ckpt-every rounds")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--telemetry", action="store_true",
                    help="build the round step with in-graph telemetry; "
                         "the off path is bitwise the same")
    ap.add_argument("--log-jsonl", default=None, metavar="PATH",
                    help="write EVERY round as a schema-validated JSONL "
                         "record")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write host-stage spans as Chrome trace-event JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap


def _refuse_unported(args, m: int) -> None:
    """A shard size that does not divide m exits, and so do the 2D
    mesh's refusals, as in the reference."""
    _refuse_2d(args)
    cps = args.clients_per_shard
    if cps is not None and (cps < 1 or m % cps):
        raise SystemExit(f"--clients-per-shard {cps} must be >= 1 and "
                         f"divide --clients {m}")


def _refuse_2d(args) -> None:
    """The reference's refusals of ``--model-parallel``."""
    mp = args.model_parallel
    if mp < 1:
        raise SystemExit(f"--model-parallel {mp} must be >= 1")
    if mp > 1 and args.pool:
        raise SystemExit(
            "--model-parallel > 1 is incompatible with --pool (pooled lanes "
            "hold full replicas in the host store; the 2D mesh is a "
            "resident-execution layout)")
    if mp > 1 and args.mixer_impl == "dense":
        raise SystemExit("--model-parallel > 1 needs the sparse backend "
                         "(the dense tensordot reference mixes full "
                         "replicas); drop --mixer-impl dense")
    if mp > 1 and args.fuse_round:
        raise SystemExit(
            "--fuse-round is incompatible with --model-parallel > 1: the "
            "fused tail computes the last gradient inside the mixer, where "
            "a cell holds only a 1/model_parallel slice of the params; run "
            "the unfused round")


def main(argv=None):
    """The LM driver's command line (the reference's flags plus ``--device``):
    DFedAvgM rounds of a registered arch, a line of loss, consensus and wire MB
    a round."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    cfg = dataclasses.replace(cfg, remat=False)
    _refuse_unported(args, args.clients)
    log = RunLog(jsonl=args.log_jsonl)
    tracer = Tracer(enabled=args.trace is not None)
    log.start(config={k: v for k, v in vars(args).items()})
    try:
        if args.pool:
            if args.placement == "partition":
                raise SystemExit(
                    "--placement partition is incompatible with --pool "
                    "(pooled lanes are cohort slots, not fixed clients, "
                    "and no O(m^2) support adjacency exists)")
            return run_pooled(args, cfg, log, tracer)
        return run_resident(args, cfg, log, tracer,
                            mesh=_client_mesh(args, args.clients))
    finally:
        if args.trace:
            tracer.save(args.trace)
        log.close()


_MESH_FALLBACK = object()    # a mesh was asked for; too few cards


def _client_mesh(args, m: int):
    """The reference's mesh resolution: ``--clients-per-shard`` below m
    with ``--mixer-impl auto`` or ``sparse`` asks for one card a shard
    (``make_client_mesh``; none on ``--device cpu``). Returns the mesh,
    None for the one-device layout, or ``_MESH_FALLBACK`` when ``auto``
    found too few cards (the run then takes the dense reference, as the
    reference's does); ``sparse`` with too few cards exits."""
    cps = args.clients_per_shard
    if args.model_parallel > 1:
        cps = m if cps is None else cps
    elif cps is None or m // cps == 1 or args.mixer_impl == "dense":
        return None
    from .mesh import make_client_mesh
    dev = resolve_device(args.device)
    cards = ([torch.device("cuda", i) for i in range(
        torch.cuda.device_count())] if dev.type == "cuda" else [])
    mesh = make_client_mesh(m, clients_per_shard=cps,
                            model_parallel=args.model_parallel,
                            devices=cards)
    if mesh is not None:
        return mesh
    if args.mixer_impl == "sparse" or args.model_parallel > 1:
        have = len(cards)
        raise SystemExit(
            f"this run needs >= {m // cps * args.model_parallel} devices "
            f"({m // cps} client shards x {args.model_parallel} model "
            f"columns), this host has {have}; raise --clients-per-shard or "
            "lower --model-parallel to fit")
    return _MESH_FALLBACK


def run_resident(args, cfg, log, tracer, mesh=None):
    """Every client resident: the round step (``core.make_round_step``,
    or the async engine's event step) on stacked client copies, on one
    device, or on the client ``mesh`` given (its cells may share a card:
    ``launch.mesh.make_test_mesh``; a 2D one's ``model_parallel`` must be
    ``--model-parallel``). Returns (state, metrics); on a mesh the
    state's parameters are a list of shard dicts (lane order under
    ``--placement partition``), of cell dicts on a 2D mesh."""
    m = args.clients
    fallback = mesh is _MESH_FALLBACK
    if fallback:
        mesh = None
    _refuse_2d(args)
    if (1 if mesh is None else mesh.model_parallel) != args.model_parallel:
        raise SystemExit(f"--model-parallel {args.model_parallel} needs a "
                         "client mesh of that many model columns")
    if mesh is not None:
        if args.mixer_impl == "dense":
            raise SystemExit("a client mesh runs the sparse backend; drop "
                             "--mixer-impl dense or the mesh")
        n_shards = mesh.n_shards
        if m % n_shards:
            raise SystemExit(f"--clients {m} does not block over the "
                             f"mesh's {n_shards} shards")
        if args.clients_per_shard not in (None, m // n_shards):
            raise SystemExit(f"--clients-per-shard {args.clients_per_shard}"
                             f" disagrees with the mesh ({n_shards} shards "
                             f"of {m // n_shards})")
        dev = mesh.devices.flat[0]
    else:
        dev = resolve_device(args.device)
    cps = m // mesh.n_shards if mesh is not None else m
    quant = QuantConfig(bits=args.bits) if args.bits < 32 else None
    spec = build_topology(args, m)
    scheduled = isinstance(spec, TopologySchedule)
    impl = ("sparse" if mesh is not None else "dense" if fallback
            else args.mixer_impl)
    dfed = DFedAvgMConfig(eta=args.eta, theta=args.theta,
                          local_steps=args.local_steps, quant=quant,
                          mixer_impl=impl, wire=args.wire,
                          fuse_round=args.fuse_round)
    sparse = dfed.mixer_config().resolved_impl(spec) != "dense"
    placement = None
    if args.placement == "partition":
        if mesh is None:
            raise SystemExit(
                "--placement partition needs the sparse backend on a "
                "client mesh (this run resolved to "
                f"{'the dense reference' if not sparse else 'one device'}"
                "); see --mixer-impl / --clients-per-shard")
        if args.async_gossip:
            raise SystemExit("--placement partition is incompatible with "
                             "--async-gossip (client-order lane "
                             "bookkeeping)")
        from ..core.gossip_plan import compute_placement
        support = spec.support_graph() if scheduled else spec.graph
        placement = compute_placement(support, m // cps)
        cut0 = support.block_boundary_edges(cps)
        cut1 = support.block_boundary_edges(cps, perm=placement)
        log.info(f"placement: partition over {m // cps} shards — directed "
                 f"boundary edges {cut0} (contiguous) -> {cut1} (placed)")
    if scheduled:
        log.info(f"topology schedule: {spec.name} "
                 f"(E[directed edges/round] = "
                 f"{spec.expected_directed_edges():.1f})")
    if sparse:
        plans = spec.gossip_plans() if scheduled else [spec.gossip_plan()]
        for p in plans:
            if mesh is not None:
                bp = p.block_plan(m // cps, placement=placement)
                log.info(f"mixer backend: sparse ({p.name}: {cps} "
                         f"clients/shard over {bp.n_shards} shards, "
                         f"{bp.num_collectives} transfer sub-steps, "
                         f"{bp.num_wire_lane_slots} boundary wire lanes "
                         f"per round)")
            else:
                log.info(f"mixer backend: sparse ({p.name}: the plan "
                         f"realization, {p.n_steps} streams gathered on "
                         f"one device, {p.num_directed_wire_edges} "
                         f"realized wire edges per round)")
    else:
        log.info("mixer backend: dense (tensordot reference)")

    key = prng.PRNGKey(args.seed, device=dev)
    k_init, k_state, k_data = prng.split(key, 3)
    params = M.init_model(k_init, cfg, device=dev)
    stacked = {n: t.unsqueeze(0).expand((m,) + tuple(t.shape)).contiguous()
               for n, t in params.items()}
    del params
    specs = None
    if args.model_parallel > 1:
        # 2D (clients, model) mesh: shard each leaf's inner dims over the
        # model axis (strategy-A rules; leaves whose dims do not divide
        # stay replicated), the cells cut once at init.
        from ..sharding.rules import RULES_A, specs_for_tree
        specs = specs_for_tree(M.model_axes(cfg), stacked, RULES_A, mesh,
                               leading_client=("clients",))
        n_sharded = sum(
            any("model" in spec.names(i) for i in range(len(spec)))
            for spec in specs.values())
        log.info(f"2D mesh: model_parallel={args.model_parallel}, "
                 f"{n_sharded}/{len(specs)} param leaves model-sharded "
                 f"(the rest replicate per column)")
    loss = _model_loss(cfg)
    acfg = None
    if args.async_gossip:
        acfg = AsyncConfig(speed=_speed(args),
                           max_staleness=args.max_staleness,
                           eta_staleness_decay=args.eta_staleness_decay)
        log.info(f"async gossip: speed={args.speed_model} "
                 f"max_staleness={args.max_staleness} "
                 f"eta_staleness_decay={args.eta_staleness_decay} "
                 f"(rounds are EVENTS)")
    step = make_round_step(loss, dfed, spec, device=dev, async_cfg=acfg,
                           with_telemetry=args.telemetry, mesh=mesh,
                           placement=placement, param_specs=specs)
    if args.model_parallel > 1:
        log.info(f"local step: {step.local_step} ({cfg.arch_type} family: "
                 + _local_step_why(loss, mesh, specs, step.local_step) + ")")
    if acfg is not None:
        state = init_async_state(stacked, k_state, acfg.speed, mesh=mesh,
                                 param_specs=specs)
    else:
        token = (spec.init_token()
                 if scheduled and spec.is_stateful else None)
        state = init_round_state(stacked, k_state, token=token, mesh=mesh,
                                 param_specs=specs)
    del stacked

    d = cfg.n_params()
    if sparse and args.model_parallel > 1:
        from ..core.comm_cost import plan_round_bits
        plan = plans if len(plans) > 1 else plans[0]
        wire_1d = plan_round_bits(plan, d, quant, clients_per_shard=cps,
                                  placement=placement)
        wire_col = plan_round_bits(plan, d, quant, clients_per_shard=cps,
                                   placement=placement,
                                   model_parallel=args.model_parallel)
        log.info(f"per-device wire: {wire_col / 8 / 1e6:.2f} MB/round "
                 f"per model column (1D bill {wire_1d / 8 / 1e6:.2f} MB, "
                 f"{wire_1d / max(wire_col, 1e-9):.1f}x reduction)")
    # One billing convention for both backends: the live-directed-edge
    # expectation (paper §3.2). Async: realized live edges are billed per
    # event below (the set varies with readiness and staleness).
    ledger = CommLedger(0.0 if acfg is not None
                        else round_comm_bits(spec, d, quant))
    metrics = {}
    for t in range(args.rounds):
        with tracer.span("round/data", t=t):
            if acfg is not None:
                # Async events are unordered across clients: data keys on
                # each client's OWN progress counter.
                batches = lm_client_batches(
                    k_data, torch.arange(m, device=dev), state.version,
                    K=args.local_steps, batch=args.batch, seq=args.seq,
                    vocab=cfg.vocab_size)
            else:
                batches = lm_round_batches(k_data, t, m=m,
                                           K=args.local_steps,
                                           batch=args.batch, seq=args.seq,
                                           vocab=cfg.vocab_size)
        with tracer.span("round/step", t=t):
            state, metrics = step(state, batches)
            if tracer.enabled and dev.type == "cuda":
                # Fold device time into the span; untraced runs keep the
                # asynchronous launch overlap untouched.
                torch.cuda.synchronize(dev)
        if acfg is not None:
            ledger.add_bits(async_event_bits(
                d, quant, live_edges=float(metrics["live_edges"])))
        else:
            ledger.tick()
        if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
            from ..checkpoint import save_checkpoint
            with tracer.span("round/checkpoint", t=t):
                save_checkpoint(args.ckpt_dir, t + 1, state if mesh is None
                                else state._replace(
                                    params=mesh.gather(state.params,
                                                       specs)))
        cadence = t % max(1, args.rounds // 10) == 0 or t == args.rounds - 1
        if log.jsonl is not None or cadence:
            with tracer.span("round/d2h", t=t):
                fields = _round_fields(metrics,
                                       comm_bits=ledger.total_bits)
                if acfg is not None:
                    fields.setdefault("clock", float(state.clock))
                log.round(t, float(metrics["loss"]), console=cadence,
                          **fields)
    avg = average_params(state.params if specs is None
                         else mesh.gather(state.params, specs))
    log.info(f"done; consensus model leaves: {len(avg)}")
    log.end(args.rounds, comm_bits=float(ledger.total_bits),
            final_loss=float(metrics["loss"]) if metrics else None,
            final_consensus_dist=(float(metrics["consensus_dist"])
                                  if "consensus_dist" in metrics else None))
    return state, metrics


if __name__ == "__main__":
    main()
