"""Time-varying gossip: a static ring against sampled, partial and
random-walk schedules — the in-process rows of the reference's
``benchmarks/bench_timevarying.py`` (``run``'s loop over its
``schedules``) on the port: us a round, loss, consensus distance, bits a
round and accuracy of the 2NN on the synthetic task.

``telemetry_overhead_compare`` is the reference's telemetry arm: the
round with ``with_telemetry=True`` against the plain round (row
``round_telemetry_on_vs_off``).

The reference's mesh halves (its host-device subprocesses) run here on
a test mesh (``launch.mesh.make_test_mesh``: every cell on one device),
with the reference's shapes and gates: ``gossip_backend_compare``
(dense against sparse on an edge-sampled ring of 8),
``block_gossip_compare`` (m 64 over 8 shards), ``mesh2d_compare`` (the
2D mesh against the 1D one), ``fused_round_compare`` (the fused round
against the unfused one) and ``placement_compare`` (contiguous against
partitioned lanes, numpy only). The reference counts a device's wire
from its compiled HLO; here the bytes are those of the payloads the
mixer's transfers ship (``tables.shipped_bytes`` / ``column_bytes``,
counted in ``core.mixing._exchange``; the dense reference's counts what
leaves and returns to every cell but the first), a device's share being
its mesh column's bytes over the shards. ``gossip_backend_compare``
writes ``GOSSIP_JSON`` (under the git-ignored ``chiprun_out/``; the
reference's ``BENCH_gossip.json`` is the JAX package's), and ``run``
emits its rows after the schedules', as the reference's does.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import prng
from ..core import (DFedAvgMConfig, MixerConfig, MixingSpec, QuantConfig,
                    TopologySchedule, capture_step, compute_placement,
                    dfedavgm_round_bits, init_round_state, make_mixer,
                    make_round_step, schedule_round_bits)
from ..core.comm_cost import plan_round_bits
from ..core.gossip_plan import plan_from_support
from ..core.mixing import make_plan_mixer
from ..core.topology import Graph, erdos_renyi_graph, ring_graph
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from ..launch.cost_model import structural_costs
from ..sharding import P
from .common import loss_2nn, stacked_2nn, timeit_best, train_dfedavgm_2nn

GOSSIP_JSON = (Path(__file__).resolve().parents[3] / "chiprun_out"
               / "BENCH_gossip_torch.json")

M, K, B, ROUNDS = 16, 4, 32, 30
SMOKE_M, SMOKE_K, SMOKE_B, SMOKE_ROUNDS = 4, 2, 8, 2


def schedules(m: int, rounds: int, seed: int = 0):
    """The bench's topologies over ``m`` clients: the static ring and one
    ``TopologySchedule`` of each kind (constant, edge-sampled, partial, random
    walk, cycle), as (name, spec) pairs."""
    ring = MixingSpec.ring(m, self_weight=0.5)
    er = erdos_renyi_graph(m, 0.4, seed=seed)
    return [
        ("static_ring", ring),
        ("constant_sched", TopologySchedule.constant(ring)),
        ("er_edge_sample", TopologySchedule.edge_sample(er, p_edge=0.5)),
        ("ring_partial", TopologySchedule.partial(ring_graph(m),
                                                  p_active=0.6)),
        ("ring_random_walk", TopologySchedule.random_walk(
            ring_graph(m), horizon=max(rounds, 64), seed=seed)),
    ]


def arms(*, smoke: bool = False, device=None, capture: bool = True):
    """(name, result) for each schedule at 32 bits, as the reference's
    rows; a result holds ``bits_per_round`` beside the training one."""
    m, k, b, rounds = ((SMOKE_M, SMOKE_K, SMOKE_B, SMOKE_ROUNDS) if smoke
                       else (M, K, B, ROUNDS))
    quant = None
    for name, topo in schedules(m, rounds):
        out = train_dfedavgm_2nn(m=m, K=k, batch=b, rounds=rounds,
                                 topology=topo, device=device,
                                 capture=capture)
        d = out["d"]
        if isinstance(topo, TopologySchedule):
            bpr = schedule_round_bits(topo, d, quant)
        else:
            bpr = dfedavgm_round_bits(topo.graph, d, quant)
        yield f"timevarying_{name}", dict(
            out, bits_per_round=bpr,
            derived=f"loss={out['loss']:.4f}|"
            f"consensus_dist={out['consensus_dist']:.3e}|"
            f"bits_per_round={bpr:.0f}|acc={out['acc']:.3f}")


def telemetry_overhead_compare(smoke: bool = False, device=None,
                               capture: bool = True) -> dict:
    """``with_telemetry=True`` against the plain round on the reference's
    representative training round: the paper's 2NN, m 16, K 4, batch 64,
    8-bit stochastic lemma5 on ``edge_sample(ring_graph(16), 0.5)``. The
    telemetry adds consensus reductions, the live-edge count of W_t and
    the quantizer replay of two sampled lanes. Interleaved best-of-7
    (``timeit_best`` at one rep an alternation), each arm on the same
    fixed batch. On the card each round is one captured graph replay
    (the batch already in the graph's buffer) unless ``capture`` is
    False; the reference holds the ratio to <= 1.10 on its CPU runner.
    Returns both arms' us a round and ``overhead_ratio`` (on / off), with
    ``graphs`` the captured graphs (None when eager). ``smoke`` runs the
    module's smoke sizes (m 4, K 2, batch 8), one round a rep."""
    dev = resolve_device(device)
    m, K, batch = (SMOKE_M, SMOKE_K, SMOKE_B) if smoke else (16, 4, 64)
    iters = 1 if smoke else 10
    data = classification_dataset(n=2000 if smoke else 8000, seed=0)
    fed = FederatedDataset.make(data, m, iid=True, seed=0)
    batches = fed.round_batches(0, K=K, batch=batch, seed=0, device=dev)
    sched = TopologySchedule.edge_sample(ring_graph(m), p_edge=0.5)
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                         quant=QuantConfig(bits=8))
    captured = capture and dev.type == "cuda"
    stacked = stacked_2nn(m, 0, dev)
    arms_ = {}
    for name, wt in (("off", False), ("on", True)):
        step = make_round_step(loss_2nn, cfg, sched, device=dev,
                               with_telemetry=wt)
        st = init_round_state(stacked, prng.PRNGKey(1))
        b = batches
        if captured:
            step = capture_step(step, st, batches)
            b = step.static_batches   # filled once: no copy a round
        st, _ = step(st, b)
        arms_[name] = {"step": step, "st": st, "b": b, "us": float("inf")}
    for _ in range(7):
        for name in ("off", "on"):
            a = arms_[name]
            us, a["st"] = timeit_best(
                lambda i, st, step=a["step"], b=a["b"]: step(st, b)[0],
                a["st"], iters=iters, reps=1, device=dev)
            a["us"] = min(a["us"], us)
    return {"m": m, "K": K, "bits": 8, "batch": batch,
            "captured": captured,
            "us_off": arms_["off"]["us"], "us_on": arms_["on"]["us"],
            "overhead_ratio": arms_["on"]["us"] / arms_["off"]["us"],
            "graphs": {k: a["step"].graph if captured else None
                       for k, a in arms_.items()}}


# ---------------------------------------------------------------------------
# The mesh halves: dense against sparse bytes, blocks, the 2D mesh, the
# fused round, placement
# ---------------------------------------------------------------------------

def _test_mesh(n_shards: int, dev, model_parallel: int = 1):
    from ..launch.mesh import make_test_mesh
    return make_test_mesh(n_shards, model_parallel=model_parallel,
                          device=dev)


def _wire_arm(mixer, mesh, x, z, key, iters: int, dev, specs=None,
              scheduled: bool = True) -> dict:
    """One mixer on ``mesh``: best-of-3 us a call (``iters`` calls a rep,
    the round index the call's) and a device's wire bytes a round: the
    mean over the shards of column 0's shipped payload bytes."""
    xs, zs = mesh.shard(x, specs), mesh.shard(z, specs)

    def body(t, xs):
        out = mixer(xs, zs, key, t)
        return out[0] if scheduled else out

    xs = body(0, xs)
    us, _ = timeit_best(body, xs, iters=iters, reps=3, device=dev)
    return {"us_per_round": us,
            "wire_bytes_per_device":
                mixer.tables.column_bytes[0] / mesh.n_shards}


def _pair(m: int, d: int, dev) -> tuple[dict, dict, object]:
    k0, k1, k2 = prng.split(prng.PRNGKey(0, device=dev), 3)
    return ({"w": prng.normal(k0, (m, d))}, {"w": prng.normal(k1, (m, d))},
            k2)


def _eq7(bits: int):
    return (QuantConfig(bits=bits, stochastic=False, delta_mode="eq7")
            if bits < 32 else None)


def block_gossip_compare(smoke: bool = False, device=None) -> dict:
    """Block-sharded m 64 over 8 shards (clients_per_shard 8): the sparse
    backend's wire stays O(n_shards * boundary degree), gated against the
    dense O(m) arm (>= 8x fewer q8 bytes) and the block plan ships exactly
    the graph's block-boundary edges."""
    dev = resolve_device(device)
    m, shards = 64, 8
    d = 16384 if smoke else 65536
    iters = 5 if smoke else 20
    mesh = _test_mesh(shards, dev)
    sched = TopologySchedule.edge_sample(ring_graph(m), p_edge=0.5)
    plan = sched.gossip_plan()
    bp = plan.block_plan(shards)
    x, z, key = _pair(m, d, dev)
    out = {"m": m, "n_shards": shards, "clients_per_shard": bp.m_local,
           "d": d, "schedule": sched.name,
           "block_collectives": bp.num_collectives,
           "block_wire_lane_slots": bp.num_wire_lane_slots,
           "boundary_directed_edges":
               ring_graph(m).block_boundary_edges(bp.m_local)}
    for bits in (32, 8):
        q = _eq7(bits)
        for impl in ("dense", "sparse"):
            arm = _wire_arm(make_mixer(sched, MixerConfig(impl=impl,
                                                          quant=q),
                                       mesh=mesh), mesh, x, z, key, iters,
                            dev)
            if impl == "sparse":
                arm["realized_wire_bits"] = plan_round_bits(
                    plan, d, q, clients_per_shard=bp.m_local)
            out[f"{impl}_b{bits}"] = arm
    for bits in (32, 8):
        dn, sp = out[f"dense_b{bits}"], out[f"sparse_b{bits}"]
        out[f"wire_ratio_dense_over_block_b{bits}"] = (
            dn["wire_bytes_per_device"]
            / max(sp["wire_bytes_per_device"], 1e-9))
    assert out["block_wire_lane_slots"] == out["boundary_directed_edges"], \
        out
    assert out["wire_ratio_dense_over_block_b8"] >= 8.0, out
    return out


def mesh2d_compare(smoke: bool = False, device=None) -> dict:
    """The 2D (clients, model) mesh against the 1D client mesh: a ring of
    8 on 2 shards, ``w`` [8, d] cut over 4 model columns
    (``P("clients", "model")``). A column ships only its slice, so a
    device's payload bytes drop exactly 4x on the fp32 wire and >= 3x on
    q8 (the per-leaf scale rides every column's stream, and each cell's
    planar leaf pads to a 512-word block). Gated here."""
    dev = resolve_device(device)
    m, mp = 8, 4
    d = 16384 if smoke else 65536
    iters = 10 if smoke else 20
    cps = m // 2
    plan = MixingSpec.ring(m, self_weight=0.5).gossip_plan()
    mesh1, mesh2 = _test_mesh(2, dev), _test_mesh(2, dev, mp)
    specs = {"w": P("clients", "model")}
    x, z, key = _pair(m, d, dev)
    out = {"m": m, "model_parallel": mp, "d": d,
           "plan_wire_edges": plan.num_directed_wire_edges}
    for bits in (32, 8):
        q = _eq7(bits)
        for name, mesh, sp in (("mesh1d", mesh1, None),
                               ("mesh2d", mesh2, specs)):
            mx = make_plan_mixer(plan, q, mesh=mesh, param_specs=sp)
            arm = _wire_arm(mx, mesh, x, z, key, iters, dev, sp,
                            scheduled=False)
            out[f"{name}_b{bits}"] = {
                "payload_bytes_per_device": arm["wire_bytes_per_device"],
                "us_per_round": arm["us_per_round"],
                "billed_bits_per_device_column": plan_round_bits(
                    plan, d, q, clients_per_shard=cps,
                    model_parallel=1 if sp is None else mp)}
    for bits in (32, 8):
        a, b = out[f"mesh1d_b{bits}"], out[f"mesh2d_b{bits}"]
        out[f"wire_ratio_1d_over_2d_b{bits}"] = (
            a["payload_bytes_per_device"]
            / max(b["payload_bytes_per_device"], 1e-9))
    assert out["wire_ratio_1d_over_2d_b32"] == float(mp), out
    assert out["wire_ratio_1d_over_2d_b8"] >= 3.0, out
    return out


def _quadratic_loss(p, b, r):
    """Per-client 0.5 * ||w - c||^2 (the reference's fused arm's loss)."""
    return 0.5 * ((p["w"] - b["c"]) ** 2).sum(dim=-1)


def tail_kernel_bytes(d: int) -> dict:
    """The bytes of the kernels of the stage the fusion rewrote, for one
    client at the reference's shapes (a [per, W] planar buffer of d f32
    values at 8 bits, the own stream and two ring neighbours'): the
    unfused tail's two B3 steps, B1 and B2 against the fused tail's B4
    and B5, from the kernel entries' byte records
    (``cost_model.structural_costs`` on ``meta`` tensors: nothing runs).
    The port's B2 and B5 take the streams as a three-row table and the
    plan's ``src`` [3, 1] into it; eta and theta go by value."""
    from ..core.wire_layout import WireLayout
    from ..kernels import (dequant_mix_buffer, dequant_mix_momentum_buffer,
                           momentum_quantize_pack_buffer, momentum_sgd,
                           quantize_pack_buffer)

    lay = WireLayout.for_tree({"w": torch.empty(d, device="meta")}, bits=8)
    per, wd, ks = 4, lay.total_words, 3

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    buf = meta(1, per, wd)
    words, sblk = meta(ks, wd, dtype=torch.int32), meta(ks, wd // 512)
    w, src = meta(1, ks), meta(ks, 1, dtype=torch.int32)
    et = (0.05, 0.9)

    def tail_unfused(y, v, g, x):
        y, v = momentum_sgd(y, v, g, *et)
        y, v = momentum_sgd(y, v, g, *et)
        own = quantize_pack_buffer(y - x, sblk[:1], 8, torch.zeros_like(y))
        return dequant_mix_buffer(x, words, sblk, w, src, 8), own

    def tail_fused(y, v, g, x):
        _, v1, own = momentum_quantize_pack_buffer(
            y, v, g, x, sblk[:1], 8, et, torch.zeros_like(y))
        return dequant_mix_momentum_buffer(x, words, sblk, w, src, v1, g,
                                           et, 8), own

    return {arm: structural_costs(fn, buf, buf, buf, buf).kernel_bytes
            for arm, fn in (("unfused", tail_unfused),
                            ("fused", tail_fused))}


def fused_round_compare(smoke: bool = False, device=None) -> dict:
    """The fused round against the unfused one on a mesh of 8 shards
    (one client each): ring of 8, q8 deterministic ``eq7``, K 4, a
    quadratic loss on w [8, d]. Interleaved best-of-5 us a round, and
    the reference's roofline columns: the paper-minimum bill (K
    heavy-ball steps reading y, v, g and writing y', v', 5 f32 passes of
    m*d, plus the realized wire bytes), each arm's structural bytes of
    its first round (``cost_model.structural_costs``: every aten
    operation's operands and outputs, each kernel's buffers once) over
    that bill, and the tail's kernel bytes (:func:`tail_kernel_bytes`)."""
    dev = resolve_device(device)
    m, K = 8, 4
    d = 16384 if smoke else 65536
    iters = 5 if smoke else 20
    mesh = _test_mesh(m, dev)
    spec = MixingSpec.ring(m, self_weight=0.5)
    plan = spec.gossip_plan()
    q = _eq7(8)
    k0, k1, k2 = prng.split(prng.PRNGKey(0, device=dev), 3)
    params = {"w": prng.normal(k0, (m, d))}
    batches = {"c": prng.normal(k1, (m, K, d))}
    wire_bytes = plan_round_bits(plan, d, q) / 8.0
    bytes_min = K * 5 * 4 * (m * d) + wire_bytes
    out = {"m": m, "d": d, "K": K, "bits": 8,
           "bytes_min_per_round": bytes_min,
           "realized_wire_bytes": wire_bytes}
    tb = tail_kernel_bytes(d)
    out["tail_kernel_bytes"] = tb
    out["tail_kernel_bytes_saved_frac"] = 1.0 - tb["fused"] / tb["unfused"]
    arms_ = {}
    for arm, fuse in (("unfused", False), ("fused", True)):
        cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K, quant=q,
                             fuse_round=fuse)
        step = make_round_step(_quadratic_loss, cfg, spec, mesh=mesh,
                               with_metrics=False)
        first = []
        costs = structural_costs(lambda s, b: first.append(step(s, b)),
                                 init_round_state(params, k2, mesh=mesh),
                                 batches)
        arms_[arm] = {"step": step, "st": first[0][0], "us": float("inf")}
        out[arm] = {"bytes_moved_per_round": costs.bytes,
                    "roofline_ratio": costs.bytes / bytes_min}
    for _ in range(5):
        for arm in ("unfused", "fused"):
            a = arms_[arm]
            us, a["st"] = timeit_best(
                lambda i, st, step=a["step"]: step(st, batches)[0],
                a["st"], iters=iters, reps=1, device=dev)
            a["us"] = min(a["us"], us)
    for arm in ("unfused", "fused"):
        out[arm]["us_per_round"] = arms_[arm]["us"]
    out["fused_speedup"] = (out["unfused"]["us_per_round"]
                            / out["fused"]["us_per_round"])
    out["fused_bytes_saved_frac"] = (
        1.0 - out["fused"]["bytes_moved_per_round"]
        / out["unfused"]["bytes_moved_per_round"])
    return out


def placement_compare(smoke: bool = False) -> dict:
    """The placement pass on irregular graphs: m 64 over 8 shards, the
    block realization's boundary lane slots and q8 wire bytes under the
    contiguous layout against ``compute_placement``'s (numpy at plan
    compile time: no mesh, the same at every size). The ER arm is
    gated: the partition ships at most half the contiguous lane slots;
    the ring with chords is reported unguarded."""
    del smoke
    m, shards, d = 64, 8, 16384
    cps = m // shards
    q8 = QuantConfig(bits=8)

    def ring_with_chords(n_chords: int, seed: int) -> Graph:
        adj = np.asarray(ring_graph(m).adj).copy()
        rng = np.random.default_rng(seed)
        added = 0
        while added < n_chords:
            i, j = (int(v) for v in rng.integers(0, m, size=2))
            if i != j and not adj[i, j]:
                adj[i, j] = adj[j, i] = True
                added += 1
        return Graph(adj, name=f"ring{m}+{n_chords}chords")

    arms_ = {"er": erdos_renyi_graph(m, 0.06, seed=2),
             "ring_chords": ring_with_chords(16, seed=7)}
    out = {"m": m, "n_shards": shards, "d": d, "bits": 8}
    for name, g in arms_.items():
        plan = plan_from_support(g, name=g.name)
        pl = compute_placement(g, shards)
        cont = plan.block_plan(shards).num_wire_lane_slots
        part = plan.block_plan(shards, placement=pl).num_wire_lane_slots
        out[name] = {
            "graph": g.name,
            "directed_edges": g.num_directed_edges(),
            "contiguous_boundary_lane_slots": cont,
            "partition_boundary_lane_slots": part,
            "boundary_ratio_contiguous_over_partition": cont / max(part, 1),
            "contiguous_wire_bytes_q8": plan_round_bits(
                plan, d, q8, clients_per_shard=cps) / 8.0,
            "partition_wire_bytes_q8": plan_round_bits(
                plan, d, q8, clients_per_shard=cps, placement=pl) / 8.0,
            "contiguous_boundary_edges": g.block_boundary_edges(cps),
            "partition_boundary_edges": g.block_boundary_edges(cps,
                                                               perm=pl),
        }
    er = out["er"]
    assert (er["partition_boundary_lane_slots"]
            <= er["contiguous_boundary_lane_slots"] / 2), er
    return out


def gossip_backend_compare(smoke: bool = False, device=None,
                           capture: bool = True) -> list[tuple]:
    """Dense against sparse on ``edge_sample(ring_graph(8), 0.5)`` on a
    mesh of 8 shards: a device's wire bytes, us a round, and the
    expectation bill against the realized plan wire; then the block,
    2D-mesh, fused, telemetry and placement arms. Writes every result to
    ``GOSSIP_JSON`` and returns the reference's rows."""
    dev = resolve_device(device)
    m = 8
    d = 16384 if smoke else 65536
    iters = 10 if smoke else 20
    mesh = _test_mesh(m, dev)
    sched = TopologySchedule.edge_sample(ring_graph(m), p_edge=0.5)
    plan = sched.gossip_plan()
    x, z, key = _pair(m, d, dev)
    res = {"m": m, "d": d, "schedule": sched.name,
           "plan_steps": plan.n_steps,
           "plan_wire_edges": plan.num_directed_wire_edges}
    for bits in (32, 8):
        q = _eq7(bits)
        for impl in ("dense", "sparse"):
            arm = _wire_arm(make_mixer(sched, MixerConfig(impl=impl,
                                                          quant=q),
                                       mesh=mesh), mesh, x, z, key, iters,
                            dev)
            arm["billed_bits_per_round"] = schedule_round_bits(sched, d, q)
            if impl == "sparse":
                arm["realized_wire_bits"] = plan_round_bits(plan, d, q)
            res[f"{impl}_b{bits}"] = arm
    for bits in (32, 8):
        dn, sp = res[f"dense_b{bits}"], res[f"sparse_b{bits}"]
        res[f"wire_ratio_dense_over_sparse_b{bits}"] = (
            dn["wire_bytes_per_device"]
            / max(sp["wire_bytes_per_device"], 1e-9))
    res["speedup_sparse_over_dense_b8"] = (
        res["dense_b8"]["us_per_round"] / res["sparse_b8"]["us_per_round"])
    res["block64"] = block_gossip_compare(smoke=smoke, device=dev)
    res["mesh2d"] = mesh2d_compare(smoke=smoke, device=dev)
    res["fused"] = fused_round_compare(smoke=smoke, device=dev)
    tl = telemetry_overhead_compare(smoke=smoke, device=dev,
                                    capture=capture)
    res["telemetry"] = {k: v for k, v in tl.items() if k != "graphs"}
    res["placement"] = placement_compare(smoke=smoke)
    GOSSIP_JSON.parent.mkdir(parents=True, exist_ok=True)
    GOSSIP_JSON.write_text(json.dumps(res, indent=2))
    rows = []
    for bits in (32, 8):
        dn, sp = res[f"dense_b{bits}"], res[f"sparse_b{bits}"]
        rows.append((
            f"gossip_sparse_vs_dense_b{bits}", sp["us_per_round"],
            f"sparse_wireB={sp['wire_bytes_per_device']:.0f}|"
            f"dense_wireB={dn['wire_bytes_per_device']:.0f}|"
            f"ratio={res[f'wire_ratio_dense_over_sparse_b{bits}']:.2f}|"
            f"dense_us={dn['us_per_round']:.1f}|"
            f"billed_bits={sp['billed_bits_per_round']:.0f}|"
            f"realized_wire_bits={sp['realized_wire_bits']:.0f}"))
    blk = res["block64"]
    bsp, bdn = blk["sparse_b8"], blk["dense_b8"]
    rows.append((
        "gossip_block64_sparse_vs_dense_b8", bsp["us_per_round"],
        f"m={blk['m']}|shards={blk['n_shards']}|"
        f"block_wireB={bsp['wire_bytes_per_device']:.0f}|"
        f"dense_wireB={bdn['wire_bytes_per_device']:.0f}|"
        f"ratio={blk['wire_ratio_dense_over_block_b8']:.2f}|"
        f"boundary_lanes={blk['block_wire_lane_slots']}|"
        f"realized_wire_bits={bsp['realized_wire_bits']:.0f}"))
    m2 = res["mesh2d"]
    m1a, m2a = m2["mesh1d_b8"], m2["mesh2d_b8"]
    rows.append((
        "gossip_mesh2d_vs_1d_b8", m2a["us_per_round"],
        f"mp={m2['model_parallel']}|"
        f"wire2dB={m2a['payload_bytes_per_device']:.0f}|"
        f"wire1dB={m1a['payload_bytes_per_device']:.0f}|"
        f"ratio={m2['wire_ratio_1d_over_2d_b8']:.2f}|"
        f"fp32_ratio={m2['wire_ratio_1d_over_2d_b32']:.2f}"))
    fz = res["fused"]
    rows.append((
        "round_fused_vs_unfused_b8", fz["fused"]["us_per_round"],
        f"unfused_us={fz['unfused']['us_per_round']:.1f}|"
        f"speedup={fz['fused_speedup']:.2f}|"
        f"fused_roofline={fz['fused']['roofline_ratio']:.2f}|"
        f"unfused_roofline={fz['unfused']['roofline_ratio']:.2f}|"
        f"bytes_saved_frac={fz['fused_bytes_saved_frac']:.3f}|"
        f"bytes_min={fz['bytes_min_per_round']:.0f}"))
    rows.append((
        "round_telemetry_on_vs_off", tl["us_on"],
        f"off_us={tl['us_off']:.1f}|"
        f"overhead_ratio={tl['overhead_ratio']:.3f}"))
    for arm in ("er", "ring_chords"):
        pa = res["placement"][arm]
        rows.append((
            f"placement_{arm}_partition_vs_contiguous", 0.0,
            f"graph={pa['graph']}|"
            f"contig_lanes={pa['contiguous_boundary_lane_slots']}|"
            f"part_lanes={pa['partition_boundary_lane_slots']}|"
            f"ratio={pa['boundary_ratio_contiguous_over_partition']:.2f}|"
            f"contig_q8B={pa['contiguous_wire_bytes_q8']:.0f}|"
            f"part_q8B={pa['partition_wire_bytes_q8']:.0f}"))
    return rows


def run(*, smoke: bool = False, device=None):
    """The runner's entry: every schedule's arm and the gossip backends'
    comparison, as CSV rows (name, us a round, derived)."""
    rows = [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
    rows.extend(gossip_backend_compare(smoke=smoke, device=device))
    return rows
