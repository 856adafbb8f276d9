"""Time-varying gossip: a static ring against sampled, partial and
random-walk schedules — the in-process rows of the reference's
``benchmarks/bench_timevarying.py`` (``run``'s loop over its
``schedules``) on the port: us a round, loss, consensus distance, bits a
round and accuracy of the 2NN on the synthetic task.

``telemetry_overhead_compare`` is the reference's telemetry arm: the
round with ``with_telemetry=True`` against the plain round (row
``round_telemetry_on_vs_off``). The reference's mesh and subprocess
comparisons (dense against sparse backend bytes, block, 2D-mesh, fused
and placement arms) wait for the 2D mesh, A17's next slice (ROADMAP),
and are not run here.
"""
from __future__ import annotations

from .. import prng
from ..core import (DFedAvgMConfig, MixingSpec, QuantConfig,
                    TopologySchedule, capture_step, dfedavgm_round_bits,
                    init_round_state, make_round_step, schedule_round_bits)
from ..core.topology import erdos_renyi_graph, ring_graph
from ..data import FederatedDataset, classification_dataset
from ..device import resolve_device
from .common import loss_2nn, stacked_2nn, timeit_best, train_dfedavgm_2nn

M, K, B, ROUNDS = 16, 4, 32, 30
SMOKE_M, SMOKE_K, SMOKE_B, SMOKE_ROUNDS = 4, 2, 8, 2


def schedules(m: int, rounds: int, seed: int = 0):
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


def run(*, smoke: bool = False, device=None):
    rows = [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
    tl = telemetry_overhead_compare(smoke=smoke, device=device)
    rows.append(("round_telemetry_on_vs_off", tl["us_on"],
                 f"off_us={tl['us_off']:.1f}|"
                 f"overhead_ratio={tl['overhead_ratio']:.3f}"))
    return rows
