"""Time-varying gossip: a static ring against sampled, partial and
random-walk schedules — the in-process rows of the reference's
``benchmarks/bench_timevarying.py`` (``run``'s loop over its
``schedules``) on the port: us a round, loss, consensus distance, bits a
round and accuracy of the 2NN on the synthetic task.

The reference's mesh and subprocess comparisons (dense against sparse
backend bytes, block, 2D-mesh, fused, telemetry and placement arms) need
the multi-device slice (ROADMAP A17) and are not run here.
"""
from __future__ import annotations

from ..core import (MixingSpec, TopologySchedule, dfedavgm_round_bits,
                    schedule_round_bits)
from ..core.topology import erdos_renyi_graph, ring_graph
from .common import train_dfedavgm_2nn

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


def run(*, smoke: bool = False, device=None):
    return [(name, r["us_per_round"], r["derived"])
            for name, r in arms(smoke=smoke, device=device)]
