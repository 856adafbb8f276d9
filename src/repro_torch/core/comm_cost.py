"""Communication-cost accounting + the Proposition-3 savings condition —
the JAX package's ``core/comm_cost.py`` (pure Python) for static specs
and time-varying schedules, on one device or on a 1D client mesh.

Paper formulas (§3.2, §5.7):
  unquantized, per round:  32 d * sum_i deg(i)            bits
  quantized,   per round:  (32 + d b) * sum_i deg(i)      bits
  FedAvg, per round:       2 * 32 d * m                   bits
      (server -> m clients broadcast + m clients -> server upload)

Proposition 3: with stepsize eta = 1/(L K sqrt(T)) and no overflow,
quantized DFedAvgM beats 32-bit DFedAvgM in total bits to reach error
epsilon iff   (32 + d b) * 9/4 < 32 d      (and epsilon is not too small:
epsilon > (1-theta) sqrt(3 L B s) d^{1/4} sqrt(2(f0 - fmin) + 8 sigma_l^2/K
+ 32 sigma_g^2 + 64 theta^2 (sigma_l^2+B^2)/(1-theta)^2) ).
"""
from __future__ import annotations

import dataclasses
import math

from .quantize import QuantConfig, message_bits
from .topology import Graph, MixingSpec, TopologySchedule

__all__ = ["dfedavgm_round_bits", "fedavg_round_bits", "dsgd_round_bits",
           "schedule_round_bits", "plan_round_bits", "async_event_bits",
           "bottleneck_bits", "prop3_quantization_wins",
           "prop3_epsilon_floor", "CommLedger"]

def dfedavgm_round_bits(graph: Graph, d: int,
                        quant: QuantConfig | None = None) -> int:
    """Bits one synchronous DFedAvgM round moves on a STATIC graph: every
    directed edge carries one ``message_bits`` payload."""
    qc = quant if quant is not None else QuantConfig(bits=32)
    return message_bits(d, qc) * graph.num_directed_edges()


def schedule_round_bits(schedule: TopologySchedule, d: int,
                        quant: QuantConfig | None = None,
                        t: int | None = None) -> float:
    """Expected bits per round under a time-varying topology: only live
    directed edges pay ``message_bits`` (inactive clients send nothing).
    Exact for the deterministic kinds; an expectation for sampled ones."""
    qc = quant if quant is not None else QuantConfig(bits=32)
    return message_bits(d, qc) * schedule.expected_directed_edges(t)


def plan_round_bits(plan, d: int, quant: QuantConfig | None = None,
                    count_lemma5_replicas: bool = False,
                    t: int | None = None,
                    clients_per_shard: int = 1,
                    placement=None,
                    model_parallel: int = 1) -> float:
    """REALIZED wire diagnostic of a compiled
    :class:`~repro_torch.core.gossip_plan.GossipPlan`: one round moves
    ``message_bits`` across every directed *plan* edge. The algorithm's
    bill is :func:`dfedavgm_round_bits`; this is the wire the plan
    executes.

    ``plan`` may be a sequence of plans (a cycle schedule's members):
    round ``t`` moves member ``t mod n``'s edges, ``t=None`` averages.
    ``count_lemma5_replicas`` adds the 32-bit replica row the ``lemma5``
    recursion ships beside the words on a mesh. ``clients_per_shard`` > 1
    bills the block-sharded realization instead: only the plan's boundary
    lane slots cross (padded slots included; intra-block edges are lane
    gathers and cost nothing); ``placement`` bills the placed block
    realization. ``model_parallel`` > 1 bills one device column of a 2D
    mesh (1/model_parallel of the wire).
    """
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    if isinstance(plan, (list, tuple)):
        plans = list(plan)
        if t is not None:
            plans = [plans[int(t) % len(plans)]]
        return sum(plan_round_bits(p, d, quant, count_lemma5_replicas,
                                   clients_per_shard=clients_per_shard,
                                   placement=placement,
                                   model_parallel=model_parallel)
                   for p in plans) / len(plans)
    qc = quant if quant is not None else QuantConfig(bits=32)
    per_edge = message_bits(d, qc)
    if count_lemma5_replicas and qc.enabled and qc.delta_mode == "lemma5":
        per_edge += 32 * d
    if clients_per_shard > 1:
        if plan.m % clients_per_shard:
            raise ValueError(f"clients_per_shard={clients_per_shard} "
                             f"must divide m={plan.m}")
        bp = plan.block_plan(plan.m // clients_per_shard,
                             placement=placement)
        return per_edge * bp.num_wire_lane_slots / model_parallel
    return per_edge * plan.num_directed_wire_edges / model_parallel


def async_event_bits(d: int, quant: QuantConfig | None = None,
                     live_edges: float | None = None, plan=None) -> float:
    """Bits ONE asynchronous event bills: the event's realized live
    directed edges each carry one message (pass the engine's
    ``live_edges``). ``plan`` is accepted for call-site compatibility
    and does not change the bill."""
    del plan
    if live_edges is None:
        raise ValueError("async_event_bits needs the event's live_edges "
                         "(realized live directed edge count; plan-based "
                         "wire billing moved to plan_round_bits)")
    qc = quant if quant is not None else QuantConfig(bits=32)
    return message_bits(d, qc) * float(live_edges)


def dsgd_round_bits(graph: Graph, d: int) -> int:
    """DSGD gossips raw fp32 params every round: 32d bits per edge."""
    return 32 * d * graph.num_directed_edges()


def fedavg_round_bits(m: int, d: int) -> int:
    """FedAvg's hub bill: every client up- AND down-links fp32 params."""
    return 2 * 32 * d * m


def bottleneck_bits(kind: str, d: int, *, m: int = 0,
                    graph: Graph | None = None,
                    quant: QuantConfig | None = None) -> int:
    """Bits through the BUSIEST node per round: FedAvg funnels 2*32*d*m
    bits through the server; a decentralized client moves deg(i) *
    message_bits each way."""
    if kind == "fedavg":
        return 2 * 32 * d * m
    qc = quant if quant is not None else QuantConfig(bits=32)
    dmax = int(graph.degrees().max())
    return 2 * dmax * message_bits(d, qc)   # send + receive per neighbor


def prop3_quantization_wins(d: int, b: int) -> bool:
    """(32 + d b) * 9/4 < 32 d  — the sufficient bit-count condition."""
    return (32 + d * b) * 9 / 4 < 32 * d


def prop3_epsilon_floor(*, theta: float, L: float, B: float, s: float,
                        d: int, K: int, f0_minus_fmin: float,
                        sigma_l: float, sigma_g: float) -> float:
    """The epsilon lower bound of Proposition 3 (quantization helps for any
    target error above this floor)."""
    inner = (2.0 * f0_minus_fmin + 8.0 * sigma_l ** 2 / K
             + 32.0 * sigma_g ** 2
             + 64.0 * theta ** 2 * (sigma_l ** 2 + B ** 2) / (1 - theta) ** 2)
    return ((1 - theta) * math.sqrt(3 * L * B * s) * d ** 0.25
            * math.sqrt(inner))


@dataclasses.dataclass
class CommLedger:
    """Running bit counter attached to a training loop
    (``bits_per_round`` may be fractional: a schedule's expectation)."""

    bits_per_round: float
    rounds: int = 0
    extra_bits: float = 0.0   # variable per-event bills (async engine)

    @staticmethod
    def for_dfedavgm(spec: MixingSpec | TopologySchedule, d: int,
                     quant: QuantConfig | None, plan=None) -> "CommLedger":
        """The paper's §3.2 live-directed-edge bill (exact for a static
        spec, the expectation for a sampled schedule), for either mixer
        backend (``plan`` does not change it)."""
        del plan
        if isinstance(spec, TopologySchedule):
            return CommLedger(schedule_round_bits(spec, d, quant))
        return CommLedger(dfedavgm_round_bits(spec.graph, d, quant))

    @staticmethod
    def for_fedavg(m: int, d: int) -> "CommLedger":
        return CommLedger(fedavg_round_bits(m, d))

    @staticmethod
    def for_dsgd(spec: MixingSpec, d: int) -> "CommLedger":
        return CommLedger(dsgd_round_bits(spec.graph, d))

    def tick(self, n: int = 1) -> None:
        self.rounds += n

    def add_bits(self, bits: float) -> None:
        """Bill a variable-size event (its realized live edges)."""
        self.extra_bits += float(bits)

    @property
    def total_bits(self) -> float:
        return self.bits_per_round * self.rounds + self.extra_bits

    @property
    def total_megabytes(self) -> float:
        return self.total_bits / 8 / 1e6
