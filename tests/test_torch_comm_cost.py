"""Port parity: ``repro_torch.core.comm_cost`` against the JAX package's
``core/comm_cost.py`` — every bill, the bottleneck, Proposition 3 and the
ledger, on ring and complete graphs at the 2NN's d = 199 210 and no, 8-
and 4-bit quantization; what is neither a spec nor a schedule, a shard
size that does not divide m, a model-parallel degree below 1 and an
async bill without its live edges are refused.

Contract: equal (integers, and floats computed by the same expressions).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CommLedger as JCommLedger  # noqa: E402
from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import comm_cost as jcc  # noqa: E402
from repro_torch.core import (CommLedger, MixingSpec, QuantConfig,  # noqa: E402,E501
                              round_comm_bits)
from repro_torch.core import comm_cost as tcc  # noqa: E402

torch.set_num_threads(1)

D = 199_210
M = 16
GRAPHS = {"ring": (lambda: MixingSpec.ring(M, 0.5),
                   lambda: JMixingSpec.ring(M, 0.5)),
          "complete": (lambda: MixingSpec.complete(M),
                       lambda: JMixingSpec.complete(M))}
QUANTS = {"fp32": None, "q8": dict(bits=8), "q4": dict(bits=4),
          "q8-eq7": dict(bits=8, delta_mode="eq7")}


def quants(q):
    return ((None, None) if q is None
            else (QuantConfig(**q), JQuantConfig(**q)))


@pytest.mark.parametrize("q", QUANTS.values(), ids=QUANTS.keys())
@pytest.mark.parametrize("graph", GRAPHS.keys())
def test_round_bits_equal_the_reference(graph, q):
    spec, jspec = (f() for f in GRAPHS[graph])
    tq, jq = quants(q)
    assert tcc.dfedavgm_round_bits(spec.graph, D, tq) == \
        jcc.dfedavgm_round_bits(jspec.graph, D, jq)
    assert round_comm_bits(spec, D, tq) == \
        tcc.dfedavgm_round_bits(spec.graph, D, tq)
    assert tcc.dsgd_round_bits(spec.graph, D) == \
        jcc.dsgd_round_bits(jspec.graph, D)
    assert tcc.bottleneck_bits("dfedavgm", D, graph=spec.graph, quant=tq) \
        == jcc.bottleneck_bits("dfedavgm", D, graph=jspec.graph, quant=jq)
    for live in (0, 3, 2.5, 32):
        assert tcc.async_event_bits(D, tq, live_edges=live) == \
            jcc.async_event_bits(D, jq, live_edges=live)
    plan, jplan = spec.gossip_plan(), jspec.gossip_plan()
    assert plan.num_directed_wire_edges == jplan.num_directed_wire_edges
    for replicas in (False, True):
        for mp in (1, 2):
            assert tcc.plan_round_bits(plan, D, tq, replicas,
                                       model_parallel=mp) == \
                jcc.plan_round_bits(jplan, D, jq, replicas,
                                    model_parallel=mp)
    for t in (None, 0, 1):
        assert tcc.plan_round_bits([plan, plan], D, tq, t=t) == \
            jcc.plan_round_bits([jplan, jplan], D, jq, t=t)


@pytest.mark.parametrize("m", [4, 16])
def test_fedavg_and_bottleneck_equal_the_reference(m):
    assert tcc.fedavg_round_bits(m, D) == jcc.fedavg_round_bits(m, D)
    assert tcc.bottleneck_bits("fedavg", D, m=m) == \
        jcc.bottleneck_bits("fedavg", D, m=m)


def test_prop3_equals_the_reference():
    for d in (1, 10, 100, D):
        for b in (1, 2, 4, 8, 13, 14, 16):
            assert tcc.prop3_quantization_wins(d, b) == \
                jcc.prop3_quantization_wins(d, b)
    kw = dict(theta=0.9, L=2.0, B=1.5, s=1e-3, d=D, K=4,
              f0_minus_fmin=2.3, sigma_l=0.7, sigma_g=0.4)
    assert tcc.prop3_epsilon_floor(**kw) == jcc.prop3_epsilon_floor(**kw)


@pytest.mark.parametrize("q", QUANTS.values(), ids=QUANTS.keys())
def test_comm_ledger_equals_the_reference(q):
    tq, jq = quants(q)
    pairs = [(CommLedger.for_dfedavgm(MixingSpec.ring(M, 0.5), D, tq),
              JCommLedger.for_dfedavgm(JMixingSpec.ring(M, 0.5), D, jq)),
             (CommLedger.for_fedavg(M, D), JCommLedger.for_fedavg(M, D)),
             (CommLedger.for_dsgd(MixingSpec.ring(M), D),
              JCommLedger.for_dsgd(JMixingSpec.ring(M), D))]
    for t, j in pairs:
        assert t.bits_per_round == j.bits_per_round
        for led in (t, j):
            led.tick()
            led.tick(3)
            led.add_bits(1234.5)
        assert (t.rounds, t.extra_bits) == (j.rounds, j.extra_bits) == \
            (4, 1234.5)
        assert t.total_bits == j.total_bits
        assert t.total_megabytes == j.total_megabytes
    assert CommLedger(10.0).total_bits == 0


def test_unported_paths_raise_naming_their_roadmap_items():
    spec = MixingSpec.ring(M, 0.5)
    # Schedules are billed now; what is neither a spec nor a schedule is
    # refused as in the reference.
    for sched_bits, ledger in ((tcc.schedule_round_bits,
                                CommLedger.for_dfedavgm),
                               (jcc.schedule_round_bits,
                                jcc.CommLedger.for_dfedavgm)):
        with pytest.raises(AttributeError):
            sched_bits(object(), D)
        with pytest.raises(AttributeError):
            ledger(object(), D, None)
    # The block and placed bills are ported (test_torch_placement.py
    # holds them against the reference's); a shard size that does not
    # divide m is refused as there.
    with pytest.raises(ValueError, match="must divide"):
        tcc.plan_round_bits(spec.gossip_plan(), D, clients_per_shard=5)
    with pytest.raises(ValueError, match="model_parallel"):
        tcc.plan_round_bits(spec.gossip_plan(), D, model_parallel=0)
    with pytest.raises(ValueError, match="live_edges"):
        tcc.async_event_bits(D)
    assert np.isfinite(tcc.plan_round_bits(spec.gossip_plan(), D))
