"""Port parity for the block plans and the placement pass: the port's
numpy copies (``repro_torch.core.gossip_plan``: ``block_plan``,
``BlockPlan``, ``BlockSubStep``, ``Placement``, ``compute_placement``,
``GossipPlan.placed``; ``Graph.block_boundary_edges``) and the block and
placed bills of ``comm_cost.plan_round_bits`` against the JAX package's
on ring, torus and Erdős–Rényi supports at several shard counts.

Contract: every array and count equal, exactly — the same code on the
same inputs, ``compute_placement``'s permutation included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as J  # noqa: E402
from repro.core import comm_cost as jcc  # noqa: E402
from repro.core import gossip_plan as jgp  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import comm_cost as tcc  # noqa: E402
from repro_torch.core import gossip_plan as tgp  # noqa: E402

D = 199_210     # the 2NN's parameter count

SUPPORTS = {
    "ring32": lambda L: L.MixingSpec.ring(32, 0.5),
    "torus4x8": lambda L: L.MixingSpec.torus(4, 8),
    "er32": lambda L: L.MixingSpec.dense(L.erdos_renyi_graph(32, 0.15,
                                                             seed=1)),
    "er64": lambda L: L.MixingSpec.dense(L.erdos_renyi_graph(64, 0.06,
                                                             seed=2)),
}
SHARDS = [1, 2, 4, 8, 32]


def same_block_plan(bp, jbp):
    assert (bp.m, bp.n_shards, bp.m_local) == (jbp.m, jbp.n_shards,
                                               jbp.m_local)
    assert np.array_equal(bp.intra_src, jbp.intra_src)
    assert len(bp.substeps) == len(jbp.substeps)
    for subs, jsubs in zip(bp.substeps, jbp.substeps):
        assert len(subs) == len(jsubs)
        for u, ju in zip(subs, jsubs):
            assert u.pairs == ju.pairs and u.width == ju.width
            assert np.array_equal(u.send_lanes, ju.send_lanes)
            assert np.array_equal(u.recv_lanes, ju.recv_lanes)
    assert bp.num_wire_lane_slots == jbp.num_wire_lane_slots
    assert bp.num_collectives == jbp.num_collectives


@pytest.mark.parametrize("name", list(SUPPORTS))
def test_block_plans_and_placement_match_jax(name):
    spec, jspec = SUPPORTS[name](T), SUPPORTS[name](J)
    plan, jplan = spec.gossip_plan(), jspec.gossip_plan()
    for n in SHARDS:
        if spec.m % n:
            continue
        same_block_plan(plan.block_plan(n), jplan.block_plan(n))
        pl = tgp.compute_placement(spec.graph, n)
        jpl = jgp.compute_placement(jspec.graph, n)
        assert np.array_equal(pl.perm, jpl.perm)
        assert np.array_equal(pl.inv, jpl.inv)
        assert (pl.m, pl.m_local, pl.is_identity) == (jpl.m, jpl.m_local,
                                                      jpl.is_identity)
        assert np.array_equal(pl.shard_of(), jpl.shard_of())
        assert pl.boundary_edges(spec.graph.adj) == \
            jpl.boundary_edges(jspec.graph.adj)
        cps = spec.m // n
        for perm in (None, pl):
            jperm = None if perm is None else jpl
            assert spec.graph.block_boundary_edges(cps, perm=perm) == \
                jspec.graph.block_boundary_edges(cps, perm=jperm)
        placed, jplaced = plan.placed(pl), jplan.placed(jpl)
        assert np.array_equal(placed.src, jplaced.src)
        assert np.array_equal(placed.lane_to_client, jplaced.lane_to_client)
        assert np.array_equal(placed.w_self, jplaced.w_self)
        assert np.array_equal(placed.w_steps, jplaced.w_steps)
        assert placed.name == jplaced.name
        assert np.array_equal(placed.as_matrix(), jplaced.as_matrix())
        assert np.array_equal(placed.as_matrix(), plan.as_matrix())
        same_block_plan(plan.block_plan(n, placement=pl),
                        jplan.block_plan(n, placement=jpl))
        contiguous = tgp.Placement.contiguous(spec.m, n)
        assert contiguous.is_identity and contiguous.name == "contiguous"


def test_placement_lowers_the_er64_cut_by_half():
    """The reference's placement arm (``tests/test_placement.py``): on
    ER(64, 0.06, seed 2) over 8 shards the placed block realization
    ships at most half the contiguous one's boundary lanes."""
    spec = SUPPORTS["er64"](T)
    pl = tgp.compute_placement(spec.graph, 8)
    plan = spec.gossip_plan()
    slots = plan.block_plan(8).num_wire_lane_slots
    placed = plan.block_plan(8, placement=pl).num_wire_lane_slots
    assert 2 * placed <= slots, (placed, slots)


def test_placed_weight_gather_matches_jax():
    """A placed structure-only plan gathers lane p's weights from a
    client-space W at (client(p), client(src)), as the reference's."""
    g, jg = (L.erdos_renyi_graph(16, 0.3, seed=4) for L in (T, J))
    plan = tgp.plan_from_support(g)
    jplan = jgp.plan_from_support(jg)
    pl = tgp.compute_placement(g, 4)
    jpl = jgp.compute_placement(jg, 4)
    W = J.metropolis_hastings(jg).astype(np.float32)
    ws, wk = plan.placed(pl).gather_weights(torch.from_numpy(W))
    jws, jwk = jplan.placed(jpl).gather_weights(W)
    assert np.array_equal(ws.numpy(), np.asarray(jws))
    assert np.array_equal(wk.numpy(), np.asarray(jwk))


QUANTS = {"fp32": None, "q8": dict(bits=8),
          "q8_eq7": dict(bits=8, delta_mode="eq7"), "q4": dict(bits=4)}


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("name", list(SUPPORTS))
def test_block_and_placed_bills_match_jax(name, quant):
    spec, jspec = SUPPORTS[name](T), SUPPORTS[name](J)
    kw = QUANTS[quant]
    q = None if kw is None else T.QuantConfig(**kw)
    jq = None if kw is None else J.QuantConfig(**kw)
    plan, jplan = spec.gossip_plan(), jspec.gossip_plan()
    for n in SHARDS:
        if spec.m % n:
            continue
        cps = spec.m // n
        pl = tgp.compute_placement(spec.graph, n)
        jpl = jgp.compute_placement(jspec.graph, n)
        for rep in (False, True):
            assert tcc.plan_round_bits(
                plan, D, q, rep, clients_per_shard=cps) == \
                jcc.plan_round_bits(jplan, D, jq, rep,
                                    clients_per_shard=cps)
            assert tcc.plan_round_bits(
                plan, D, q, rep, clients_per_shard=cps, placement=pl) == \
                jcc.plan_round_bits(jplan, D, jq, rep,
                                    clients_per_shard=cps, placement=jpl)


def test_cycle_block_bills_match_jax():
    """A cycle's per-member plans, billed block-wise round by round and
    on average."""
    s = T.TopologySchedule.cycle([T.MixingSpec.ring(16, 0.5),
                                  T.MixingSpec.torus(4, 4)])
    js = J.TopologySchedule.cycle([J.MixingSpec.ring(16, 0.5),
                                   J.MixingSpec.torus(4, 4)])
    q, jq = T.QuantConfig(bits=8), J.QuantConfig(bits=8)
    for t in (None, 0, 1, 2):
        for cps in (2, 4, 8):
            assert tcc.plan_round_bits(s.gossip_plans(), D, q, True, t=t,
                                       clients_per_shard=cps) == \
                jcc.plan_round_bits(js.gossip_plans(), D, jq, True, t=t,
                                    clients_per_shard=cps)


def test_block_plan_refusals_match_jax():
    plan, jplan = (L.MixingSpec.ring(12, 0.5).gossip_plan() for L in (T, J))
    for bp in (lambda: plan.block_plan(5), lambda: tgp.Placement(
            perm=np.arange(12), n_shards=5),
            lambda: tgp.Placement(perm=np.zeros(12, int), n_shards=3),
            lambda: plan.placed(tgp.compute_placement(
                T.ring_graph(12), 3)).placed(tgp.compute_placement(
                    T.ring_graph(12), 3))):
        with pytest.raises(ValueError):
            bp()
    with pytest.raises(ValueError):
        jplan.block_plan(5)
    with pytest.raises(ValueError, match="must divide"):
        tcc.plan_round_bits(plan, D, clients_per_shard=5)
