"""Port parity for the topology layer: the graph builders, the torus
spec, the plan compilers, the per-round weight gather, every
``TopologySchedule`` kind's sampled events, the schedule bills and the
schedule mixers (``make_scheduled_mixer``, ``make_event_mixer``), against
the JAX package (``repro.core``) on the same inputs; the reference's
mixers on a one-device client mesh (sparse, planar wire, Pallas in
interpret mode).

Contracts: graphs, plans, walks, ``active`` masks and tokens equal;
a sampled ``W_t`` within 2 ulp (Metropolis row sums reduce in another
order than XLA's), doubly stochastic, with inactive rows ``e_i``;
gathered weights equal (a pure selection); bills equal; mixer outputs
within K + 1 ulp of the parameter magnitude, words and scales bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import core as J  # noqa: E402
from repro.core import gossip_plan as jgp  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core import comm_cost as tcc  # noqa: E402
from repro_torch.core import gossip_plan as tgp  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M = 8


def as_i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def ulps(a, b) -> int:
    """Largest distance in f32 ulps between two arrays."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    a = np.where(a < 0, -(a & 0x7FFFFFFF), a)
    b = np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(a - b).max())


GRAPHS = {
    "ring8": lambda L: L.ring_graph(8),
    "ring2": lambda L: L.ring_graph(2),
    "chain6": lambda L: L.chain_graph(6),
    "torus4x4": lambda L: L.torus_graph(4, 4),
    "torus2x3": lambda L: L.torus_graph(2, 3),
    "complete5": lambda L: L.complete_graph(5),
    "star7": lambda L: L.star_graph(7),
    "er16": lambda L: L.erdos_renyi_graph(16, 0.4, seed=0),
    "er10_s3": lambda L: L.erdos_renyi_graph(10, 0.3, seed=3),
}


@pytest.mark.parametrize("name", list(GRAPHS))
def test_graph_builders_match_jax(name):
    g, jg = GRAPHS[name](T), GRAPHS[name](J)
    assert np.array_equal(g.adj, jg.adj) and g.name == jg.name
    assert g.is_connected() == jg.is_connected()
    for i in range(g.m):
        assert np.array_equal(g.neighbors(i), jg.neighbors(i))
    if g.is_connected():
        W = T.metropolis_hastings(g)
        assert T.mixing_lambda(W) == J.mixing_lambda(J.metropolis_hastings(jg))
        assert T.spectral_gap(W) == J.spectral_gap(J.metropolis_hastings(jg))


@pytest.mark.parametrize("shape", [(4, 4), (2, 4), (3, 5), (4, 8)])
def test_torus_spec_and_steps_match_jax(shape):
    s, js = T.MixingSpec.torus(*shape), J.MixingSpec.torus(*shape)
    assert np.array_equal(s.W, js.W) and s.kind == js.kind == "torus"
    assert s.torus_shape == js.torus_shape and s.lam == js.lam
    assert np.array_equal(tgp.torus_steps(*shape), jgp.torus_steps(*shape))
    p, jp = s.gossip_plan(), js.gossip_plan()
    assert np.array_equal(p.src, jp.src) and p.name == jp.name
    assert np.array_equal(p.w_self, jp.w_self)
    assert np.array_equal(p.w_steps, jp.w_steps)
    assert p.max_degree == jp.max_degree
    assert np.array_equal(p.as_matrix(), jp.as_matrix())
    assert np.array_equal(p.as_matrix(), s.W)


@pytest.mark.parametrize("name", ["ring8", "torus4x4", "er16", "star7"])
def test_plan_from_support_and_matrix_match_jax(name):
    g, jg = GRAPHS[name](T), GRAPHS[name](J)
    p, jp = tgp.plan_from_support(g, name=name), jgp.plan_from_support(
        jg, name=name)
    assert np.array_equal(p.src, jp.src) and p.name == jp.name
    assert not p.is_static and p.max_degree == jp.max_degree
    W = T.metropolis_hastings(g)
    q, jq = tgp.plan_from_matrix(W, name), jgp.plan_from_matrix(W, name)
    assert np.array_equal(q.src, jq.src)
    assert np.array_equal(q.w_self, jq.w_self)
    assert np.array_equal(q.w_steps, jq.w_steps)
    assert np.allclose(q.as_matrix(), W, rtol=0, atol=1e-15)


def schedules(L, m=M):
    """Every kind and option, in the port (L = T) or the reference."""
    ring = L.ring_graph(m)
    er = L.erdos_renyi_graph(m, 0.5, seed=1)
    return {
        "constant": L.TopologySchedule.constant(L.MixingSpec.ring(m, 0.5)),
        "edge_sample": L.TopologySchedule.edge_sample(er, 0.5),
        "partial": L.TopologySchedule.partial(ring, 0.6),
        "partial_exact": L.TopologySchedule.partial(ring, 0.5, exact=True),
        "partial_cap": L.TopologySchedule.partial(ring, 0.6, cap_slack=0),
        "walk": L.TopologySchedule.random_walk(er, horizon=5, seed=2),
        "walk_stateful": L.TopologySchedule.random_walk(er, stateful=True,
                                                        start=3),
        "cycle": L.TopologySchedule.cycle([L.MixingSpec.ring(m, 0.5),
                                           L.MixingSpec.torus(2, m // 2)]),
    }


KINDS = list(schedules(T))


@pytest.mark.parametrize("kind", KINDS)
def test_schedule_structure_matches_jax(kind):
    s, js = schedules(T)[kind], schedules(J)[kind]
    assert s.name == js.name
    for attr in ("is_stochastic", "is_stateful", "gates_participation",
                 "static_active_count", "n_active", "n_cap"):
        assert getattr(s, attr) == getattr(js, attr), attr
    if s.walk is not None:
        assert np.array_equal(s.walk, js.walk)
    assert np.array_equal(s.support_graph().adj, js.support_graph().adj)
    for p, jp in zip(s.gossip_plans(), js.gossip_plans()):
        assert np.array_equal(p.src, jp.src)
    for t in (None, 0, 1, 2):
        assert s.expected_directed_edges(t) == js.expected_directed_edges(t)


@pytest.mark.parametrize("kind", KINDS)
def test_events_match_jax_over_8_rounds(kind):
    """round_event / token_event over 8 rounds: active and the token
    equal, W_t within 2 ulp, symmetric, doubly stochastic, inactive rows
    e_i, zero off the live edge set; key_q equal."""
    s, js = schedules(T)[kind], schedules(J)[kind]
    jkey, key = jax.random.PRNGKey(5), prng.PRNGKey(5)
    tok = s.init_token() if s.is_stateful else None
    jtok = js.init_token() if js.is_stateful else None
    for t in range(8):
        jkey, jk = jax.random.split(jkey)
        key, k = prng.split(key)
        if s.is_stateful:
            jW, ja, jq, jtok = js.token_event(jk, jtok)
            W, a, q, tok = s.token_event(k, tok)
            assert int(tok) == int(jtok)
        else:
            jW, ja, jq = js.round_event(jk, t)
            W, a, q = s.round_event(k, t)
        assert np.array_equal(a.numpy(), np.asarray(ja)), t
        assert np.array_equal(q.numpy(), as_i64(jq)), t
        assert W.dtype == torch.float32 and ulps(W.numpy(), jW) <= 2, t
        Wn = W.numpy().astype(np.float64)
        assert np.array_equal(Wn, Wn.T)
        assert np.allclose(Wn.sum(1), 1.0, atol=1e-6)
        off = (Wn != 0) & ~np.eye(s.m, dtype=bool)
        live = np.outer(a.numpy(), a.numpy()) > 0
        assert not (off & ~live).any()
        for i in np.nonzero(a.numpy() == 0)[0]:
            assert np.array_equal(Wn[i], np.eye(s.m)[i])


def test_cycle_reads_a_device_round_index():
    """A cycle (and a precomputed walk) picks its event by a 0-dim int
    tensor as by a host int: the captured round's index."""
    for kind in ("cycle", "walk"):
        s = schedules(T)[kind]
        for t in range(7):
            W, a = s.sample_w(prng.PRNGKey(0), t)
            Wd, ad = s.sample_w(prng.PRNGKey(0), torch.tensor(t))
            assert torch.equal(W, Wd) and torch.equal(a, ad)


def test_metropolis_weights_from_adjacency_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        a = np.triu(rng.random((M, M)) < 0.4, 1)
        a = (a | a.T).astype(np.float32)
        got = T.metropolis_weights_from_adjacency(torch.from_numpy(a))
        want = J.metropolis_weights_from_adjacency(jnp.asarray(a))
        assert ulps(got.numpy(), want) <= 2


@pytest.mark.parametrize("kind", ["edge_sample", "partial_cap", "cycle"])
def test_gather_weights_match_jax(kind):
    """A sampled W_t's per-step weights (idle slots 0) are a selection,
    so equal; on the device-side table the mixers use too."""
    s, js = schedules(T)[kind], schedules(J)[kind]
    W, _, _ = s.round_event(prng.PRNGKey(9), 1)
    p, jp = s.gossip_plan(), js.gossip_plan()
    ws, wk = p.gather_weights(W)
    jws, jwk = jp.gather_weights(jnp.asarray(W.numpy()))
    assert np.array_equal(ws.numpy(), np.asarray(jws))
    assert np.array_equal(wk.numpy(), np.asarray(jwk))
    from repro_torch.core.mixing import _PlanTables
    tab = _PlanTables(p, torch.device("cpu"))
    live = [k for k in range(p.n_steps) if p.wire_pairs(k)]
    want = np.stack([np.asarray(jws)] + [np.asarray(jwk)[k] for k in live],
                    axis=1)
    got = tab.weights(W)
    assert got.is_contiguous() and tab.src.is_contiguous()  # B2's operands
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bits", [None, 8, 2])
def test_schedule_bills_match_jax(kind, bits):
    s, js = schedules(T)[kind], schedules(J)[kind]
    q = None if bits is None else T.QuantConfig(bits=bits)
    jq = None if bits is None else J.QuantConfig(bits=bits)
    d = 199210
    for t in (None, 0, 1):
        assert T.schedule_round_bits(s, d, q, t) == \
            J.schedule_round_bits(js, d, jq, t)
        assert T.round_comm_bits(s, d, q, t) == J.round_comm_bits(js, d, jq,
                                                                  t)
    assert T.CommLedger.for_dfedavgm(s, d, q).bits_per_round == \
        J.CommLedger.for_dfedavgm(js, d, jq).bits_per_round
    plans = s.gossip_plans()
    assert tcc.plan_round_bits(plans, d, q, t=1) == J.plan_round_bits(
        js.gossip_plans(), d, jq, t=1)


def test_schedule_refuses_tables_from_another_device():
    s = schedules(T)["walk_stateful"]
    with pytest.raises(ValueError, match="must be on"):
        s.token_event(prng.PRNGKey(0), torch.tensor(0, device="meta"))


SHAPES = {"w1": (32, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = {n: (0.1 * rng.normal(size=(M,) + s)).astype(np.float32)
         for n, s in SHAPES.items()}
    z = {n: a + (1e-2 * rng.normal(size=a.shape)).astype(np.float32)
         for n, a in x.items()}
    return x, z


def ulp_atol(k: int) -> float:
    """K + 1 ulp at the parameters' magnitude (|x| < 0.5)."""
    return (k + 1) * float(np.spacing(np.float32(0.5)))


MIXER_KINDS = ["edge_sample", "partial_cap", "walk", "cycle", "constant"]


@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "q8"])
@pytest.mark.parametrize("kind", MIXER_KINDS)
def test_scheduled_mixer_matches_jax(kind, bits):
    """make_scheduled_mixer on the plan realization against the JAX one
    on a one-device mesh (sparse, planar wire) for three rounds of
    events, the cycle's padded tables against its per-member switch:
    outputs within K + 1 ulp, active equal; and the words and scales
    of the gated delta bitwise."""
    s, js = schedules(T)[kind], schedules(J)[kind]
    q = None if bits is None else T.QuantConfig(bits=bits)
    jq = None if bits is None else J.QuantConfig(bits=bits)
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jmix = jax.jit(J.make_scheduled_mixer(
        js, J.MixerConfig(impl="sparse", quant=jq, wire="planar"),
        mesh=mesh))
    mix = T.make_scheduled_mixer(s, T.MixerConfig(quant=q), device="cpu")
    k_max = max(max(p.n_steps for p in s.gossip_plans()) + 1, 3)
    for t in range(3):
        x, z = inputs(t)
        jx = {n: jnp.asarray(a) for n, a in x.items()}
        jz = {n: jnp.asarray(a) for n, a in z.items()}
        tx = convert.params_from_numpy(x, device="cpu")
        tz = convert.params_from_numpy(z, device="cpu")
        want, ja = jmix(jx, jz, jax.random.PRNGKey(10 + t), jnp.int32(t))
        got, a = mix(tx, tz, prng.PRNGKey(10 + t), t)
        assert np.array_equal(a.numpy(), np.asarray(ja))
        for n in SHAPES:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                       rtol=0, atol=ulp_atol(k_max),
                                       err_msg=f"{n} round {t}")
        if q is not None:
            check_wire(s, js, tx, tz, x, z, q, jq, 10 + t, t)


def check_wire(s, js, tx, tz, x, z, q, jq, seed, t):
    """The round's encode (gated delta, key_q's per-leaf keys) bitwise."""
    from repro.core.mixing import _quant_leaf_keys as j_leaf_keys
    from repro.core.wire_layout import WireLayout as JWireLayout
    from repro_torch.core.mixing import _gate_z, _quant_leaf_keys
    _, a, key_q = s.round_event(prng.PRNGKey(seed), t)
    _, ja, jkey_q = js.round_event(jax.random.PRNGKey(seed), t)
    zg = _gate_z(a, tz, tx) if s.gates_participation else tz
    lay = T.WireLayout.for_tree(tx, q.bits, stacked=True)
    delta = lay.to_planar_stacked({n: zg[n] - tx[n] for n in tx})
    scales = lay.leaf_scales(delta, q)
    words = lay.encode(delta, scales, q, keys=_quant_leaf_keys(
        key_q, lay.n_leaves, M))
    jx = {n: jnp.asarray(v) for n, v in x.items()}
    mask = np.asarray(ja).reshape(-1, 1, 1) > 0
    jzg = {n: jnp.asarray(np.where(mask.reshape((-1,) + (1,) * (v.ndim - 1)),
                                   v, x[n]) if js.gates_participation
                          else v) for n, v in z.items()}
    jlay = JWireLayout.for_tree({n: v[0] for n, v in jx.items()}, bits=q.bits)
    jdelta = jlay.to_planar_stacked({n: jzg[n] - jx[n] for n in jx})
    jscales = jlay.leaf_scales(jdelta, jq)
    jwords = jlay.encode(jdelta, jscales, jq, leaf_keys=j_leaf_keys(
        jkey_q, jlay.n_leaves, M))
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    assert np.array_equal(words.numpy().view(np.uint32), np.asarray(jwords))


@pytest.mark.parametrize("plan", [False, True], ids=["dense", "plan"])
@pytest.mark.parametrize("bits", [None, 8], ids=["fp32", "q8"])
def test_event_mixer_matches_jax(plan, bits):
    """make_event_mixer with a sampled W_t and active mask handed over
    (the stateful walk's and compute-skip's path), dense and plan."""
    s, js = schedules(T)["partial"], schedules(J)["partial"]
    q = None if bits is None else T.QuantConfig(bits=bits)
    jq = None if bits is None else J.QuantConfig(bits=bits)
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jev = jax.jit(J.make_event_mixer(
        M, quant=jq, mesh=mesh, plan=js.gossip_plan() if plan else None,
        wire="planar"))
    ev = T.make_event_mixer(M, quant=q, plan=s.gossip_plan() if plan
                            else None, device="cpu")
    x, z = inputs(7)
    W, a, key_q = s.round_event(prng.PRNGKey(4), 0)
    jW, ja, jkey_q = js.round_event(jax.random.PRNGKey(4), 0)
    got = ev(convert.params_from_numpy(x, device="cpu"),
             convert.params_from_numpy(z, device="cpu"), W, a, key_q)
    want = jev({n: jnp.asarray(v) for n, v in x.items()},
               {n: jnp.asarray(v) for n, v in z.items()}, jW, ja, jkey_q)
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=0, atol=ulp_atol(3), err_msg=n)


def test_mixers_refuse_inputs_from_another_device():
    s = schedules(T)["partial"]
    ev = T.make_event_mixer(M, plan=s.gossip_plan(), device="cpu")
    x, z = inputs(0)
    tx = convert.params_from_numpy(x, device="cpu")
    W, a, _ = s.round_event(prng.PRNGKey(0), 0)
    with pytest.raises(ValueError, match="must be"):
        ev(tx, tx, W.to("meta"), a)
    with pytest.raises(ValueError, match="must be on"):
        ev(tx, tx, W, a.to("meta"))
    mix = T.make_scheduled_mixer(s, T.MixerConfig(), device="cpu")
    with pytest.raises(ValueError, match="key must be on"):
        mix(tx, tx, prng.PRNGKey(0).to("meta"), 0)
    with pytest.raises(ValueError, match="impl"):
        T.make_scheduled_mixer(s, T.MixerConfig(impl="ring"), device="cpu")
