"""The 1D client mesh on the CPU: the port's sharded executor, rounds,
async events and LM driver flags against the JAX package.

* Sharded mixers on ``make_test_mesh(4, "cpu")`` (m 32, m_local 8) for
  every schedule kind and static graph x {fp32, q8 ``eq7``
  deterministic, q8 ``lemma5`` deterministic, q8 ``lemma5``
  stochastic}: bitwise with the port's one-device realization; x'
  within K + 1 ulp of the JAX package's ``execute_plan_reference`` on
  the round's W_t and gated z (and of its dense mixer on the static
  graphs, fp32); every shard's words and scales bitwise with the JAX
  wire's rows; placed runs bitwise with unplaced ones.
* Sharded rounds (unfused and fused, placed and unplaced) on a 4-shard
  mesh of m 8 against the JAX one-device round for 3 rounds (the
  ``tests/schedule_rounds.py`` contract: metrics within rtol 1e-5,
  parameters within one quantizer step on under 0.1 % of the elements)
  and bitwise with the port's one-device round; the telemetry's
  ``placement_boundary_lanes`` equal to the reference's.
* Async events on a mesh against the JAX async step and bitwise with
  the port's one-device engine, full width and ``ready_capacity``.
* The LM driver: ``--clients-per-shard`` below m (too few cards: the
  dense fallback, records equal to the reference's), ``--mixer-impl
  sparse`` and ``--placement partition`` without the cards (the
  reference's ``SystemExit``), and ``run_resident`` on a built CPU mesh
  with ``--placement partition`` against the one-device run.
* One subprocess runs the JAX package's own sharded executor on 8 host
  devices for a placed ER(32) at m_local 4, q8 stochastic ``lemma5``,
  against the port's on the CPU mesh.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import core as J  # noqa: E402
from repro.core import dfedavgm as jdfed  # noqa: E402
from repro.core.mixing import _quant_leaf_keys as j_leaf_keys  # noqa: E402
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core.mixing import _gate_z, _shard_keys  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    ClientMesh, make_client_mesh, make_test_mesh)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

ROOT = Path(__file__).resolve().parent.parent
M, SHARDS = 32, 4
SHAPES = {"a": (7, 5), "b": (300,), "c": (3, 64)}
QUANTS = {"fp32": None,
          "q8_eq7_det": dict(bits=8, delta_mode="eq7", stochastic=False),
          "q8_lemma5_det": dict(bits=8, stochastic=False),
          "q8_lemma5": dict(bits=8)}


def kinds(L, m=M):
    """Every static graph kind and schedule kind, built alike in the port
    (``L = T``) and the reference (``L = J``)."""
    er = L.erdos_renyi_graph(m, 0.15, seed=1)
    ring = L.ring_graph(m)
    return {
        "ring": lambda: L.MixingSpec.ring(m, 0.5),
        "torus": lambda: L.MixingSpec.torus(4, m // 4),
        "er": lambda: L.MixingSpec.dense(er),
        "constant": lambda: L.TopologySchedule.constant(
            L.MixingSpec.ring(m, 0.5)),
        "edge_sample": lambda: L.TopologySchedule.edge_sample(er, 0.6),
        "partial": lambda: L.TopologySchedule.partial(ring, 0.6),
        "partial_exact": lambda: L.TopologySchedule.partial(er, 0.5,
                                                            exact=True),
        "walk": lambda: L.TopologySchedule.random_walk(er, horizon=16,
                                                       seed=2),
        "cycle": lambda: L.TopologySchedule.cycle(
            [L.MixingSpec.ring(m, 0.5), L.MixingSpec.torus(4, m // 4)]),
    }


def ulp_atol(k: int) -> float:
    """K + 1 ulp at the parameters' magnitude (|x| < 4)."""
    return (k + 1) * float(np.spacing(np.float32(4.0)))


def inputs(seed: int, m: int = M):
    rng = np.random.default_rng(seed)
    x = {n: rng.normal(size=(m,) + s).astype(np.float32)
         for n, s in SHAPES.items()}
    z = {n: (v + 0.05 * rng.normal(size=v.shape)).astype(np.float32)
         for n, v in x.items()}
    return x, z


def tree(d, perm=None):
    return {n: torch.from_numpy(np.ascontiguousarray(
        v if perm is None else v[perm])) for n, v in d.items()}


def the_event(s, key, t):
    """(W, active, key_q, plan) of round t: a static spec's W and the
    mixing key, a schedule's sampled event, a cycle's member."""
    if not isinstance(s, (T.TopologySchedule, J.TopologySchedule)):
        return s.W, None, key, s.gossip_plan()
    if s.kind == "cycle":
        i = t % len(s.Ws)
        return s.Ws[i], None, key, s.gossip_plans()[i]
    W, a, kq = s.round_event(key, t)
    return W, a, kq, s.gossip_plan()


@pytest.mark.parametrize("quant", list(QUANTS))
@pytest.mark.parametrize("kind", list(kinds(T)))
def test_sharded_mixer_matches_reference(kind, quant):
    s, js = kinds(T)[kind](), kinds(J)[kind]()
    kw = QUANTS[quant]
    q = None if kw is None else T.QuantConfig(**kw)
    jq = None if kw is None else J.QuantConfig(**kw)
    mesh = make_test_mesh(SHARDS, "cpu")
    scheduled = isinstance(s, T.TopologySchedule)
    cfg = T.MixerConfig(quant=q)
    one = T.make_mixer(s, cfg, device="cpu")
    sharded = T.make_mixer(s, cfg, mesh=mesh)
    support = s.support_graph() if scheduled else s.graph
    pl = T.compute_placement(support, SHARDS)
    placed = T.make_mixer(s, cfg, mesh=mesh, placement=pl)
    t = 1
    x, z = inputs(3)
    key, jkey = prng.PRNGKey(7), jax.random.PRNGKey(7)
    args = (key, t)
    want_one = one(tree(x), tree(z), *args)
    got = sharded(mesh.shard(tree(x)), mesh.shard(tree(z)), *args)
    got_p = placed(mesh.shard(tree(x, pl.perm)),
                   mesh.shard(tree(z, pl.perm)), *args)
    if scheduled:
        (want_one, a1), (got, a2), (got_p, a3) = want_one, got, got_p
        assert torch.equal(a1, a2) and torch.equal(a1[pl.perm], a3)
    got, got_p = mesh.gather(got), mesh.gather(got_p)
    for n in SHAPES:
        assert torch.equal(got[n], want_one[n]), n
        assert torch.equal(got_p[n], want_one[n][pl.perm]), n
    # The reference's mesh-free spec on the same event.
    W, a, key_q, _ = the_event(s, key, t)
    jW, ja, jkey_q, jplan = the_event(js, jkey, t)
    jz = {n: jnp.asarray(v) for n, v in z.items()}
    jx = {n: jnp.asarray(v) for n, v in x.items()}
    if ja is not None and js.gates_participation:
        assert np.array_equal(np.asarray(ja), a.numpy())
        mask = np.asarray(ja) > 0
        jz = {n: jnp.asarray(np.where(mask.reshape((-1,) + (1,) * (v.ndim
                                                                   - 1)),
                                      v, x[n])) for n, v in z.items()}
    want = J.execute_plan_reference(jplan, jW, jz, x=jx, quant=jq,
                                    key=jkey_q)
    k = jplan.n_steps + 1
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=0, atol=ulp_atol(k), err_msg=n)
    if not scheduled and q is None:
        dense = J.mix_dense(js.W, jz)
        for n in SHAPES:
            np.testing.assert_allclose(got[n].numpy(), np.asarray(dense[n]),
                                       rtol=0, atol=ulp_atol(k), err_msg=n)
    if q is not None:
        check_shard_wire(tree(x), tree(z), a, key_q, x, jz, jkey_q, q, jq,
                         mesh, s.gates_participation if scheduled
                         else False)


def check_shard_wire(tx, tz, a, key_q, x, jz, jkey_q, q, jq, mesh, gates):
    """Each shard's encode — its block of the gated delta, its slice of
    the full-width keys — bitwise with the rows of the reference's wire."""
    zg = _gate_z(a, tz, tx) if gates else tz
    lay = T.WireLayout.for_tree(tx, q.bits, stacked=True)
    blocks = [(s * M // SHARDS, (s + 1) * M // SHARDS, torch.device("cpu"))
              for s in range(SHARDS)]
    keys = (_shard_keys(key_q, lay.n_leaves, M, None, blocks)
            if q.stochastic else [None] * SHARDS)
    jx = {n: jnp.asarray(v) for n, v in x.items()}
    jlay = JWireLayout.for_tree({n: v[0] for n, v in jx.items()},
                                bits=q.bits)
    jdelta = jlay.to_planar_stacked({n: jz[n] - jx[n] for n in jx})
    jscales = jlay.leaf_scales(jdelta, jq)
    jwords = np.asarray(jlay.encode(
        jdelta, jscales, jq, leaf_keys=j_leaf_keys(jkey_q, jlay.n_leaves, M)
        if q.stochastic else None))
    for (lo, hi, _), k in zip(blocks, keys):
        xb = {n: v[lo:hi] for n, v in tx.items()}
        delta = lay.to_planar_stacked({n: zg[n][lo:hi] - xb[n] for n in xb})
        scales = lay.leaf_scales(delta, q)
        words = lay.encode(delta, scales, q, keys=k)
        assert np.array_equal(scales.numpy(), np.asarray(jscales)[lo:hi])
        assert np.array_equal(words.numpy().view(np.uint32), jwords[lo:hi])


# ---------------------------------------------------------------------------
# Rounds: the 2NN on 4 shards of 2 against the reference's one device
# ---------------------------------------------------------------------------

ROUND_CASES = [("er", False), ("er", True), ("partial_exact", False),
               ("edge_sample", True)]


@pytest.mark.parametrize("kind,fuse", ROUND_CASES,
                         ids=[f"{k}-{'fused' if f else 'unfused'}"
                              for k, f in ROUND_CASES])
def test_sharded_round_tracks_reference(kind, fuse):
    import schedule_rounds as SR
    m = SR.M
    s, js = kinds(T, m)[kind](), kinds(J, m)[kind]()
    data = SR.j_dataset(n=400, d=SR.D_IN, seed=0)
    params = SR.jnets.init_2nn(jax.random.PRNGKey(0), d_in=SR.D_IN,
                               d_hidden=SR.HID)
    np_params = jax.tree.map(np.asarray, params)
    fed = SR.JFed.make(data, m)
    tfed = SR.FederatedDataset.make(SR.classification_dataset(
        n=400, d=SR.D_IN, seed=0), m)
    jcfg = J.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=SR.K,
                            quant=J.QuantConfig(bits=8),
                            mixer_impl="sparse", wire="seq",
                            fuse_round=fuse)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jstep = jax.jit(J.make_round_step(SR.j_loss, jcfg, js, mesh=jmesh,
                                      client_axes=("clients",)))
    jst = J.init_round_state(jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (m,) + t.shape), params),
        jax.random.PRNGKey(1))
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=SR.K,
                           quant=T.QuantConfig(bits=8), fuse_round=fuse)
    mesh = make_test_mesh(4, "cpu")
    support = s.support_graph() if isinstance(s, T.TopologySchedule) \
        else s.graph
    pl = T.compute_placement(support, 4)
    stacked = convert.params_from_numpy(np_params, stack=m, device="cpu")
    one = T.make_round_step(SR.t_loss, cfg, s, device="cpu")
    sharded = T.make_round_step(SR.t_loss, cfg, s, mesh=mesh,
                                with_telemetry=True)
    placed = T.make_round_step(SR.t_loss, cfg, s, mesh=mesh, placement=pl,
                               with_telemetry=True)
    st1 = T.init_round_state(stacked, prng.PRNGKey(1))
    st2 = T.init_round_state(stacked, prng.PRNGKey(1), mesh=mesh)
    st3 = T.init_round_state({n: v[pl.perm] for n, v in stacked.items()},
                             prng.PRNGKey(1), mesh=mesh)
    jm, tm, pm = [], [], []
    for t in range(SR.ROUNDS):
        jst, a = jstep(jst, fed.round_batches(t, K=SR.K, batch=SR.B))
        b = tfed.round_batches(t, K=SR.K, batch=SR.B, device="cpu")
        st1, m1 = one(st1, b)
        st2, m2 = sharded(st2, b)
        st3, m3 = placed(st3, b)
        jm.append({k: float(v) for k, v in a.items()})
        tm.append({k: float(v) for k, v in m2.items() if k != "telemetry"})
        pm.append({k: float(v) for k, v in m3.items() if k != "telemetry"})
        for k in m1:
            # Consensus and drift meet as per-shard partial sums (f32
            # rounding apart); every other metric is bitwise.
            rel = 1e-6 if k in ("consensus_dist", "local_drift") else 0.0
            assert float(m2[k]) == pytest.approx(float(m1[k]), rel=rel,
                                                 abs=0.0), (t, k)
    g2, g3 = mesh.gather(st2.params), mesh.gather(st3.params)
    for n, v in st1.params.items():
        assert torch.equal(g2[n], v), n
        assert torch.equal(g3[n], v[pl.perm]), n
    SR.assert_rounds_track(jst, st2._replace(params=g2), jm, tm)
    unplaced = {n: v[torch.as_tensor(pl.inv.astype(np.int64))]
                for n, v in g3.items()}
    SR.assert_rounds_track(jst, st3._replace(params=unplaced), jm, pm)
    jplan = js.gossip_plan()
    want = [jdfed._placed_boundary_lane_slots(p, mesh, ("clients",))
            for p in (jplan, jplan.placed(J.compute_placement(
                js.support_graph() if isinstance(js, J.TopologySchedule)
                else js.graph, 4)))]
    assert float(m2["telemetry"].placement_boundary_lanes) == want[0]
    assert float(m3["telemetry"].placement_boundary_lanes) == want[1]


# ---------------------------------------------------------------------------
# Async events on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [None, 3], ids=["full", "capacity3"])
def test_async_events_on_a_mesh(cap):
    """12 straggler events of the quadratic clients (m 8, q8 ring, eta
    decay): the sharded engine bitwise with the one-device one, and
    tracking the JAX async step on a one-device mesh."""
    import test_torch_async as TA
    w0, jl, tl, jb, tb = TA.quad()
    kw = dict(speed=TA.straggler, max_staleness=4, eta_staleness_decay=0.5)
    ja = TA.both(J, **kw)
    ta = TA.both(T, ready_capacity=cap, **kw)
    spec, jspec = T.MixingSpec.ring(TA.M, 0.5), J.MixingSpec.ring(TA.M, 0.5)
    jstep = TA._ref_step(jl, ja, jspec, 8, "ring")
    cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                           quant=T.QuantConfig(bits=8))
    mesh = make_test_mesh(4, "cpu")
    one = T.make_async_round_step(tl, cfg, spec, ta, device="cpu")
    sharded = T.make_async_engine(tl, cfg, spec, ta, mesh=mesh)
    js = J.init_async_state({"w": jnp.asarray(w0)}, jax.random.PRNGKey(1),
                            ja.speed)
    s1 = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                            prng.PRNGKey(1), ta.speed)
    s2 = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                            prng.PRNGKey(1), ta.speed, mesh=mesh)
    for e in range(12):
        s1, m1 = one(s1, tb)
        s2, m2 = sharded(s2, {k: v[None] for k, v in tb.items()})
        assert torch.equal(mesh.gather(s2.params)["w"], s1.params["w"]), e
        for k in m1:
            if k == "consensus_dist":    # per-shard partial sums
                assert float(m2[k][0]) == pytest.approx(float(m1[k]),
                                                        rel=1e-6), e
            else:
                assert torch.equal(m2[k][0], m1[k]), (e, k)
        if cap is None:
            js, jm = jstep(js, jb)
            TA._assert_event_tracks(e, js, jm, s1, m1)
            np.testing.assert_allclose(s1.params["w"].numpy(),
                                       np.asarray(js.params["w"]),
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# The mesh itself and the LM driver's flags
# ---------------------------------------------------------------------------

def test_client_mesh_shards_and_refusals():
    mesh = make_test_mesh(4, "cpu")
    assert mesh.devices.shape == (4,) and mesh.axis_names == ("clients",)
    assert mesh.shared and mesh.n_shards == 4
    x, _ = inputs(0, 8)
    sharded = mesh.shard(tree(x))
    assert len(sharded) == 4 and sharded[1]["a"].shape == (2, 7, 5)
    assert torch.equal(sharded[2]["b"], tree(x)["b"][4:6])
    back = mesh.gather(sharded)
    assert all(torch.equal(back[n], tree(x)[n]) for n in x)
    with pytest.raises(ValueError, match="does not block"):
        mesh.shard({"a": torch.zeros(6, 2)})
    # No card here: a client mesh of cards is None with the reference's
    # warning (once a shape), the 2D mesh's too (8 shards x 2 columns).
    with pytest.warns(UserWarning, match="FALL BACK TO THE DENSE MIXER"):
        assert make_client_mesh(8, clients_per_shard=2) is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make_client_mesh(8, clients_per_shard=2) is None
    with pytest.warns(UserWarning, match="needs 16 devices"):
        assert make_client_mesh(8, model_parallel=2) is None
    with pytest.raises(ValueError, match="divide"):
        make_client_mesh(8, clients_per_shard=3)
    with pytest.raises(ValueError, match="1D"):
        ClientMesh(devices=np.array([torch.device("cpu")], dtype=object),
                   axis_names=("clients", "model"))
    # A mesh that does not fit m: sparse impls refuse, auto is dense.
    spec = T.MixingSpec.ring(6, 0.5)
    assert T.MixerConfig().resolved_impl(spec, mesh) == "dense"
    with pytest.raises(ValueError, match="client block per shard"):
        T.make_mixer(spec, T.MixerConfig(impl="ring"), mesh=mesh)
    with pytest.warns(UserWarning, match="DENSE reference"):
        T.make_mixer(T.MixingSpec.torus(2, 3),
                     T.MixerConfig(impl="torus", quant=T.QuantConfig()),
                     mesh=mesh)
    with pytest.raises(ValueError, match="client mesh"):
        T.make_mixer(T.MixingSpec.ring(8, 0.5), T.MixerConfig(),
                     device="cpu", placement=T.compute_placement(
                         T.ring_graph(8), 4))
    # One split and one join: views on the tree's device, lane order.
    tx = tree(x)
    parts = T.split_lanes(tx, list(mesh.devices))
    assert parts[3]["c"].data_ptr() == tx["c"][6:].data_ptr()
    assert all(torch.equal(T.join_lanes(parts, torch.device("cpu"))[n],
                           tx[n]) for n in x)
    assert mesh.shard(tx)[3]["c"].data_ptr() != tx["c"][6:].data_ptr()
    assert [p.tolist() for p in T.split_lanes(torch.arange(8),
                                              list(mesh.devices))] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="CUDA device"):
        T.capture_step(lambda st, b: (st, {}), T.init_round_state(
            tree(x), prng.PRNGKey(0), mesh=mesh), None)
    # Shards on two devices: one graph captures one device's stream.
    two = T.RoundState(params=[{"a": torch.zeros(2)},
                               {"a": torch.zeros(2, device="meta")}],
                       rng=prng.PRNGKey(0), round=0)
    with pytest.raises(ValueError, match="one device's stream"):
        T.capture_step(lambda st, b: (st, {}), two, None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mesh_metrics_from_shards(dtype):
    """The round's metrics on a mesh need no shard's lanes elsewhere:
    consensus from the shards' partial sums agrees with the one-device
    value to f32 rounding (one shard: bitwise), and the quantizer replay
    on each shard's sampled lanes (placed keys, a lane weight) is
    bitwise the one device's."""
    from repro_torch.core.mixing import _quant_leaf_keys
    from repro_torch.telemetry.metrics import (quant_round_telemetry,
                                               sample_lane_ids,
                                               shard_sample_ids)
    dt = getattr(torch, dtype)
    x, z = inputs(4)
    tx = {n: v.to(dt) for n, v in tree(x).items()}
    tz = {n: v.to(dt) for n, v in tree(z).items()}
    mesh = make_test_mesh(SHARDS, "cpu")
    devs = list(mesh.devices)
    one = T.consensus_distance(tx)
    assert float(T.consensus_distance(mesh.shard(tx))) == pytest.approx(
        float(one), rel=1e-6)
    assert torch.equal(T.consensus_distance([tx]), one)
    q = T.QuantConfig(bits=8)
    key = prng.PRNGKey(3)
    perm = torch.as_tensor(np.random.default_rng(0).permutation(M))
    leaf_keys = _quant_leaf_keys(key, len(tx), M)[:, perm]
    w = (torch.arange(M) % 3 > 0).to(torch.float32)
    for sample in (2, 5, None):
        for lw in (w, None):
            want = quant_round_telemetry(
                tx, tz, q, key, leaf_keys=leaf_keys, lane_weight=lw,
                sample_lanes=sample_lane_ids(M, sample, "cpu"))
            got = quant_round_telemetry(
                mesh.shard(tx), mesh.shard(tz), q, key, leaf_keys=leaf_keys,
                lane_weight=lw, sample_lanes=shard_sample_ids(M, sample,
                                                              devs))
            for g, e in zip(got, want):
                assert torch.equal(g, e), (sample, lw is None)


def _driver_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if '"info"' not in line]


def test_driver_two_shards_fall_back_as_the_reference(tmp_path):
    """``--clients-per-shard 2`` of 4 clients on a host without the
    cards: both drivers warn and run the dense reference — the same round
    and end records; with ``--mixer-impl sparse`` or ``--placement
    partition`` both exit."""
    from repro.launch import train as RT
    from repro_torch.launch import train as TT
    from test_torch_train import BASE, same
    argv = BASE + ["--bits", "8", "--clients-per-shard", "2"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        RT.main(argv + ["--log-jsonl", str(tmp_path / "ref.jsonl")])
        TT.main(argv + ["--device", "cpu", "--log-jsonl",
                        str(tmp_path / "port.jsonl")])
    ref = _driver_records(tmp_path / "ref.jsonl")
    port = _driver_records(tmp_path / "port.jsonl")
    assert [r["kind"] for r in ref] == [p["kind"] for p in port]
    for r, p in zip(ref[1:], port[1:]):
        assert set(r) == set(p)
        for k in r:
            if k not in ("wall_s", "time"):
                same(p[k], r[k], k)
    for extra, match in ((["--mixer-impl", "sparse"], "devices"),
                         (["--placement", "partition"], "sparse backend")):
        for main in (RT.main, lambda a: TT.main(a + ["--device", "cpu"])):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with pytest.raises(SystemExit, match=match):
                    main(argv + extra)


def test_driver_on_a_cpu_mesh_with_partition(tmp_path):
    """``run_resident`` on a built 2-shard CPU mesh with ``--placement
    partition`` on an ER support: the cut log line, every record valid,
    and the losses and consensus equal to the one-device run's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train as TT
    from repro_torch.telemetry import RunLog, Tracer, validate_record
    argv = ["--clients", "4", "--local-steps", "2", "--batch", "2", "--seq",
            "16", "--rounds", "2", "--bits", "8", "--schedule", "partial",
            "--base-graph", "er", "--er-p", "0.7", "--device", "cpu"]
    cfg = reduced(get_config("smollm-135m"))
    runs = {}
    for name, extra, mesh in (("one", [], None),
                              ("mesh", ["--placement", "partition"],
                               make_test_mesh(2, "cpu"))):
        args = TT.build_parser().parse_args(
            argv + extra + ["--log-jsonl", str(tmp_path / f"{name}.jsonl")])
        log = RunLog(jsonl=args.log_jsonl, console=False)
        try:
            state, met = TT.run_resident(args, cfg, log, Tracer(False),
                                         mesh=mesh)
        finally:
            log.close()
        runs[name] = (state, met)
    lines = [json.loads(x) for x in open(tmp_path / "mesh.jsonl")]
    for r in lines:
        validate_record(r)
    assert any("placement: partition over 2 shards" in r.get("msg", "")
               for r in lines)
    assert isinstance(runs["mesh"][0].params, list)
    for k in ("loss", "consensus_dist"):
        assert float(runs["mesh"][1][k]) == pytest.approx(
            float(runs["one"][1][k]), rel=1e-5)


# ---------------------------------------------------------------------------
# The JAX package's own sharded executor, on 8 host devices
# ---------------------------------------------------------------------------

_JAX_MESH_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import core as J
m, shards = 32, 8
g = J.erdos_renyi_graph(m, 0.15, seed=1)
spec = J.MixingSpec.dense(g)
pl = J.compute_placement(g, shards)
mesh = Mesh(np.array(jax.devices()[:shards]), ("clients",))
mix = jax.jit(J.make_mixer(spec, J.MixerConfig(quant=J.QuantConfig(bits=8),
                                               wire="seq"),
                           mesh=mesh, placement=pl))
d = np.load(sys.argv[1])
x = {n[2:]: jnp.asarray(d[n]) for n in d.files if n.startswith("x_")}
z = {n[2:]: jnp.asarray(d[n]) for n in d.files if n.startswith("z_")}
out = mix(x, z, jax.random.PRNGKey(5))
np.savez(sys.argv[2], perm=pl.perm,
         **{n: np.asarray(v) for n, v in out.items()})
"""


def test_jax_sharded_executor_on_8_host_devices(tmp_path):
    rng = np.random.default_rng(9)
    x, z = inputs(9)
    g = T.erdos_renyi_graph(M, 0.15, seed=1)
    pl = T.compute_placement(g, 8)
    np.savez(tmp_path / "in.npz",
             **{f"x_{n}": v[pl.perm] for n, v in x.items()},
             **{f"z_{n}": v[pl.perm] for n, v in z.items()})
    del rng
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _JAX_MESH_SCRIPT,
                    str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                   check=True, env=env, timeout=300)
    want = np.load(tmp_path / "out.npz")
    assert np.array_equal(want["perm"], pl.perm)
    mesh = make_test_mesh(8, "cpu")
    mix = T.make_mixer(T.MixingSpec.dense(g),
                       T.MixerConfig(quant=T.QuantConfig(bits=8)),
                       mesh=mesh, placement=pl)
    got = mesh.gather(mix(mesh.shard(tree(x, pl.perm)),
                          mesh.shard(tree(z, pl.perm)), prng.PRNGKey(5)))
    k = T.MixingSpec.dense(g).gossip_plan().n_steps + 1
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=0,
                                   atol=ulp_atol(k), err_msg=n)
