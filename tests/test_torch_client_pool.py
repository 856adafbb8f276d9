"""The port's virtual client pool (``repro_torch.core.client_pool``) on
the CPU: every bitwise claim of the reference's ``tests/test_client_pool.py``
held port against port — the copy-on-write store, the structural ring
plan and walk, pooled rounds against the resident ones (dense fp32 with
prefetch on and off, dense q8, the plan realization fp32 and q8 against
``execute_plan_reference``, the random walk), billing, a save and restore
mid-run, the async pool against the resident engine, the capacity
overflow — then each pooled arm against the reference's own
``PooledRunner`` / ``PooledAsyncRunner`` on the same seed.

Sizes are the reference tests' (M 12, D 5, 5 rounds; the 2NN only at
m 4). Params go across as numpy (``convert``); torch runs one thread with
TF32 off.

Contracts: port against port bitwise (the async pool against the
resident engine on the dense mixer, the pool's own; the resident's plan
realization adds a row's terms in another order). Against the reference:
cohort ids and pool versions equal at every round, the per-leaf
quantizer keys and the wire words bitwise on equal inputs, params and
loss within rtol 1e-5.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as J  # noqa: E402
from repro.core.mixing import _quant_leaf_keys as j_leaf_keys  # noqa: E402
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.core.client_pool import _cohort_lane_map  # noqa: E402
from repro_torch.core.gossip_plan import matching_steps  # noqa: E402
from repro_torch.core.wire_layout import WireLayout  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, D = 12, 5
ROUNDS = 5
RTOL = 1e-5
CS = np.random.default_rng(1).normal(size=(M, D)).astype(np.float32)
TEMPLATE = {"w": torch.zeros(D)}
Q8 = dict(bits=8)


def loss_fn(p, b, r):
    return 0.5 * ((p["w"] - b["c"]) ** 2).sum(-1)


def j_loss(p, b, r):
    return 0.5 * jnp.sum((p["w"] - b["c"]) ** 2)


BATCHES = {"c": torch.from_numpy(
    np.ascontiguousarray(np.broadcast_to(CS[:, None], (M, 4, D))))}


def batch_rows(idx, t):
    return {"c": BATCHES["c"][idx]}


def cfg_of(L, quant=None, **kw):
    q = None if quant is None else L.QuantConfig(**quant)
    return L.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=4, quant=q,
                            **kw)


def sched_partial(L=T, m=M):
    return L.TopologySchedule.partial(L.ring_graph(m), 0.34, exact=True)


def sched_walk(L=T):
    return L.TopologySchedule.random_walk(L.ring_graph(M), horizon=64,
                                          seed=3)


def resident_final(cfg, sched, rounds=ROUNDS):
    step = T.make_round_step(loss_fn, cfg, sched, device="cpu")
    st = T.init_round_state({"w": torch.zeros(M, D)}, prng.PRNGKey(7))
    metrics = []
    for _ in range(rounds):
        st, mt = step(st, BATCHES)
        metrics.append(mt)
    return st.params["w"], metrics


def resident_plan_reference_final(cfg, sched, rounds=ROUNDS):
    """The resident skip path with the mix done by
    ``execute_plan_reference`` (the plan realization as one function),
    which the pooled ``"sparse"`` backend mirrors at cohort width."""
    from repro_torch.core.dfedavgm import _active_lanes
    plan = sched.gossip_plan()
    k = sched.static_active_count
    params, rng = {"w": torch.zeros(M, D)}, prng.PRNGKey(7)
    for t in range(rounds):
        key_round, key_mix, rng = prng.split(rng, 3)
        client_keys = prng.split(key_round, M)
        W_t, active, key_q = sched.round_event(key_mix, t)
        idx, safe, _ = _active_lanes(active, k)
        z_sub, _ = T.local_train(loss_fn, {"w": params["w"][safe]},
                                 {"c": BATCHES["c"][safe]},
                                 client_keys[safe], eta=cfg.eta,
                                 theta=cfg.theta)
        z = torch.cat([params["w"], params["w"][-1:]]).index_copy_(
            0, idx, z_sub["w"])[:M]
        z = torch.where(active[:, None] > 0, z, params["w"])
        params = T.execute_plan_reference(plan, W_t, {"w": z}, x=params,
                                          quant=cfg.quant, key=key_q)
    return params["w"]


def pooled_final(cfg, psched, backend, rounds=ROUNDS, prefetch=True):
    pool = T.ClientPool(TEMPLATE, M)
    runner = T.PooledRunner(pool, psched, loss_fn, cfg, batch_rows,
                            key=prng.PRNGKey(7), backend=backend,
                            prefetch=prefetch, device="cpu")
    metrics = runner.run(rounds)
    return pool.fetch(np.arange(M))["w"], metrics, runner


# ---------------------------------------------------------------------------
# The copy-on-write store
# ---------------------------------------------------------------------------

def test_pool_is_copy_on_write_and_version_monotonic():
    pool = T.ClientPool(TEMPLATE, 1000)
    assert pool.materialized == 0 and pool.nbytes == 0
    assert (pool.fetch([5, 999])["w"] == 0).all()   # template reads
    pool.writeback([5, 999], {"w": np.ones((2, D), np.float32)})
    assert pool.materialized == 2
    assert pool.versions[5] == 1 and pool.versions[999] == 1
    assert pool.versions.sum() == 2                  # nobody else moved
    assert (pool.fetch([5])["w"] == 1).all()
    assert (pool.fetch([6])["w"] == 0).all()         # still virgin
    pool.writeback([5], {"w": torch.full((1, D), 2.0)})
    assert pool.versions[5] == 2 and pool.materialized == 2
    assert (pool.fetch([5, 6, 999])["w"][:, 0] == torch.tensor(
        [2.0, 0.0, 1.0])).all()
    with pytest.raises(ValueError, match="duplicate"):
        pool.writeback([3, 3], {"w": np.ones((2, D), np.float32)})


def test_pool_writeback_mask_restricts_rows_and_versions():
    pool = T.ClientPool(TEMPLATE, 10)
    pool.writeback([1, 2, 3], {"w": np.ones((3, D), np.float32)},
                   mask=[True, False, True])
    assert list(pool.versions[[1, 2, 3]]) == [1, 0, 1]
    assert (pool.fetch([2])["w"] == 0).all()


def test_reserved_writeback_moves_no_slot_and_no_slab():
    """After ``_reserve`` (the runner's step before it starts the
    prefetch) a write-back of those clients grows no slab and moves no
    slot, so a gather of other clients running beside it reads rows that
    stay put; versions still move only on the write-back."""
    pool = T.ClientPool(TEMPLATE, 1000)
    pool.writeback(np.arange(60), {"w": np.ones((60, D), np.float32)})
    idx = np.arange(50, 130)                  # 70 new: the slabs grow
    pool._reserve(idx)
    slabs, slots = list(pool._slabs), pool._slot.copy()
    assert pool.materialized == 130 and pool.versions[60:].sum() == 0
    rows = np.arange(80 * D, dtype=np.float32).reshape(80, D)
    pool.writeback(idx, {"w": rows})
    assert all(a is b for a, b in zip(pool._slabs, slabs))
    assert np.array_equal(pool._slot, slots)
    assert np.array_equal(pool.fetch(idx)["w"].numpy(), rows)
    assert list(pool.versions[[0, 50, 129, 130]]) == [1, 2, 1, 0]


# ---------------------------------------------------------------------------
# Structural replications (no dense adjacency at pool scale)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 3, 4, 5, 8, 11, 16, 37])
def test_ring_matching_src_equals_greedy_coloring(m):
    got = T.ring_matching_src(m)
    np.testing.assert_array_equal(got, matching_steps(T.ring_graph(m).adj))
    np.testing.assert_array_equal(got, J.ring_matching_src(m))


@pytest.mark.parametrize("m", [2, 3, 8, 13])
def test_structural_walk_equals_resident_stream(m):
    sched = T.TopologySchedule.random_walk(T.ring_graph(m), horizon=128,
                                           seed=5, start=1 % m)
    ps = T.PoolSchedule.ring_random_walk(m, horizon=128, seed=5,
                                         start=1 % m)
    np.testing.assert_array_equal(np.asarray(sched.walk), ps.walk)


def test_from_schedule_rejects_unbounded_cohorts():
    with pytest.raises(ValueError, match="statically sized"):
        T.PoolSchedule.from_schedule(
            T.TopologySchedule.partial(T.ring_graph(M), 0.4))  # i.i.d.


# ---------------------------------------------------------------------------
# Pooled == resident, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [True, False])
def test_pooled_fp32_dense_bitwise_equals_resident(prefetch):
    """Same key -> same cohorts -> same bits, whether the cohort came from
    the resident stack or the host pool, and whether the next round was
    prefetched (the overlap patch makes the prefetch invisible)."""
    sched = sched_partial()
    cfg = cfg_of(T, mixer_impl="dense")
    ref, rm = resident_final(cfg, sched)
    for psched in (T.PoolSchedule.from_schedule(sched),
                   T.PoolSchedule.ring_partial(M, 0.34)):
        got, pm, _ = pooled_final(cfg, psched, "dense", prefetch=prefetch)
        assert torch.equal(got, ref)
        for r in range(len(rm)):
            assert float(rm[r]["loss"]) == float(pm[r]["loss"])
            assert (float(rm[r]["active_frac"])
                    == float(pm[r]["active_frac"]))


def test_pooled_q8_dense_bitwise_equals_resident():
    """Stochastic rounding draws its (leaf, client) keys at the full
    width and gathers the cohort's rows, so the wire matches."""
    sched = sched_partial()
    cfg = cfg_of(T, Q8, mixer_impl="dense")
    ref, _ = resident_final(cfg, sched)
    for psched in (T.PoolSchedule.from_schedule(sched),
                   T.PoolSchedule.ring_partial(M, 0.34)):
        got, _, _ = pooled_final(cfg, psched, "dense")
        assert torch.equal(got, ref)


@pytest.mark.parametrize("quant", [None, Q8], ids=["fp32", "q8"])
def test_pooled_sparse_backend_bitwise_equals_plan_reference(quant):
    """The ``"sparse"`` backend remaps the full-width plan onto cohort
    lanes (off-cohort sources at the resident's exact 0 weight), so the
    accumulation chain and the wire are ``execute_plan_reference``'s and
    the resident skip path's (the plan realization) bit for bit."""
    sched = sched_partial()
    cfg = cfg_of(T, quant, mixer_impl="sparse")
    ref = resident_plan_reference_final(cfg, sched)
    skip, _ = resident_final(cfg, sched)
    assert torch.equal(skip, ref)
    for psched in (T.PoolSchedule.from_schedule(sched),
                   T.PoolSchedule.ring_partial(M, 0.34)):
        got, _, _ = pooled_final(cfg, psched, "sparse")
        assert torch.equal(got, ref)


@pytest.mark.parametrize("quant", [None, Q8], ids=["fp32", "q8"])
def test_pooled_random_walk_bitwise_equals_resident(quant):
    sched = sched_walk()
    cfg = cfg_of(T, quant, mixer_impl="dense")
    ref, _ = resident_final(cfg, sched)
    for psched in (T.PoolSchedule.from_schedule(sched),
                   T.PoolSchedule.ring_random_walk(M, horizon=64, seed=3)):
        got, _, _ = pooled_final(cfg, psched, "dense")
        assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# Billing, checkpoints
# ---------------------------------------------------------------------------

def test_pooled_billing_equals_resident_schedule_bits():
    sched = sched_partial()
    quant = T.QuantConfig(bits=8)
    want = T.schedule_round_bits(sched, D, quant)
    assert want == J.schedule_round_bits(sched_partial(J), D,
                                         J.QuantConfig(bits=8))
    for psched in (T.PoolSchedule.from_schedule(sched),
                   T.PoolSchedule.ring_partial(M, 0.34)):
        assert psched.round_bits(D, quant) == want
    _, _, runner = pooled_final(cfg_of(T, Q8),
                                T.PoolSchedule.ring_partial(M, 0.34),
                                "dense", rounds=3)
    assert runner.comm_bits == 3 * want
    wsched = sched_walk()
    assert (T.PoolSchedule.from_schedule(wsched).round_bits(D, quant)
            == T.schedule_round_bits(wsched, D, quant))


def test_close_mid_run_continues_bitwise():
    """``close`` joins the prefetch's worker and drops the prefetched
    round; the runner goes on without prefetch, bit for bit."""
    cfg = cfg_of(T, Q8)
    psched = T.PoolSchedule.ring_partial(M, 0.34)
    ref, _, _ = pooled_final(cfg, psched, "sparse")
    pool = T.ClientPool(TEMPLATE, M)
    runner = T.PooledRunner(pool, psched, loss_fn, cfg, batch_rows,
                            key=prng.PRNGKey(7), backend="sparse",
                            device="cpu")
    runner.run(2)
    runner.close()
    runner.run(ROUNDS - 2)
    assert runner._exec is None
    assert torch.equal(pool.fetch(np.arange(M))["w"], ref)


@pytest.mark.parametrize("quant", [None, Q8], ids=["fp32", "q8"])
def test_save_restore_mid_run_continues_bitwise(quant):
    """3 rounds + save + restore + 3 rounds == 6 uninterrupted rounds:
    params, versions and the comm ledger (the prefetched buffer is a
    function of the key, the round and the pool, rebuilt on restore)."""
    cfg = cfg_of(T, quant)
    psched = T.PoolSchedule.ring_partial(M, 0.34)
    ref, _, r0 = pooled_final(cfg, psched, "dense", rounds=6)
    with tempfile.TemporaryDirectory() as d:
        r1 = T.PooledRunner(T.ClientPool(TEMPLATE, M), psched, loss_fn, cfg,
                            batch_rows, key=prng.PRNGKey(7), device="cpu")
        r1.run(3)
        r1.save(d)
        r2 = T.PooledRunner.restore(d, TEMPLATE, psched, loss_fn, cfg,
                                    batch_rows, device="cpu")
        assert r2.t == 3 and r2.comm_bits == r1.comm_bits
        r2.run(3)
        assert torch.equal(r2.pool.fetch(np.arange(M))["w"], ref)
        np.testing.assert_array_equal(r2.pool.versions, r0.pool.versions)
        assert r2.comm_bits == r0.comm_bits


# ---------------------------------------------------------------------------
# Pooled async engine
# ---------------------------------------------------------------------------

M8 = 8
CS8 = np.random.default_rng(2).normal(size=(M8, D)).astype(np.float32)
B8 = torch.from_numpy(np.ascontiguousarray(
    np.broadcast_to(CS8[:, None], (M8, 4, D))))


def async_cfg(L):
    return L.AsyncConfig(speed=L.SpeedModel.straggler(factor=4.0),
                         max_staleness=3, eta_staleness_decay=0.3)


@pytest.mark.parametrize("quant", [None, Q8], ids=["fp32", "q8"])
def test_pooled_async_bitwise_equals_resident_engine(quant):
    """Ready-set cohorts (ready clients and their ring neighbours, padded
    to the capacity) replay the resident engine's params, versions,
    clock chain and metrics exactly under a straggler tail with the eta
    decay on (B3's lane entry)."""
    spec = T.MixingSpec.ring(M8, self_weight=0.5)
    cfg = cfg_of(T, quant, mixer_impl="dense")
    acfg = async_cfg(T)
    step = T.make_round_step(loss_fn, cfg, spec, async_cfg=acfg,
                             device="cpu")
    st = T.init_async_state({"w": torch.zeros(M8, D)}, prng.PRNGKey(11),
                            acfg.speed)
    rm = []
    for _ in range(8):
        st, mt = step(st, {"c": B8})
        rm.append(mt)
    for kw in (dict(spec=spec), dict(ring_self_weight=0.5)):
        pool = T.ClientPool(TEMPLATE, M8)
        runner = T.PooledAsyncRunner(
            pool, loss_fn, cfg, acfg, lambda ids, vers: {"c": B8[ids]},
            key=prng.PRNGKey(11), capacity=M8, device="cpu", **kw)
        pm = runner.run(8)
        assert torch.equal(pool.fetch(np.arange(M8))["w"], st.params["w"])
        assert torch.equal(runner.version, st.version)
        np.testing.assert_array_equal(pool.versions, st.version.numpy())
        assert torch.equal(runner.next_ready, st.next_ready)
        for r in range(8):
            for k in ("loss", "clock", "ready_frac", "live_edges"):
                assert float(rm[r][k]) == float(pm[r][k]), (r, k)


def test_pooled_async_capacity_overflow_raises():
    pool = T.ClientPool(TEMPLATE, 8)
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.5, local_steps=2)
    acfg = T.AsyncConfig(speed=T.SpeedModel.constant())  # all 8 fire
    runner = T.PooledAsyncRunner(
        pool, loss_fn, cfg, acfg,
        lambda ids, vers: {"c": torch.zeros(ids.shape[0], 2, D)},
        key=prng.PRNGKey(0), capacity=4, ring_self_weight=0.5,
        device="cpu")
    with pytest.raises(RuntimeError, match="capacity"):
        runner.step_event()


def test_telemetry_and_tracer_are_refused():
    """Telemetry and a tracer were refused until the telemetry slice;
    now the runner takes both and a round carries the telemetry's fields
    (``test_torch_telemetry.py`` holds their values)."""
    from repro_torch.telemetry import Tracer
    psched = T.PoolSchedule.ring_partial(M, 0.34)
    tracer = Tracer()
    runner = T.PooledRunner(T.ClientPool(TEMPLATE, M), psched, loss_fn,
                            cfg_of(T), batch_rows, key=prng.PRNGKey(7),
                            device="cpu", telemetry=True, tracer=tracer)
    met = runner.round()
    runner.close()
    assert met["cohort_size"] == psched.cohort_size
    assert "pool/step" in tracer.durations()
    step = T.make_pooled_round_step(loss_fn, cfg_of(T), psched, TEMPLATE,
                                    with_telemetry=True, device="cpu")
    assert step.step is not None


def test_cohort_lane_map_keeps_in_cohort_sources():
    """A plan step's source inside the cohort maps to its lane with the
    submatrix weight; outside the cohort (or idle) the lane reads itself
    at weight 0."""
    src = torch.as_tensor(T.ring_matching_src(8).astype(np.int64))
    idx = torch.tensor([1, 2, 5, 6])
    W = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    lane_src, w = _cohort_lane_map(src, idx, W)
    # step 0 pairs (0,1) (2,3) (4,5) (6,7); step 1 pairs (0,7) (1,2) ...
    assert lane_src.tolist() == [[0, 1, 2, 3], [1, 0, 3, 2]]
    assert w.tolist() == [[0.0, 0.0, 0.0, 0.0], [1.0, 4.0, 11.0, 14.0]]


# ---------------------------------------------------------------------------
# Against the reference's own pool, on the same seed
# ---------------------------------------------------------------------------

def run_both(kind, backend, quant, rounds=ROUNDS):
    """The port's and the reference's PooledRunner on the same key and
    data: per-round cohort ids, versions, losses, and the final store."""
    if kind == "partial":
        tps, jps = (T.PoolSchedule.ring_partial(M, 0.34),
                    J.PoolSchedule.ring_partial(M, 0.34))
    else:
        tps = T.PoolSchedule.ring_random_walk(M, horizon=64, seed=3)
        jps = J.PoolSchedule.ring_random_walk(M, horizon=64, seed=3)
    ids = {"port": {}, "ref": {}}

    def t_batch(idx, t):
        ids["port"][t] = idx.numpy().copy()
        return batch_rows(idx, t)

    def j_batch(idx, t):
        ids["ref"][t] = np.asarray(idx).copy()
        return {"c": jnp.asarray(CS)[idx][:, None].repeat(4, 1)}

    tpool = T.ClientPool(TEMPLATE, M)
    jpool = J.ClientPool({"w": jnp.zeros((D,))}, M)
    tr = T.PooledRunner(tpool, tps, loss_fn, cfg_of(T, quant), t_batch,
                        key=prng.PRNGKey(7), backend=backend, device="cpu")
    jr = J.PooledRunner(jpool, jps, j_loss, cfg_of(J, quant), j_batch,
                        key=jax.random.PRNGKey(7), backend=backend)
    out = []
    for _ in range(rounds):
        tm, jm = tr.round(), jr.round()
        np.testing.assert_array_equal(tpool.versions, jpool.versions)
        out.append((float(tm["loss"]), float(jm["loss"])))
    return ids, out, tpool, jpool


@pytest.mark.parametrize("kind,backend,quant", [
    ("partial", "dense", None), ("partial", "dense", Q8),
    ("partial", "sparse", None), ("partial", "sparse", Q8),
    ("walk", "dense", Q8)], ids=["dense-fp32", "dense-q8", "sparse-fp32",
                                 "sparse-q8", "walk-q8"])
def test_pooled_runner_matches_the_reference(kind, backend, quant):
    ids, losses, tpool, jpool = run_both(kind, backend, quant)
    assert ids["port"].keys() == ids["ref"].keys()
    for t in ids["ref"]:
        np.testing.assert_array_equal(ids["port"][t], ids["ref"][t])
    for a, b in losses:
        assert a == pytest.approx(b, rel=RTOL)
    np.testing.assert_allclose(tpool.fetch(np.arange(M))["w"].numpy(),
                               np.asarray(jpool.fetch(np.arange(M))["w"]),
                               rtol=RTOL, atol=1e-7)


def test_pooled_inputs_and_wire_words_match_the_reference():
    """One pooled round's inputs on the same key: cohort, gathered client
    keys, submatrix and full-width-gathered leaf keys bitwise; then the
    2NN's wire words (m 4, the cohort's lanes) encoded by each package
    from the same numpy delta under those keys, bitwise."""
    m = 4
    tps, jps = (T.PoolSchedule.ring_partial(m, 0.5),
                J.PoolSchedule.ring_partial(m, 0.5))
    tmpl = tnets.init_2nn(0, d_in=32, d_hidden=16, device="cpu")
    jtmpl = jnets.init_2nn(jax.random.PRNGKey(0), d_in=32, d_hidden=16)
    q = T.QuantConfig(bits=8)
    cfg, jcfg = (T.DFedAvgMConfig(quant=q),
                 J.DFedAvgMConfig(quant=J.QuantConfig(bits=8)))
    rs = T.make_pooled_round_step(loss_fn, cfg, tps, tmpl, device="cpu")
    jrs = J.make_pooled_round_step(j_loss, jcfg, jps, jtmpl)
    inp = rs.inputs(prng.PRNGKey(3), 2)
    jinp = jrs.inputs(jax.random.PRNGKey(3), 2)
    assert inp["idx"].tolist() == np.asarray(jinp["idx"]).tolist()
    for name in ("client_keys", "leaf_keys", "key_q"):
        np.testing.assert_array_equal(inp[name].numpy(),
                                      np.asarray(jinp[name]).astype(np.int64))
    np.testing.assert_array_equal(inp["W_sub"].numpy(),
                                  np.asarray(jinp["W_sub"]))
    k = tps.cohort_size
    rng = np.random.default_rng(4)
    delta = {n: (rng.normal(size=(k,) + tuple(t.shape)) * 0.01).astype(
        np.float32) for n, t in tmpl.items()}
    lay = WireLayout.for_tree(tmpl, 8)
    td = lay.to_planar_stacked({n: torch.from_numpy(a)
                                for n, a in delta.items()})
    words = lay.encode(td, lay.leaf_scales(td, q), q,
                       keys=inp["leaf_keys"])
    jlay = JWireLayout.for_tree(jtmpl, bits=8)
    jd = jlay.to_planar_stacked(convert.params_to_numpy(
        {n: torch.from_numpy(a) for n, a in delta.items()}))
    jwords = jlay.encode(jd, jlay.leaf_scales(jd, jcfg.quant), jcfg.quant,
                         leaf_keys=jinp["leaf_keys"])
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jwords).view(np.int32))
    full = j_leaf_keys(jinp["key_q"], len(tmpl), m)[:, jinp["idx"]]
    np.testing.assert_array_equal(np.asarray(full),
                                  np.asarray(jinp["leaf_keys"]))


def test_pooled_2nn_matches_the_reference_at_m4():
    """The 2NN (d_in 32, hidden 16) pooled at m 4, k 2 on the plan
    realization, fp32: both packages' stores within rtol 1e-5 after 3
    rounds on the same data."""
    m = 4
    rng = np.random.default_rng(6)
    x = rng.normal(size=(m, 2, 8, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=(m, 2, 8))
    p0 = tnets.init_2nn(0, d_in=32, d_hidden=16, device="cpu")
    jp0 = jax.tree.map(np.asarray, jnets.init_2nn(jax.random.PRNGKey(0),
                                                  d_in=32, d_hidden=16))

    def t_loss(p, b, r):
        return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])

    def j2_loss(p, b, r):
        return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])

    tr = T.PooledRunner(
        T.ClientPool(p0, m), T.PoolSchedule.ring_partial(m, 0.5), t_loss,
        T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2),
        lambda idx, t: {"x": torch.from_numpy(x)[idx],
                        "y": torch.from_numpy(y)[idx]},
        key=prng.PRNGKey(1), backend="sparse", device="cpu")
    jr = J.PooledRunner(
        J.ClientPool(jp0, m), J.PoolSchedule.ring_partial(m, 0.5), j2_loss,
        J.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2),
        lambda idx, t: {"x": jnp.asarray(x)[idx], "y": jnp.asarray(y)[idx]},
        key=jax.random.PRNGKey(1), backend="sparse")
    for _ in range(3):
        a, b = float(tr.round()["loss"]), float(jr.round()["loss"])
        assert a == pytest.approx(b, rel=RTOL)
    np.testing.assert_array_equal(tr.pool.versions, jr.pool.versions)
    got = tr.pool.fetch(np.arange(m))
    want = jr.pool.fetch(np.arange(m))
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("quant", [None, Q8], ids=["fp32", "q8"])
def test_pooled_async_matches_the_reference(quant):
    """The async pool against the reference's ``PooledAsyncRunner`` on
    the structural ring at m 8 (capacity 8): versions and the ready
    fraction equal at every event, clock within rtol 1e-6, loss and
    params within rtol 1e-5."""
    tr = T.PooledAsyncRunner(
        T.ClientPool(TEMPLATE, M8), loss_fn, cfg_of(T, quant),
        async_cfg(T), lambda ids, vers: {"c": B8[ids]},
        key=prng.PRNGKey(11), capacity=M8, ring_self_weight=0.5,
        device="cpu")
    jr = J.PooledAsyncRunner(
        J.ClientPool({"w": jnp.zeros((D,))}, M8), j_loss, cfg_of(J, quant),
        async_cfg(J),
        lambda ids, vers: {"c": jnp.asarray(CS8)[ids][:, None].repeat(4, 1)},
        key=jax.random.PRNGKey(11), capacity=M8, ring_self_weight=0.5)
    for _ in range(8):
        tm, jm = tr.step_event(), jr.step_event()
        np.testing.assert_array_equal(tr.version.numpy(), jr.version)
        np.testing.assert_array_equal(tr.pool.versions, jr.pool.versions)
        assert tm["ready_frac"] == float(jm["ready_frac"])
        assert float(tm["clock"]) == pytest.approx(float(jm["clock"]),
                                                   rel=1e-6)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=RTOL)
    np.testing.assert_allclose(tr.pool.fetch(np.arange(M8))["w"].numpy(),
                               np.asarray(jr.pool.fetch(np.arange(M8))["w"]),
                               rtol=RTOL, atol=1e-7)


def test_execute_plan_reference_matches_the_reference():
    """``execute_plan_reference`` fp32 and q8 against the reference's on
    one sampled W_t of the partial schedule (M 12, D 5)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(M, D)).astype(np.float32)
    z = (x + 0.1 * rng.normal(size=(M, D))).astype(np.float32)
    sched, jsched = sched_partial(), sched_partial(J)
    W, _, key_q = sched.round_event(prng.PRNGKey(2), 0)
    jW, _, jkey_q = jsched.round_event(jax.random.PRNGKey(2), 0)
    np.testing.assert_array_equal(W.numpy(), np.asarray(jW))
    for quant in (None, Q8):
        q = None if quant is None else T.QuantConfig(**quant)
        jq = None if quant is None else J.QuantConfig(**quant)
        got = T.execute_plan_reference(
            sched.gossip_plan(), W, {"w": torch.from_numpy(z)},
            x={"w": torch.from_numpy(x)}, quant=q, key=key_q)["w"]
        want = J.execute_plan_reference(
            jsched.gossip_plan(), jW, {"w": jnp.asarray(z)},
            x={"w": jnp.asarray(x)}, quant=jq, key=jkey_q)["w"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-7)
