"""Port parity for the async gossip engine (``repro_torch.core.
async_gossip``) against the JAX package's ``repro.core.async_gossip``, on
the CPU: the staleness weights and eta; constant speed against the
port's own synchronous round; straggler runs of 24 events against the
reference (a quadratic problem at m 8, D 12 on the dense and the plan
realization, and the 2NN at m 4 on the plan realization with the 8-bit
wire); the engine against the event loop; ``ready_capacity``; and what
the engine refuses.

Contracts: weights and eta bitwise (``power`` too: torch's ``pow`` of
gamma by small integers matched XLA's in every draw); constant speed
bitwise with the synchronous round; against the reference the ready
masks, versions and event counter equal at every event, the clock within
rtol 1e-6, loss and consensus within rtol 1e-5, parameters within rtol
1e-5 (the 2NN's stochastic-rounding flips as ``test_torch_round``: at
most one quantizer step, on under 0.1 % of the elements); the engine and
``ready_capacity=1`` bitwise with the port's full-width event loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro import core as J  # noqa: E402
from repro.data import FederatedDataset as JFed  # noqa: E402
from repro.data import classification_dataset as j_dataset  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.data import FederatedDataset, classification_dataset  # noqa: E402,E501
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, D = 8, 12
EVENTS = 24
FLIP_ATOL = 1e-4             # one 8-bit quantizer step x weight
FLIP_SHARE = 1e-3


def quad(m=M, seed=0):
    """Client targets and start points [m, D] (numpy), the reference's
    and the port's losses and batches (K = 2 steps on the target)."""
    rng = np.random.default_rng(seed)
    cs = rng.normal(size=(m, D)).astype(np.float32)
    w0 = rng.normal(size=(m, D)).astype(np.float32)
    batches = np.ascontiguousarray(np.broadcast_to(cs[:, None], (m, 2, D)))
    return (w0, lambda p, b, r: 0.5 * jnp.sum((p["w"] - b["c"]) ** 2),
            lambda p, b, r: 0.5 * ((p["w"] - b["c"]) ** 2).sum(-1),
            {"c": jnp.asarray(batches)}, {"c": torch.from_numpy(batches)})


def both(L, **kw):
    """The same object built in the reference (L = J) and the port (T)."""
    return L.AsyncConfig(**{k: (v(L) if callable(v) else v)
                            for k, v in kw.items()})


def straggler(L, m=M):
    return L.SpeedModel.straggler(mean=1.0, sigma=0.5, frac=1 / m,
                                  factor=10.0)


def test_staleness_weights_bitwise_inverse_rows_stochastic():
    """``inverse`` bitwise over random versions and ready masks, on the
    ring and on an ER support; every row sums to 1 (within f32), the
    support stays inside W's, busy rows are e_i."""
    rng = np.random.default_rng(1)
    cfg = T.AsyncConfig(max_staleness=4)
    jcfg = J.AsyncConfig(max_staleness=4)
    Ws = [T.MixingSpec.ring(M, 0.5).W,
          T.MixingSpec.dense(T.erdos_renyi_graph(M, 0.5, seed=2)).W]
    for W in Ws:
        W32 = np.asarray(W, np.float32)
        for _ in range(25):
            version = rng.integers(0, 9, size=M).astype(np.int32)
            ready = (rng.random(M) < 0.6).astype(np.float32)
            got = T.staleness_weights(torch.from_numpy(W32),
                                      torch.from_numpy(version),
                                      torch.from_numpy(ready), cfg).numpy()
            want = np.asarray(J.staleness_weights(W32, jnp.asarray(version),
                                                  jnp.asarray(ready), jcfg))
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
            assert np.allclose(got.sum(1), 1.0, atol=1e-6)
            assert (got >= 0).all()
            off = ~np.eye(M, dtype=bool)
            assert not ((got != 0) & off & (W32 == 0)).any()
            for i in np.nonzero(ready == 0)[0]:
                assert np.array_equal(got[i], np.eye(M)[i])


def test_staleness_weights_power_bitwise():
    """``power``: gamma**s by torch's pow against XLA's, bitwise."""
    rng = np.random.default_rng(2)
    cfg = T.AsyncConfig(max_staleness=6, discount="power", gamma=0.6)
    jcfg = J.AsyncConfig(max_staleness=6, discount="power", gamma=0.6)
    W32 = np.asarray(T.MixingSpec.ring(M, 0.5).W, np.float32)
    for _ in range(25):
        version = rng.integers(0, 9, size=M).astype(np.int32)
        ready = (rng.random(M) < 0.7).astype(np.float32)
        got = T.staleness_weights(torch.from_numpy(W32),
                                  torch.from_numpy(version),
                                  torch.from_numpy(ready), cfg).numpy()
        want = np.asarray(J.staleness_weights(W32, jnp.asarray(version),
                                              jnp.asarray(ready), jcfg))
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        assert np.allclose(got.sum(1), 1.0, atol=1e-6)


def test_staleness_eta_bitwise():
    rng = np.random.default_rng(3)
    for decay in (0.0, 0.5, 1.7):
        for _ in range(10):
            version = rng.integers(0, 12, size=M).astype(np.int32)
            got = T.staleness_eta(0.05, torch.from_numpy(version), decay)
            want = J.staleness_eta(0.05, jnp.asarray(version), decay)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    same = T.staleness_eta(0.05, torch.full((M,), 3, dtype=torch.int32),
                           0.5)
    assert torch.equal(same, torch.full((M,), np.float32(0.05)))


def _2nn_start(m):
    tfed = FederatedDataset.make(classification_dataset(n=400, d=32,
                                                        seed=0), m)
    p0 = {n: t.expand((m,) + t.shape).contiguous() for n, t in
          tnets.init_2nn(0, d_in=32, d_hidden=16, device="cpu").items()}
    return tfed, p0


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def j_loss(p, b, rng):
    return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])


def _schedule(kind):
    return {"ring": lambda: T.MixingSpec.ring(M, 0.5),
            "constant": lambda: T.TopologySchedule.constant(
                T.MixingSpec.ring(M, 0.5)),
            "edge_sample": lambda: T.TopologySchedule.edge_sample(
                T.ring_graph(M), 0.7),
            "cycle": lambda: T.TopologySchedule.cycle(
                [T.MixingSpec.ring(M, 0.5), T.MixingSpec.torus(2, M // 2)])
            }[kind]()


@pytest.mark.parametrize("decay", [0.0, 0.5], ids=["eta", "decay"])
@pytest.mark.parametrize("quant", [None, 8], ids=["fp32", "q8"])
@pytest.mark.parametrize("kind", ["ring", "constant", "edge_sample",
                                  "cycle"])
def test_zero_delay_async_bit_identical_to_sync(kind, quant, decay):
    """A constant speed model fires every client every event: through
    ``make_round_step(..., async_cfg=...)`` the engine is the port's
    synchronous round bit for bit (parameters, key, loss), on the plan
    realization (``"auto"``), with the decay too (zero lag scales eta by
    exactly 1)."""
    tfed, p0 = _2nn_start(M)
    spec = _schedule(kind)
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                           quant=None if quant is None
                           else T.QuantConfig(bits=quant))
    acfg = T.AsyncConfig(speed=T.SpeedModel.constant(),
                         eta_staleness_decay=decay)
    sync = T.make_round_step(t_loss, cfg, spec, device="cpu")
    event = T.make_round_step(t_loss, cfg, spec, device="cpu",
                              async_cfg=acfg)
    s = T.init_round_state(p0, prng.PRNGKey(1))
    a = T.init_async_state(p0, prng.PRNGKey(1), acfg.speed)
    for t in range(3):
        b = tfed.round_batches(t, K=2, batch=8, device="cpu")
        s, ms = sync(s, b)
        a, ma = event(a, b)
        assert torch.equal(ms["loss"], ma["loss"]), t
        assert float(ma["ready_frac"]) == 1.0 and float(ma["clock"]) == t + 1
    for n in s.params:
        assert torch.equal(s.params[n], a.params[n]), n
    assert torch.equal(s.rng, a.rng)
    assert torch.equal(a.version, torch.full((M,), 3, dtype=torch.int32))
    assert int(a.round) == 3


def _ref_step(jl, acfg, spec, quant, impl):
    """The reference's jitted event step: the dense mixer, or the plan
    realization on a one-device client mesh (Pallas in interpret
    mode)."""
    jcfg = J.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                            quant=None if quant is None
                            else J.QuantConfig(bits=quant),
                            mixer_impl=impl,
                            wire="planar" if impl != "dense" else "auto")
    if impl == "dense":
        return jax.jit(J.make_async_round_step(jl, jcfg, spec, acfg))
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    return jax.jit(J.make_async_round_step(jl, jcfg, spec, acfg, mesh=mesh,
                                           client_axes=("clients",)))


def _assert_event_tracks(e, js, jm, ts, tm):
    assert int(js.round) == int(ts.round) == e + 1
    assert np.array_equal(np.asarray(js.version), ts.version.numpy()), e
    np.testing.assert_allclose(ts.next_ready.numpy(),
                               np.asarray(js.next_ready), rtol=1e-6)
    assert float(tm["clock"]) == pytest.approx(float(jm["clock"]),
                                               rel=1e-6)
    for k in ("ready_frac", "live_edges", "max_staleness"):
        assert float(tm[k]) == float(jm[k]), (e, k)
    for k in ("loss", "consensus_dist", "mean_staleness"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                             abs=1e-12), (e, k)


@pytest.mark.parametrize("decay", [0.0, 0.5], ids=["eta", "decay"])
@pytest.mark.parametrize("quant,impl", [(None, "dense"), (8, "ring")],
                         ids=["fp32-dense", "q8-plan"])
def test_straggler_events_track_reference(quant, impl, decay):
    """24 events under a straggler tail (one client 10x slower), from
    the same start and key: the same clients fire at every event, the
    versions and counters agree, the trajectory within the contract."""
    w0, jl, tl, jb, tb = quad()
    ja = both(J, speed=straggler, max_staleness=4,
              eta_staleness_decay=decay)
    ta = both(T, speed=straggler, max_staleness=4,
              eta_staleness_decay=decay)
    jstep = _ref_step(jl, ja, J.MixingSpec.ring(M, 0.5), quant, impl)
    tcfg = T.DFedAvgMConfig(eta=0.1, theta=0.9, local_steps=2,
                            quant=None if quant is None
                            else T.QuantConfig(bits=quant),
                            mixer_impl=impl)
    tstep = T.make_async_round_step(tl, tcfg, T.MixingSpec.ring(M, 0.5), ta,
                                    device="cpu")
    js = J.init_async_state({"w": jnp.asarray(w0)}, jax.random.PRNGKey(1),
                            ja.speed)
    ts = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                            prng.PRNGKey(1), ta.speed)
    lags = set()
    for e in range(EVENTS):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        _assert_event_tracks(e, js, jm, ts, tm)
        np.testing.assert_allclose(ts.params["w"].numpy(),
                                   np.asarray(js.params["w"]), rtol=1e-5,
                                   atol=1e-6)
        lags.add(int(tm["max_staleness"]))
    assert max(lags) >= 2                   # staleness developed
    assert np.array_equal(np.asarray(js.rng).astype(np.int64),
                          ts.rng.numpy())
    assert np.array_equal(np.asarray(js.clock_rng).astype(np.int64),
                          ts.clock_rng.numpy())


@pytest.mark.parametrize("decay", [0.0, 0.5], ids=["eta", "decay"])
def test_2nn_straggler_events_track_reference_plan_q8(decay):
    """The kernel-bearing path at m 4: the 2NN, 8-bit stochastic lemma5
    wire on the plan realization (B1, B2 in the port; the reference's
    Pallas buffer kernels in interpret mode), B3 with a per-client eta
    under the decay; 24 straggler events."""
    m = 4
    data = j_dataset(n=400, d=32, seed=0)
    params = jnets.init_2nn(jax.random.PRNGKey(0), d_in=32, d_hidden=16)
    np_params = jax.tree.map(np.asarray, params)
    fed = JFed.make(data, m)
    tfed = FederatedDataset.make(classification_dataset(n=400, d=32,
                                                        seed=0), m)
    ja = both(J, speed=lambda L: straggler(L, m), eta_staleness_decay=decay)
    ta = both(T, speed=lambda L: straggler(L, m), eta_staleness_decay=decay)
    jcfg = J.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                            quant=J.QuantConfig(bits=8), mixer_impl="ring",
                            wire="planar")
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jstep = jax.jit(J.make_async_round_step(
        j_loss, jcfg, J.MixingSpec.ring(m, 0.5), ja, mesh=mesh,
        client_axes=("clients",)))
    tcfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                            quant=T.QuantConfig(bits=8))
    tstep = T.make_async_round_step(t_loss, tcfg, T.MixingSpec.ring(m, 0.5),
                                    ta, device="cpu")
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (m,) + t.shape), params)
    js = J.init_async_state(stacked, jax.random.PRNGKey(1), ja.speed)
    ts = T.init_async_state(convert.params_from_numpy(np_params, stack=m,
                                                      device="cpu"),
                            prng.PRNGKey(1), ta.speed)
    for e in range(EVENTS):
        js, jm = jstep(js, fed.round_batches(e, K=2, batch=8))
        ts, tm = tstep(ts, tfed.round_batches(e, K=2, batch=8,
                                              device="cpu"))
        _assert_event_tracks(e, js, jm, ts, tm)
    total = flipped = 0
    for n, got in convert.params_to_numpy(ts.params).items():
        err = np.abs(got - np.asarray(js.params[n]))
        assert err.max() <= FLIP_ATOL, n
        flipped += int((err > 1e-5 * np.abs(got) + 1e-6).sum())
        total += err.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)


def _engine_setup(m=M):
    tfed, p0 = _2nn_start(m)
    batches = [tfed.round_batches(e, K=2, batch=8, device="cpu")
               for e in range(12)]
    stacked = {n: torch.stack([b[n] for b in batches]) for n in batches[0]}
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=2,
                           quant=T.QuantConfig(bits=8))
    return p0, batches, stacked, cfg


@pytest.mark.parametrize("decay", [0.0, 0.5], ids=["eta", "decay"])
def test_engine_bit_identical_to_event_loop(decay):
    p0, batches, stacked, cfg = _engine_setup()
    acfg = T.AsyncConfig(speed=straggler(T), eta_staleness_decay=decay)
    spec = _schedule("edge_sample")
    step = T.make_async_round_step(t_loss, cfg, spec, acfg, device="cpu")
    run = T.make_async_engine(t_loss, cfg, spec, acfg, device="cpu")
    s = s0 = T.init_async_state(p0, prng.PRNGKey(1), acfg.speed)
    loop = []
    for b in batches:
        s, met = step(s, b)
        loop.append(met)
    e, mets = run(s0, stacked)
    for k, v in mets.items():
        assert v.shape == (len(batches),), k
        assert torch.equal(v, torch.stack([m_[k] for m_ in loop])), k
    for f in T.AsyncRoundState._fields:
        a, b = getattr(s, f), getattr(e, f)
        if f == "params":
            assert all(torch.equal(a[n], b[n]) for n in a)
        else:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("decay", [0.0, 0.5], ids=["eta", "decay"])
def test_ready_capacity_one_equals_full_width(decay):
    """``ready_capacity=1`` trains one gathered lane an event (continuous
    times: one finisher each). Held bitwise against the port's
    full-width engine, and within the trajectory contract against the
    reference's full-width engine (the reference's own capacity path is
    not the yardstick: its bitwise test fails on this tree)."""
    w0, jl, tl, jb, tb = quad()
    runs = {}
    for cap in (None, 1):
        ta = T.AsyncConfig(speed=straggler(T), eta_staleness_decay=decay,
                           ready_capacity=cap)
        step = T.make_async_round_step(tl, T.DFedAvgMConfig(
            eta=0.1, theta=0.9, local_steps=2), T.MixingSpec.ring(M, 0.5),
            ta, device="cpu")
        s = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                               prng.PRNGKey(1), ta.speed)
        mets = []
        for _ in range(EVENTS):
            s, met = step(s, tb)
            mets.append(met)
        runs[cap] = (s, mets)
    (full, fm), (one, om) = runs[None], runs[1]
    assert torch.equal(full.params["w"], one.params["w"])
    assert torch.equal(full.version, one.version)
    assert torch.equal(full.next_ready, one.next_ready)
    for a, b in zip(fm, om):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    ja = both(J, speed=straggler, eta_staleness_decay=decay)
    jstep = _ref_step(jl, ja, J.MixingSpec.ring(M, 0.5), None, "dense")
    js = J.init_async_state({"w": jnp.asarray(w0)}, jax.random.PRNGKey(1),
                            ja.speed)
    for e in range(EVENTS):
        js, jm = jstep(js, jb)
        assert float(om[e]["ready_frac"]) == 1 / M
    assert np.array_equal(np.asarray(js.version), one.version.numpy())
    np.testing.assert_allclose(one.params["w"].numpy(),
                               np.asarray(js.params["w"]), rtol=1e-5,
                               atol=1e-6)


def test_ready_capacity_defers_overflowing_lanes():
    """Under a constant speed model every lane is ready; capacity 3
    trains three and defers the rest to zero-duration events at the same
    virtual time, so after ceil(m / 3) events every version is 1."""
    w0, _, tl, _, tb = quad()
    ta = T.AsyncConfig(speed=T.SpeedModel.constant(), ready_capacity=3)
    step = T.make_async_round_step(tl, T.DFedAvgMConfig(eta=0.1),
                                   T.MixingSpec.ring(M, 0.5), ta,
                                   device="cpu")
    s = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                           prng.PRNGKey(1), ta.speed)
    clocks = []
    for _ in range(3):
        s, met = step(s, tb)
        clocks.append(float(met["clock"]))
    assert clocks == [1.0, 1.0, 1.0]
    assert s.version.tolist() == [1] * M
    assert torch.equal(s.next_ready, torch.full((M,), 2.0))


def test_refusals():
    spec = T.MixingSpec.ring(M)
    walk = T.TopologySchedule.random_walk(T.ring_graph(M), stateful=True)
    acfg = T.AsyncConfig()
    with pytest.raises(ValueError, match="data-independent schedule"):
        T.make_async_round_step(t_loss, T.DFedAvgMConfig(), walk, acfg,
                                device="cpu")
    with pytest.raises(ValueError, match="data-independent schedule"):
        J.make_async_round_step(j_loss, J.DFedAvgMConfig(),
                                J.TopologySchedule.random_walk(
                                    J.ring_graph(M), stateful=True),
                                J.AsyncConfig())
    with pytest.raises(NotImplementedError, match="A16"):
        T.make_async_round_step(t_loss, T.DFedAvgMConfig(), spec, acfg,
                                device="cpu", with_telemetry=True)
    with pytest.raises(ValueError, match="placement"):
        T.make_round_step(t_loss, T.DFedAvgMConfig(), spec, device="cpu",
                          async_cfg=acfg, placement=object())
    for bad in (dict(discount="linear"), dict(max_staleness=-1),
                dict(gamma=0.0), dict(eta_staleness_decay=-1.0),
                dict(ready_capacity=0)):
        with pytest.raises(ValueError):
            T.AsyncConfig(**bad)
        with pytest.raises(ValueError):
            J.AsyncConfig(**bad)
    step = T.make_async_round_step(t_loss, T.DFedAvgMConfig(), spec, acfg,
                                   device="cpu")
    _, p0 = _2nn_start(M)
    with pytest.raises(ValueError, match="needs batches"):
        step(T.init_async_state(p0, prng.PRNGKey(0), acfg.speed), None)
    run = T.make_async_engine(t_loss, T.DFedAvgMConfig(), spec, acfg,
                              device="cpu", batch_fn=lambda i, v: None)
    with pytest.raises(ValueError, match="n_events"):
        run(T.init_async_state(p0, prng.PRNGKey(0), acfg.speed))


def test_version_keyed_batch_fn_is_interleaving_free():
    """With a version-keyed ``batch_fn`` each client trains its k-th
    local round on the data of version k, whatever the interleaving: two
    speed models (different events) feed every client the same stream,
    and the engine (``run(state, n_events=N)``) equals the event loop."""
    w0, _, tl, _, _ = quad()
    seen = {}

    def batch_fn(ids, version):
        c = torch.sin(ids[:, None].to(torch.float32) * 0.7
                      + version[:, None].to(torch.float32) * 1.3
                      + torch.arange(D, dtype=torch.float32))
        return {"c": c[:, None].expand(M, 2, D).contiguous()}

    for name, speed in (("straggler", straggler(T)),
                        ("lognormal", T.SpeedModel.lognormal(sigma=1.0))):
        acfg = T.AsyncConfig(speed=speed)
        cfg = T.DFedAvgMConfig(eta=0.1, theta=0.9)
        step = T.make_async_round_step(tl, cfg, T.MixingSpec.ring(M, 0.5),
                                       acfg, device="cpu", batch_fn=batch_fn)
        s = s0 = T.init_async_state({"w": torch.from_numpy(w0.copy())},
                                    prng.PRNGKey(5), speed)
        fired = {i: [] for i in range(M)}
        for _ in range(EVENTS):
            before = s.version.clone()
            data = batch_fn(torch.arange(M, dtype=torch.int32), before)
            s, _ = step(s, None)
            for i in torch.nonzero(s.version != before).flatten().tolist():
                fired[i].append(data["c"][i, 0].clone())
        for i, stream in fired.items():     # version k trained on data k
            for k, d in enumerate(stream):
                want = batch_fn(torch.tensor([i], dtype=torch.int32),
                                torch.tensor([k], dtype=torch.int32))
                assert torch.equal(d, want["c"][0, 0]), (name, i, k)
        seen[name] = fired
        run = T.make_async_engine(tl, cfg, T.MixingSpec.ring(M, 0.5), acfg,
                                  device="cpu", batch_fn=batch_fn)
        e, mets = run(s0, n_events=EVENTS)
        assert torch.equal(e.params["w"], s.params["w"])
        assert mets["loss"].shape == (EVENTS,)
    a, b = seen["straggler"], seen["lognormal"]
    assert any(len(a[i]) != len(b[i]) for i in range(M))  # interleavings
    for i in range(M):
        for x, y in zip(a[i], b[i]):
            assert torch.equal(x, y)
