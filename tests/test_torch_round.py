"""Port parity for the slice as a whole: three rounds of the port's
quantized DFedAvgM round on the CPU against the JAX package's round on a
one-device client mesh (``mixer_impl="ring"``, ``wire="planar"``, the
Pallas momentum update, all in interpret mode), from the same parameters
(via ``convert``), the same numpy batches and the same ``PRNGKey``; plus
the pieces the round is built from (2NN, loss, data, conversion).

Contracts: loss and consensus within rtol 1e-5. Parameters within a few
ulp, except elements where a stochastic-rounding decision flipped
because the two frameworks' matmul reductions differ: those may move by
up to one quantizer step times a mixing weight (8-bit steps of these
deltas are below 1e-4), and they must stay under 0.1 % of all elements.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import DFedAvgMConfig as JConfig  # noqa: E402
from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import init_round_state as j_init  # noqa: E402
from repro.core import make_round_step as j_make_round_step  # noqa: E402
from repro.core import round_comm_bits as j_round_comm_bits  # noqa: E402
from repro.data import FederatedDataset as JFed  # noqa: E402
from repro.data import classification_dataset as j_dataset  # noqa: E402
from repro.kernels.ops import make_fused_momentum_update  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import (AsyncConfig, DFedAvgMConfig,  # noqa: E402
                              MixingSpec, QuantConfig,
                              TopologySchedule, average_params,
                              init_round_state, make_round_step,
                              ring_graph, round_comm_bits)
from repro_torch.data import FederatedDataset, classification_dataset  # noqa: E402,E501
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, K, B, ROUNDS = 4, 2, 8, 3
D_IN, HID = 32, 16
PARAM_ULP_ATOL = 1e-6        # a few ulp at |x| ~ 0.5
FLIP_ATOL = 1e-4             # one 8-bit quantizer step x weight
FLIP_SHARE = 1e-3


def j_loss(p, b, rng):
    return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def setup():
    data = j_dataset(n=400, d=D_IN, seed=0)
    params = jnets.init_2nn(jax.random.PRNGKey(0), d_in=D_IN, d_hidden=HID)
    np_params = jax.tree.map(np.asarray, params)
    return data, params, np_params


@pytest.mark.parametrize("quant", [dict(bits=8), None],
                         ids=["q8-lemma5-stoch", "fp32"])
def test_three_rounds_track_jax_one_device_mesh(quant):
    data, params, np_params = setup()
    fed = JFed.make(data, M)
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), params)
    jcfg = JConfig(eta=0.05, theta=0.9, local_steps=K,
                   quant=None if quant is None else JQuantConfig(**quant),
                   mixer_impl="ring", wire="planar")
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jstep = jax.jit(j_make_round_step(
        j_loss, jcfg, JMixingSpec.ring(M, self_weight=0.5), mesh=mesh,
        client_axes=("clients",),
        fused_update=make_fused_momentum_update(interpret=True)))
    js = j_init(stacked, jax.random.PRNGKey(1))

    tfed = FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                        seed=0), M)
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                         quant=None if quant is None
                         else QuantConfig(**quant))
    step = make_round_step(t_loss, cfg, MixingSpec.ring(M, self_weight=0.5),
                           device="cpu")
    ts = init_round_state(convert.params_from_numpy(np_params, stack=M,
                                                    device="cpu"),
                          prng.PRNGKey(1))
    for t in range(ROUNDS):
        js, jm = jstep(js, fed.round_batches(t, K=K, batch=B))
        ts, tm = step(ts, tfed.round_batches(t, K=K, batch=B, device="cpu"))
        for name in ("loss", "consensus_dist", "local_drift"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-5), (t, name)
    assert np.array_equal(np.asarray(js.rng).astype(np.int64),
                          ts.rng.numpy())
    total = flipped = 0
    for n, got in convert.params_to_numpy(ts.params).items():
        want = np.asarray(js.params[n])
        err = np.abs(got - want)
        assert err.max() <= FLIP_ATOL, n
        flipped += int((err > PARAM_ULP_ATOL).sum())
        total += err.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)


def test_round_state_and_metrics_shapes():
    _, _, np_params = setup()
    step = make_round_step(t_loss, DFedAvgMConfig(
        eta=0.05, local_steps=K, quant=QuantConfig(bits=8)),
        MixingSpec.ring(M, self_weight=0.5), device="cpu")
    tfed = FederatedDataset.make(classification_dataset(n=200, d=D_IN), M)
    s0 = init_round_state(convert.params_from_numpy(np_params, stack=M,
                                                    device="cpu"),
                          prng.PRNGKey(1))
    s1, met = step(s0, tfed.round_batches(0, K=K, batch=B, device="cpu"))
    assert s1.round == 1 and set(met) == {"loss", "consensus_dist",
                                          "local_drift"}
    for n, t in s1.params.items():
        assert t.shape == s0.params[n].shape and torch.isfinite(t).all()
    avg = average_params(s1.params)
    assert avg["w1"].shape == (D_IN, HID)


def test_unported_branches_raise():
    spec = MixingSpec.ring(M)
    with pytest.raises(ValueError, match="local_steps >= 2"):
        make_round_step(t_loss, DFedAvgMConfig(fuse_round=True,
                                               local_steps=1), spec,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="A16"):
        make_round_step(t_loss, DFedAvgMConfig(), spec, device="cpu",
                        with_telemetry=True)
    # The async engine runs now (test_torch_async.py); with a placement
    # it is refused, as in the reference.
    with pytest.raises(ValueError, match="placement"):
        make_round_step(t_loss, DFedAvgMConfig(), spec, device="cpu",
                        async_cfg=AsyncConfig(), placement=object())
    # Neither a MixingSpec nor a schedule: refused, as in the reference.
    with pytest.raises(TypeError, match="MixingSpec or a TopologySchedule"):
        make_round_step(t_loss, DFedAvgMConfig(), object(), device="cpu")
    with pytest.raises(AttributeError):
        j_make_round_step(j_loss, JConfig(), object())
    # Schedules run now; their telemetry waits for A16.
    with pytest.raises(NotImplementedError, match="A16"):
        make_round_step(t_loss, DFedAvgMConfig(), TopologySchedule.partial(
            ring_graph(M), 0.5), device="cpu", with_telemetry=True)


def test_2nn_apply_and_loss_match_jax():
    _, params, np_params = setup()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(M, B, D_IN)).astype(np.float32)
    y = rng.integers(0, 10, size=(M, B))
    tp = convert.params_from_numpy(np_params, stack=M, device="cpu")
    logits = tnets.apply_2nn(tp, torch.from_numpy(x))
    losses = tnets.softmax_xent(logits, torch.from_numpy(y))
    for c in range(M):
        jl = jnets.apply_2nn(params, jnp.asarray(x[c]))
        np.testing.assert_allclose(logits[c].numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-6)
        assert float(losses[c]) == pytest.approx(
            float(jnets.softmax_xent(jl, jnp.asarray(y[c]))), rel=1e-5)


def test_init_2nn_full_width():
    p = tnets.init_2nn(0, device="cpu")
    assert tnets.count_params(p) == 199210
    assert {n: tuple(t.shape) for n, t in p.items()} == {
        "w1": (784, 200), "b1": (200,), "w2": (200, 200), "b2": (200,),
        "w3": (200, 10), "b3": (10,)}
    assert float(p["w1"].std()) == pytest.approx(1 / np.sqrt(784), rel=0.02)
    assert torch.equal(p["w2"], tnets.init_2nn(0, device="cpu")["w2"])


def test_data_and_batches_match_jax():
    jd = j_dataset(n=300, d=D_IN, seed=3)
    td = classification_dataset(n=300, d=D_IN, seed=3)
    assert np.array_equal(jd.x, td.x) and np.array_equal(jd.y, td.y)
    for iid in (True, False):
        jf, tf = JFed.make(jd, M, iid=iid), FederatedDataset.make(td, M,
                                                                iid=iid)
        jb = jf.round_batches(5, K=K, batch=B)
        tb = tf.round_batches(5, K=K, batch=B, device="cpu")
        assert np.array_equal(np.asarray(jb["x"]), tb["x"].numpy())
        assert np.array_equal(np.asarray(jb["y"]), tb["y"].numpy())
        assert np.array_equal(jf.label_histogram(), tf.label_histogram())


def test_convert_round_trip_keeps_names_order_and_dtypes():
    _, _, np_params = setup()
    tp = convert.params_from_numpy(np_params, device="cpu")
    assert list(tp) == ["b1", "b2", "b3", "w1", "w2", "w3"]
    back = convert.params_to_numpy(tp)
    for n, a in np_params.items():
        assert back[n].dtype == a.dtype and np.array_equal(back[n], a)
    st = convert.params_from_numpy(np_params, stack=3, device="cpu")
    assert st["w1"].shape == (3, D_IN, HID) and st["w1"].is_contiguous()


def test_round_comm_bits_matches_jax():
    for q in (None, dict(bits=8), dict(bits=4)):
        assert round_comm_bits(MixingSpec.ring(16, 0.5), 199210,
                               None if q is None else QuantConfig(**q)) == \
            j_round_comm_bits(JMixingSpec.ring(16, 0.5), 199210,
                              None if q is None else JQuantConfig(**q))
