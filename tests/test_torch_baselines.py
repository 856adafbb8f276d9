"""Port parity: the FedAvg and DSGD baselines (``repro_torch.core.
baselines``) against the JAX package's ``make_fedavg_step`` and
``make_dsgd_step`` on the CPU — 3 rounds of the 2NN (m 4, K 2, batch 8)
from the same parameters (via ``convert``), numpy batches and key; the
port's FedAvg equals its DFedAvgM on the complete graph; the complete
graph and its W equal the reference's; the dense W reaches the device
once, when a mixer or DSGD step is built, not every round.

Contracts: loss, consensus and drift within rtol 1e-5; parameters within
2e-6 absolute (a few ulp at |x| ~ 0.5: matmul reductions differ between
the frameworks); keys bitwise; FedAvg vs DFedAvgM on the complete graph
within 1e-5 after 12 rounds, as the reference's own test holds it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DSGDConfig as JDSGDConfig  # noqa: E402
from repro.core import FedAvgConfig as JFedAvgConfig  # noqa: E402
from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import complete_graph as j_complete_graph  # noqa: E402
from repro.core import init_round_state as j_init  # noqa: E402
from repro.core import make_dsgd_step as j_make_dsgd_step  # noqa: E402
from repro.core import make_fedavg_step as j_make_fedavg_step  # noqa: E402
from repro.data import FederatedDataset as JFed  # noqa: E402
from repro.data import classification_dataset as j_dataset  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import (DFedAvgMConfig, DSGDConfig,  # noqa: E402
                              FedAvgConfig, MixingSpec, QuantConfig,
                              complete_graph, init_round_state,
                              make_dsgd_step, make_fedavg_step,
                              make_round_step)
from repro_torch.core import mixing  # noqa: E402
from repro_torch.data import FederatedDataset, classification_dataset  # noqa: E402,E501
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, K, B, ROUNDS = 4, 2, 8, 3
D_IN, HID = 32, 16
PARAM_ATOL = 2e-6


def j_loss(p, b, rng):
    return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def start():
    """Both packages' round states from the same 2NN and key."""
    params = jnets.init_2nn(jax.random.PRNGKey(0), d_in=D_IN, d_hidden=HID)
    np_params = jax.tree.map(np.asarray, params)
    js = j_init(jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), params),
        jax.random.PRNGKey(1))
    ts = init_round_state(convert.params_from_numpy(np_params, stack=M,
                                                    device="cpu"),
                          prng.PRNGKey(1))
    return js, ts


def feds():
    return (JFed.make(j_dataset(n=400, d=D_IN, seed=0), M),
            FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                         seed=0), M))


def track(jstep, step, k, metric_names):
    js, ts = start()
    jfed, tfed = feds()
    for t in range(ROUNDS):
        js, jm = jstep(js, jfed.round_batches(t, K=k, batch=B))
        ts, tm = step(ts, tfed.round_batches(t, K=k, batch=B, device="cpu"))
        assert set(tm) == set(jm)
        for name in metric_names:
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-5), (t, name)
    assert ts.round == ROUNDS
    assert np.array_equal(np.asarray(js.rng).astype(np.int64),
                          ts.rng.numpy())
    for n, got in convert.params_to_numpy(ts.params).items():
        np.testing.assert_allclose(got, np.asarray(js.params[n]), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


@pytest.mark.parametrize("theta", [0.0, 0.9])
def test_fedavg_tracks_jax(theta):
    track(jax.jit(j_make_fedavg_step(j_loss, JFedAvgConfig(
              eta=0.05, theta=theta, local_steps=K), M)),
          make_fedavg_step(t_loss, FedAvgConfig(eta=0.05, theta=theta,
                                                local_steps=K), M,
                           device="cpu"),
          K, ("loss", "consensus_dist", "local_drift"))


@pytest.mark.parametrize("self_weight", [1 / 3, 0.5])
def test_dsgd_tracks_jax(self_weight):
    track(jax.jit(j_make_dsgd_step(j_loss, JDSGDConfig(gamma=0.1),
                                   JMixingSpec.ring(M, self_weight))),
          make_dsgd_step(t_loss, DSGDConfig(gamma=0.1),
                         MixingSpec.ring(M, self_weight), device="cpu"),
          1, ("loss", "consensus_dist"))


def quad_loss(p, batch, rng):
    return 0.5 * ((p["w"] - batch["c"]) ** 2).sum(dim=-1)


@pytest.mark.parametrize("theta", [0.0, 0.3])
def test_fedavg_equals_dfedavgm_on_complete_graph(theta):
    """W = 11^T/m makes eq. 5 identical to server averaging (the
    reference's ``test_fedavg_equals_dfedavgm_on_complete_graph``)."""
    cs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 10)).astype(np.float32))
    batches = {"c": cs[:, None].expand(8, 4, 10).contiguous()}
    d_step = make_round_step(quad_loss, DFedAvgMConfig(
        eta=0.07, theta=theta, local_steps=4), MixingSpec.complete(8),
        device="cpu")
    f_step = make_fedavg_step(quad_loss, FedAvgConfig(
        eta=0.07, theta=theta, local_steps=4), 8, device="cpu")
    s1 = init_round_state({"w": torch.zeros((8, 10))}, prng.PRNGKey(5))
    s2 = init_round_state({"w": torch.zeros((8, 10))}, prng.PRNGKey(5))
    for _ in range(12):
        s1, _ = d_step(s1, batches)
        s2, _ = f_step(s2, batches)
    np.testing.assert_allclose(s1.params["w"].numpy(),
                               s2.params["w"].numpy(), atol=1e-5)
    # FedAvg holds exact consensus; the fixed point is the mean of c.
    assert float((s2.params["w"] - s2.params["w"][:1]).abs().max()) == 0.0


def test_dsgd_matches_eq2_by_hand():
    """One DSGD round == W x - gamma grad (deterministic gradients)."""
    rng = np.random.default_rng(3)
    cs = rng.normal(size=(8, 10)).astype(np.float32)
    x0 = rng.normal(size=(8, 10)).astype(np.float32)
    spec = MixingSpec.ring(8)
    step = make_dsgd_step(quad_loss, DSGDConfig(gamma=0.1), spec,
                          device="cpu")
    st, met = step(init_round_state({"w": torch.from_numpy(x0)},
                                    prng.PRNGKey(0)),
                   {"c": torch.from_numpy(cs)[:, None]})
    expected = spec.W.astype(np.float32) @ x0 - 0.1 * (x0 - cs)
    np.testing.assert_allclose(st.params["w"].numpy(), expected, atol=1e-5)
    assert set(met) == {"loss", "consensus_dist"}


@pytest.mark.parametrize("m", [2, 5, 16])
def test_complete_graph_and_w_equal_the_reference(m):
    spec, jspec = MixingSpec.complete(m), JMixingSpec.complete(m)
    assert np.array_equal(spec.W, jspec.W) and spec.kind == jspec.kind
    assert np.array_equal(complete_graph(m).adj, j_complete_graph(m).adj)
    assert spec.graph.name == jspec.graph.name
    assert spec.graph.num_directed_edges() == m * (m - 1)


@pytest.mark.parametrize("quant", [None, QuantConfig(bits=8)],
                         ids=["fp32", "q8"])
@pytest.mark.parametrize("fuse_round", [False, True],
                         ids=["unfused", "fused"])
def test_dense_mixing_builds_w_once(monkeypatch, quant, fuse_round):
    """The dense mixer, the fused round's dense tail and DSGD convert W
    once, when built: two rounds convert nothing from numpy."""
    spec = MixingSpec.ring(M, 0.5)
    steps = [make_round_step(quad_loss, DFedAvgMConfig(
        eta=0.05, local_steps=2, quant=quant, mixer_impl="dense",
        fuse_round=fuse_round), spec, device="cpu"),
        make_dsgd_step(quad_loss, DSGDConfig(gamma=0.1), spec,
                       device="cpu")]
    calls = []
    real = torch.as_tensor

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", counting)
    assert mixing.torch.as_tensor is counting
    batches = {"c": torch.ones((M, 2, 10))}
    for step in steps:
        st = init_round_state({"w": torch.zeros((M, 10))}, prng.PRNGKey(0))
        for _ in range(2):
            st, _ = step(st, batches)
        assert torch.isfinite(st.params["w"]).all()
    assert not calls
    # ... and a numpy W given to mix_dense itself is still converted.
    mixing.mix_dense(spec.W, {"w": torch.ones((M, 3))})
    assert calls
