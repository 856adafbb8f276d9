"""Shared set-up of the scheduled-round parity tests
(``test_torch_schedule.py``, ``test_torch_schedule_fused.py``): the same
2NN parameters, numpy batches and keys through the JAX package's round on
a one-device client mesh (``mixer_impl="sparse"``, ``wire="planar"``, the
Pallas kernels in interpret mode) and through the port's round on the
CPU, for a schedule built the same way in both packages."""
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

M, K, B, ROUNDS = 8, 2, 8, 3
D_IN, HID = 32, 16
PARAM_ULP_ATOL = 1e-6        # a few ulp at |x| ~ 0.5
FLIP_ATOL = 1e-4             # one 8-bit quantizer step x weight
FLIP_SHARE = 1e-3
METRICS = ("loss", "consensus_dist", "local_drift", "active_frac")


def j_loss(p, b, rng):
    return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def schedule(L, kind: str):
    """The schedule ``kind`` in the port (``L = T``) or the reference."""
    ring = L.ring_graph(M)
    er = L.erdos_renyi_graph(M, 0.5, seed=1)
    return {
        "constant": lambda: L.TopologySchedule.constant(
            L.MixingSpec.ring(M, 0.5)),
        "edge_sample": lambda: L.TopologySchedule.edge_sample(er, 0.5),
        "partial": lambda: L.TopologySchedule.partial(ring, 0.6),
        "partial_exact": lambda: L.TopologySchedule.partial(ring, 0.5,
                                                            exact=True),
        "partial_cap": lambda: L.TopologySchedule.partial(ring, 0.5,
                                                          cap_slack=1),
        "walk": lambda: L.TopologySchedule.random_walk(ring, horizon=64,
                                                       seed=0),
        "walk_stateful": lambda: L.TopologySchedule.random_walk(
            ring, stateful=True),
        "cycle": lambda: L.TopologySchedule.cycle(
            [L.MixingSpec.ring(M, 0.5), L.MixingSpec.torus(2, M // 2)]),
    }[kind]()


def run_both(kind: str, fuse_round: bool, quant=dict(bits=8),
             skip="auto"):
    """ROUNDS rounds of both packages from one state. Returns the JAX
    and the port final states and their metrics by round."""
    data = j_dataset(n=400, d=D_IN, seed=0)
    params = jnets.init_2nn(jax.random.PRNGKey(0), d_in=D_IN, d_hidden=HID)
    np_params = jax.tree.map(np.asarray, params)
    fed = JFed.make(data, M)
    tfed = FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                        seed=0), M)
    js, s = schedule(J, kind), schedule(T, kind)
    jcfg = J.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                            quant=None if quant is None
                            else J.QuantConfig(**quant),
                            mixer_impl="sparse", wire="planar",
                            fuse_round=fuse_round)
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jstep = jax.jit(J.make_round_step(j_loss, jcfg, js, mesh=mesh,
                                      client_axes=("clients",)))
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), params)
    jst = J.init_round_state(stacked, jax.random.PRNGKey(1),
                             token=js.init_token() if js.is_stateful
                             else None)
    cfg = T.DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                           quant=None if quant is None
                           else T.QuantConfig(**quant),
                           fuse_round=fuse_round)
    step = T.make_round_step(t_loss, cfg, s, device="cpu",
                             skip_inactive_compute=skip)
    tst = T.init_round_state(
        convert.params_from_numpy(np_params, stack=M, device="cpu"),
        prng.PRNGKey(1), token=s.init_token() if s.is_stateful else None)
    jm, tm = [], []
    for t in range(ROUNDS):
        jst, a = jstep(jst, fed.round_batches(t, K=K, batch=B))
        tst, b = step(tst, tfed.round_batches(t, K=K, batch=B,
                                              device="cpu"))
        jm.append({k: float(v) for k, v in a.items()})
        tm.append({k: float(v) for k, v in b.items()})
    return jst, tst, jm, tm


def assert_rounds_track(jst, tst, jm, tm):
    """Metrics within rtol 1e-5; keys and tokens bitwise; parameters
    within a few ulp but for stochastic-rounding flips (at most one
    quantizer step, on under 0.1 % of the elements)."""
    for t, (a, b) in enumerate(zip(jm, tm)):
        assert set(a) == set(b), (set(a), set(b))
        for name in METRICS:
            if name in a:
                assert b[name] == pytest.approx(a[name], rel=1e-5,
                                                abs=1e-12), (t, name)
    assert np.array_equal(np.asarray(jst.rng).astype(np.int64),
                          tst.rng.numpy())
    if jst.token is not None:
        assert int(tst.token) == int(jst.token)
    total = flipped = 0
    for n, got in convert.params_to_numpy(tst.params).items():
        err = np.abs(got - np.asarray(jst.params[n]))
        assert err.max() <= FLIP_ATOL, n
        flipped += int((err > PARAM_ULP_ATOL).sum())
        total += err.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)
