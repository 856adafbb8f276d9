"""Port parity: ``repro_torch.core.mixing.make_mixer`` (the plan
realization, ``ring``, and the ``dense`` oracle) against the JAX package's
``execute_plan_reference`` — the spec of its sparse executor — and its
dense quantized recursion, fed the same x, z and key.

Contracts: packed words and per-leaf scales bitwise; x' within a few ulp
of the parameter magnitude (XLA may contract the Lemma-5 base and the
decode's multiply-adds into FMAs, and the dense oracles reduce over the
client axis in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import execute_plan_reference  # noqa: E402
from repro.core.mixing import _mix_dense_quantized, _quant_leaf_keys, mix_dense  # noqa: E402,E501
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import (MixerConfig, MixingSpec, QuantConfig,  # noqa: E402,E501
                              WireLayout, consensus_distance, make_mixer)
from repro_torch.core.mixing import _quant_leaf_keys as t_leaf_keys  # noqa: E402,E501

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M = 4
SHAPES = {"w1": (32, 16), "b1": (16,), "w2": (16, 10), "b2": (10,)}
QUANTS = {
    "fp32": None,
    "q8-lemma5-stoch": dict(bits=8),
    "q8-eq7-det": dict(bits=8, stochastic=False, delta_mode="eq7"),
    "q4-lemma5-stoch": dict(bits=4),
}
ATOL = 8 * float(np.spacing(np.float32(0.5)))   # a few ulp at |x| <= 0.5


def inputs(seed):
    rng = np.random.default_rng(seed)
    x = {n: (0.1 * rng.normal(size=(M,) + s)).astype(np.float32)
         for n, s in SHAPES.items()}
    z = {n: a + (1e-2 * rng.normal(size=a.shape)).astype(np.float32)
         for n, a in x.items()}
    return x, z


def to_jax(tree):
    return {n: jnp.asarray(a) for n, a in tree.items()}


def to_torch(tree):
    return convert.params_from_numpy(tree, device="cpu")


def assert_close(got, want, atol=ATOL):
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=0, atol=atol, err_msg=n)


@pytest.mark.parametrize("qname", list(QUANTS))
def test_ring_plan_vs_jax_plan_reference(qname):
    x, z = inputs(1)
    q = QUANTS[qname]
    spec = MixingSpec.ring(M, self_weight=0.5)
    jspec = JMixingSpec.ring(M, self_weight=0.5)
    mixer = make_mixer(spec, MixerConfig(
        impl="ring", quant=None if q is None else QuantConfig(**q)),
        device="cpu")
    got = mixer(to_torch(x), to_torch(z), prng.PRNGKey(2))
    want = execute_plan_reference(
        jspec.gossip_plan(), jspec.W, to_jax(z), to_jax(x),
        quant=None if q is None else JQuantConfig(**q),
        key=jax.random.PRNGKey(2))
    assert_close(got, want)
    for n in SHAPES:
        assert got[n].shape == (M,) + SHAPES[n]


@pytest.mark.parametrize("qname", list(QUANTS))
def test_dense_vs_jax_dense(qname):
    x, z = inputs(2)
    q = QUANTS[qname]
    spec = MixingSpec.ring(M, self_weight=0.5)
    jspec = JMixingSpec.ring(M, self_weight=0.5)
    mixer = make_mixer(spec, MixerConfig(
        impl="dense", quant=None if q is None else QuantConfig(**q)),
        device="cpu")
    got = mixer(to_torch(x), to_torch(z), prng.PRNGKey(3))
    if q is None:
        want = mix_dense(jspec.W, to_jax(z))
    else:
        want = _mix_dense_quantized(jspec.W, to_jax(x), to_jax(z),
                                    JQuantConfig(**q), jax.random.PRNGKey(3))
    assert_close(got, want)


@pytest.mark.parametrize("qname", ["q8-lemma5-stoch", "q4-lemma5-stoch"])
def test_ring_plan_vs_port_dense(qname):
    """The two port mixers agree: same wire draws, another order."""
    x, z = inputs(3)
    spec = MixingSpec.ring(M, self_weight=0.5)
    q = QuantConfig(**QUANTS[qname])
    ring = make_mixer(spec, MixerConfig(impl="ring", quant=q), device="cpu")
    dense = make_mixer(spec, MixerConfig(impl="dense", quant=q),
                       device="cpu")
    key = prng.PRNGKey(4)
    a = ring(to_torch(x), to_torch(z), key)
    b = dense(to_torch(x), to_torch(z), key)
    for n in SHAPES:
        torch.testing.assert_close(a[n], b[n], rtol=0, atol=ATOL)


@pytest.mark.parametrize("qname", ["q8-lemma5-stoch", "q8-eq7-det",
                                   "q4-lemma5-stoch"])
def test_mixer_wire_words_and_scales_bitwise(qname):
    """The words and scales the ring mixer puts on the wire for (x, z,
    key) equal the JAX package's for the same inputs."""
    x, z = inputs(4)
    q, jq = QuantConfig(**QUANTS[qname]), JQuantConfig(**QUANTS[qname])
    tx, tz = to_torch(x), to_torch(z)
    lay = WireLayout.for_tree(tx, q.bits, stacked=True)
    delta = lay.to_planar_stacked({n: tz[n] - tx[n] for n in tx})
    scales = lay.leaf_scales(delta, q)
    tkeys = (t_leaf_keys(prng.PRNGKey(5), lay.n_leaves, M)
             if q.stochastic else None)
    words = lay.encode(delta, scales, q, keys=tkeys)

    jx, jz = to_jax(x), to_jax(z)
    ref = JWireLayout.for_tree(jax.tree.map(lambda a: a[0], jx),
                               bits=jq.bits)
    jdelta = ref.to_planar_stacked(jax.tree.map(lambda a, b: a - b, jz, jx))
    jscales = ref.leaf_scales(jdelta, jq)
    keys = (_quant_leaf_keys(jax.random.PRNGKey(5), ref.n_leaves, M)
            if jq.stochastic else None)
    jwords = ref.encode(jdelta, jscales, jq, leaf_keys=keys)
    assert np.array_equal(np.asarray(jscales).view(np.int32),
                          scales.numpy().view(np.int32))
    assert np.array_equal(np.asarray(jwords).view(np.int32), words.numpy())


def test_auto_resolves_like_a_one_device_mesh():
    ring = MixingSpec.ring(M, self_weight=0.5)
    assert MixerConfig().resolved_impl(ring) == "ring"
    from repro_torch.core import Graph
    full = MixingSpec.dense(Graph(~np.eye(M, dtype=bool)))
    assert MixerConfig().resolved_impl(full) == "dense"
    chain = np.zeros((M, M), bool)
    for i in range(M - 1):
        chain[i, i + 1] = chain[i + 1, i] = True
    assert MixerConfig().resolved_impl(MixingSpec.dense(Graph(chain))) \
        == "sparse"


def test_sparse_plan_on_a_chain_matches_dense():
    from repro_torch.core import Graph
    chain = np.zeros((M, M), bool)
    for i in range(M - 1):
        chain[i, i + 1] = chain[i + 1, i] = True
    spec = MixingSpec.dense(Graph(chain))
    x, z = inputs(5)
    q = QuantConfig(bits=8)
    a = make_mixer(spec, MixerConfig(impl="sparse", quant=q),
                   device="cpu")(to_torch(x), to_torch(z), prng.PRNGKey(6))
    b = make_mixer(spec, MixerConfig(impl="dense", quant=q),
                   device="cpu")(to_torch(x), to_torch(z), prng.PRNGKey(6))
    for n in SHAPES:
        torch.testing.assert_close(a[n], b[n], rtol=0, atol=ATOL)


def test_consensus_distance_vs_jax():
    from repro.core import consensus_distance as j_consensus
    x, _ = inputs(6)
    got = float(consensus_distance(to_torch(x)))
    want = float(j_consensus(to_jax(x)))
    assert got == pytest.approx(want, rel=1e-6)


def test_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mixer(MixingSpec.ring(M), MixerConfig(quant=QuantConfig()))
