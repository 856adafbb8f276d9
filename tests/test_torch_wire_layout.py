"""Port parity: ``repro_torch.core.wire_layout.WireLayout`` against the
JAX package's ``WireLayout`` — geometry, planar round trips, per-leaf
scales, stochastic-rounding noise and encoded words, all bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.mixing import _quant_leaf_keys  # noqa: E402
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import QuantConfig, WireLayout  # noqa: E402
from repro_torch.core.mixing import _quant_leaf_keys as t_leaf_keys  # noqa: E402,E501
from repro_torch.kernels.ref import LANE_BLOCK  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TWO_NN = {"w1": (784, 200), "b1": (200,), "w2": (200, 200), "b2": (200,),
          "w3": (200, 10), "b3": (10,)}
RAGGED = {"a": (33,), "kernel": (4, 9), "bias": (), "z": (3, 7, 5),
          "big": (2100,)}


def jax_tree(shapes):
    return {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in shapes.items()}


def torch_tree(shapes):
    return {n: torch.empty(s) for n, s in shapes.items()}


def stacked_pair(shapes, m, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    tree = {n: (scale * rng.normal(size=(m,) + s)).astype(np.float32)
            for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in tree.items()},
            convert.params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("shapes", [TWO_NN, RAGGED], ids=["2nn", "ragged"])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_geometry_matches_jax(shapes, bits):
    ref = JWireLayout.for_tree(jax_tree(shapes), bits=bits)
    got = WireLayout.for_tree(torch_tree(shapes), bits)
    assert got.names == tuple(sorted(shapes))
    assert got.sizes == ref.sizes and got.per == ref.per
    assert got.leaf_words == ref.leaf_words
    assert got.word_offsets == ref.word_offsets
    assert got.total_words == ref.total_words
    assert np.array_equal(got.block_leaf, ref.block_leaf)


def test_2nn_layout_at_full_width():
    """8 bits: per = 4, W = 51 712 words = 101 lane blocks; leaves in
    jax.tree.flatten order b1, b2, b3, w1, w2, w3."""
    lay = WireLayout.for_tree(torch_tree(TWO_NN), 8)
    assert lay.names == ("b1", "b2", "b3", "w1", "w2", "w3")
    assert lay.per == 4 and lay.total_words == 51712 and lay.n_blocks == 101
    blocks = dict(zip(lay.names, np.bincount(lay.block_leaf)))
    assert blocks == {"b1": 1, "b2": 1, "b3": 1, "w1": 77, "w2": 20, "w3": 1}
    assert sum(lay.sizes) == 199210


@pytest.mark.parametrize("bits", [4, 8])
def test_planar_roundtrip_and_jax_buffer(bits):
    jt, tt = stacked_pair(RAGGED, 3, seed=bits)
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    buf = lay.to_planar_stacked(tt)
    assert buf.shape == (3, 32 // bits, lay.total_words)
    ref = JWireLayout.for_tree(jax.tree.map(lambda a: a[0], jt), bits=bits)
    assert np.array_equal(np.asarray(ref.to_planar_stacked(jt)), buf.numpy())
    back = lay.from_planar_stacked(buf)
    for n in RAGGED:
        assert torch.equal(back[n], tt[n])
    one = lay.from_planar(lay.to_planar({n: t[1] for n, t in tt.items()}))
    for n in RAGGED:
        assert torch.equal(one[n], tt[n][1])


@pytest.mark.parametrize("scale_mode", ["per_tensor", "fixed"])
@pytest.mark.parametrize("bits", [4, 8, 16])
def test_leaf_scales_bitwise(bits, scale_mode):
    jt, tt = stacked_pair(RAGGED, 3, seed=20 + bits, scale=1e-2)
    tt["a"][1].zero_()      # an all-zero leaf takes the s = 1.0 guard
    jt["a"] = jt["a"].at[1].set(0.0)
    q = QuantConfig(bits=bits, scale_mode=scale_mode)
    jq = JQuantConfig(bits=bits, scale_mode=scale_mode)
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    ref = JWireLayout.for_tree(jax.tree.map(lambda a: a[0], jt), bits=bits)
    got = lay.leaf_scales(lay.to_planar_stacked(tt), q)
    want = ref.leaf_scales(ref.to_planar_stacked(jt), jq)
    assert np.array_equal(np.asarray(want).view(np.int32),
                          got.numpy().view(np.int32))
    assert np.array_equal(np.asarray(ref.block_scales(want)),
                          lay.block_scales(got).numpy())


@pytest.mark.parametrize("bits", [4])
def test_noise_bitwise(bits):
    m = 3
    _, tt = stacked_pair(RAGGED, m, seed=1)
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    ref = JWireLayout.for_tree(jax_tree(RAGGED), bits=bits)
    keys = _quant_leaf_keys(jax.random.PRNGKey(4), ref.n_leaves, m)
    tkeys = t_leaf_keys(prng.PRNGKey(4), lay.n_leaves, m)
    got = lay.noise_stacked(tkeys)
    want = np.asarray(ref.noise_stacked(keys))
    assert np.array_equal(want.view(np.int32), got.numpy().view(np.int32))
    assert np.array_equal(np.asarray(ref.noise(keys[:, 2])),
                          lay.noise(tkeys[:, 2]).numpy())


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_encode_bitwise_vs_jax_seq_and_pallas(bits, stochastic):
    """Words of the port's encode equal the JAX package's for both of its
    codec backends (XLA lowering and Pallas in interpret mode)."""
    m = 2
    jt, tt = stacked_pair(RAGGED, m, seed=30 + bits, scale=1e-2)
    q = QuantConfig(bits=bits, stochastic=stochastic)
    jq = JQuantConfig(bits=bits, stochastic=stochastic)
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    ref = JWireLayout.for_tree(jax.tree.map(lambda a: a[0], jt), bits=bits)
    jdelta = ref.to_planar_stacked(jt)
    jscales = ref.leaf_scales(jdelta, jq)
    keys = _quant_leaf_keys(jax.random.PRNGKey(6), ref.n_leaves, m)
    delta = lay.to_planar_stacked(tt)
    scales = lay.leaf_scales(delta, q)
    tkeys = (t_leaf_keys(prng.PRNGKey(6), lay.n_leaves, m)
             if stochastic else None)
    got = lay.encode(delta, scales, q, keys=tkeys).numpy()
    assert got.shape == (m, lay.total_words)
    want_seq = np.asarray(ref.encode(jdelta, jscales, jq, leaf_keys=keys))
    want_pallas = np.asarray(ref.encode(jdelta, jscales, jq, leaf_keys=keys,
                                        pallas=True))
    assert np.array_equal(want_seq.view(np.int32), got)
    assert np.array_equal(want_pallas.view(np.int32), got)
    # padding encodes to the zero level's field: never rounds up
    off = 1 << (bits - 1)
    pad_word = sum(off << (bits * i) for i in range(32 // bits))
    end = lay.word_offsets[0] + lay.leaf_words[0]
    assert lay.sizes[0] < lay.leaf_words[0]   # leaf "a": row 0 ends early
    pad = got[:, lay.sizes[0]:end]
    assert (pad == np.int64(pad_word).astype(np.int32)).all()
    assert end % LANE_BLOCK == 0
