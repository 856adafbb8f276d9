"""The port's by-value leaf tables: keyed B1, which draws the
stochastic-rounding noise inside the encode kernel from the per-leaf keys
and the layout's ``NoiseTable``, and B3, one launch over every leaf of a
parameter dict.

Contracts: keyed words bitwise equal to the JAX package's
``WireLayout.noise_stacked`` + ``quantize_pack_buffer_pallas`` (interpret
mode) for the same key; the keyed noise of the plain version bitwise equal
to ``noise_stacked``; B3's outputs start on 16-byte boundaries, and the
dict step equals the per-leaf plain step bitwise (the leaf table that B3's
C entry builds is tested in ``test_torch_csrc_host.py``). On CPU tensors
the wrappers run their plain versions, built from the same tables the
kernels are given.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.mixing import _quant_leaf_keys  # noqa: E402
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro.kernels.quantize_pack import quantize_pack_buffer_pallas  # noqa: E402,E501
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import (MixerConfig, MixingSpec, QuantConfig,  # noqa: E402,E501
                              WireLayout, make_mixer)
from repro_torch.core.mixing import _quant_leaf_keys as t_leaf_keys  # noqa: E402,E501
from repro_torch.kernels import (launch_counts, momentum_update,  # noqa: E402
                                 native, quantize_pack_buffer, ref)
from repro_torch.kernels.momentum_sgd import (ALIGN,  # noqa: E402
                                              momentum_sgd_leaves,
                                              out_offsets)

torch.set_num_threads(1)

M = 3
# Ragged leaves, one of them a single value ("bias").
RAGGED = {"a": (33,), "kernel": (4, 9), "bias": (), "z": (3, 7, 5),
          "big": (2100,)}


def stacked(shapes, m, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return {n: (scale * rng.normal(size=(m,) + s)).astype(np.float32)
            for n, s in shapes.items()}


# -- keyed B1 -----------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_keyed_encode_bitwise_vs_jax_noise_stacked_and_pallas(bits):
    tree = stacked(RAGGED, M, seed=40 + bits)
    tt = convert.params_from_numpy(tree, device="cpu")
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    delta = lay.to_planar_stacked(tt)
    sblk = lay.block_scales(lay.leaf_scales(delta, QuantConfig(bits=bits)))
    keys = t_leaf_keys(prng.PRNGKey(9), lay.n_leaves, M)
    before = launch_counts()
    got = quantize_pack_buffer(delta, sblk, bits, keys=keys,
                               table=lay.noise_table)
    assert launch_counts() == before
    assert got.shape == (M, lay.total_words)

    jlay = JWireLayout.for_tree(
        {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in RAGGED.items()},
        bits=bits)
    jnoise = jlay.noise_stacked(
        _quant_leaf_keys(jax.random.PRNGKey(9), jlay.n_leaves, M))
    jdelta = jnp.asarray(delta.numpy())
    for c in range(M):
        want = quantize_pack_buffer_pallas(
            jdelta[c], jnp.asarray(sblk[c].numpy())[None], jnoise[c],
            bits=bits, stochastic=True, interpret=True)
        assert np.array_equal(np.asarray(want).view(np.int32),
                              got[c].numpy()), c


@pytest.mark.parametrize("bits", [2, 8, 16])
def test_keyed_noise_ref_is_noise_stacked(bits):
    """The plain version of the kernel's index arithmetic (leaf by search
    over the table's word offsets, index i * leaf_words + column offset,
    zero past the leaf's size) draws ``noise_stacked``'s noise bitwise."""
    tt = convert.params_from_numpy(stacked(RAGGED, M, seed=bits),
                                   device="cpu")
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    keys = t_leaf_keys(prng.PRNGKey(11), lay.n_leaves, M)
    got = ref.keyed_noise_ref(keys, lay.noise_table, lay.per,
                              lay.total_words)
    want = lay.noise_stacked(keys)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # padding draws zero: leaf "a" (33 values) ends inside its first row
    a = lay.names.index("a")
    off, lw = lay.word_offsets[a], lay.leaf_words[a]
    assert (got[:, 0, off + 33:off + lw] == 0).all()
    assert (got[:, 1:, off:off + lw] == 0).all()


@pytest.mark.parametrize("bits", [4, 8])
def test_layout_encode_keys_equals_noise(bits):
    tt = convert.params_from_numpy(stacked(RAGGED, M, seed=7), device="cpu")
    q = QuantConfig(bits=bits)
    lay = WireLayout.for_tree(tt, bits, stacked=True)
    delta = lay.to_planar_stacked(tt)
    scales = lay.leaf_scales(delta, q)
    keys = t_leaf_keys(prng.PRNGKey(2), lay.n_leaves, M)
    keyed = lay.encode(delta, scales, q, keys=keys)
    tensor = quantize_pack_buffer(delta, lay.block_scales(scales), bits,
                                  lay.noise_stacked(keys))
    assert torch.equal(keyed, tensor)
    with pytest.raises(ValueError):
        lay.encode(delta, scales, q)
    with pytest.raises(ValueError):
        quantize_pack_buffer(delta, lay.block_scales(scales), bits,
                             lay.noise_stacked(keys), keys=keys,
                             table=lay.noise_table)


def test_plan_mixer_never_materializes_the_noise(monkeypatch):
    """The unfused round's mixer hands B1 the keys: ``noise_stacked`` is
    not called on its path."""
    def refuse(self, keys):
        raise AssertionError("noise_stacked called on the plan mixer path")

    tree = stacked({"w": (8, 5), "b": (5,)}, 4, seed=3, scale=0.1)
    x = convert.params_from_numpy(tree, device="cpu")
    z = {n: t + 0.01 for n, t in x.items()}
    spec = MixingSpec.ring(4, self_weight=0.5)
    mixer = make_mixer(spec, MixerConfig(impl="ring",
                                         quant=QuantConfig(bits=8)),
                       device="cpu")
    want = mixer(x, z, prng.PRNGKey(1))
    monkeypatch.setattr(WireLayout, "noise_stacked", refuse)
    got = make_mixer(spec, MixerConfig(impl="ring",
                                       quant=QuantConfig(bits=8)),
                     device="cpu")(x, z, prng.PRNGKey(1))
    for n in x:
        assert torch.equal(got[n], want[n])


# -- B3 leaf table ------------------------------------------------------------

@pytest.mark.parametrize("sizes", [(0, 1, 3, 4097), (4, 8, 5), (7,)])
def test_out_offsets_round_to_16_bytes(sizes):
    offs, total, host_sizes = out_offsets(sizes)
    assert host_sizes.dtype == np.int64 and host_sizes.tolist() == list(sizes)
    assert all(o % ALIGN == 0 for o in offs) and total % ALIGN == 0
    ends = [o + n for o, n in zip(offs, sizes)]
    assert all(e <= o for e, o in zip(ends, offs[1:] + [total]))
    assert total - ends[-1] < ALIGN


def test_momentum_update_over_a_dict_equals_per_leaf_plain():
    rng = np.random.default_rng(12)
    shapes = {"w1": (4, 7), "b1": (7,), "s": (), "w2": (7, 3)}
    y, v, g = ({n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for n, s in shapes.items()} for _ in range(3))
    before = launch_counts()
    ys, vs = momentum_update(y, v, g, 0.05, 0.9)
    assert launch_counts() == before
    assert list(ys) == list(y) and list(vs) == list(y)
    for n in shapes:
        wy, wv = ref.momentum_sgd_ref(y[n], v[n], g[n], 0.05, 0.9)
        assert ys[n].shape == shapes[n]
        assert torch.equal(ys[n], wy) and torch.equal(vs[n], wv)
    assert momentum_sgd_leaves([], [], [], 0.05, 0.9) == ([], [])


# -- the build cache ----------------------------------------------------------

def test_lib_path_hashes_the_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n'
                                   '#include "common.cuh"\nint f();\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    first = native.lib_path("k")
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert native.lib_path("k") == first      # not included: same library
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert native.lib_path("k") != first


def test_the_port_sources_name_existing_headers():
    for cu in sorted(native.CSRC_DIR.glob("*.cu")):
        native.lib_path(cu.stem)              # raises if a header is gone
    assert "threefry.cuh" in (native.CSRC_DIR
                              / "quantize_pack.cu").read_text()
