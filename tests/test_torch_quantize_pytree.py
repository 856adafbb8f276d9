"""The port's sequential bit packing and per-leaf pytree quantizer
(``repro_torch.core.quantize``: ``quantize``, ``packed_len``,
``pack_bits``, ``unpack_bits``, ``quantize_pytree``,
``dequantize_pytree``) and ``kernels.ref.unpack_dequant_ref`` against the
JAX package's on the CPU.

Contract: bitwise everywhere. Words are the reference's u32 bit patterns
(the port carries them as int32), codes and scales equal, dequantized
values equal (one f32 product of equal operands), and the stochastic
draws the same: ``quantize_pytree`` splits its key into one a leaf in
``jax.tree.flatten`` order, as the reference does.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as JR  # noqa: E402
from repro.models.paper_nets import init_2nn as j_init_2nn  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

# The modules, not the ``quantize`` functions both packages' ``core``
# export under the same name.
JQ = importlib.import_module("repro.core.quantize")
TQ = importlib.import_module("repro_torch.core.quantize")

torch.set_num_threads(1)

LENGTHS = (1, 37, 101, 1000)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.int32).view(np.uint32)


def test_core_exports_the_reference_names():
    for name in ("quantize", "pack_bits", "unpack_bits", "quantize_pytree",
                 "dequantize_pytree"):
        assert hasattr(tcore, name), name
    assert not hasattr(tcore, "packed_len")


@pytest.mark.parametrize("bits", [2, 4, 8, 16, 32])
def test_pack_unpack_bitwise(bits):
    rng = np.random.default_rng(bits)
    for n in LENGTHS:
        if bits == 32:
            k = rng.integers(-2 ** 31, 2 ** 31, n, dtype=np.int64)
        else:
            k = rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1), n)
        k = k.astype(np.int32)
        want = np.asarray(JQ.pack_bits(jnp.asarray(k), bits))
        got = TQ.pack_bits(torch.from_numpy(k), bits)
        assert got.dtype == torch.int32
        assert got.shape[0] == TQ.packed_len(n, bits) == JQ.packed_len(
            n, bits) or bits == 32
        assert np.array_equal(u32(got), want), (bits, n)
        back = TQ.unpack_bits(got, bits, n)
        assert np.array_equal(back.numpy(), np.asarray(
            JQ.unpack_bits(jnp.asarray(want), bits, n))), (bits, n)
        assert np.array_equal(back.numpy(), k), (bits, n)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 1000])
def test_packed_len(n):
    for bits in (2, 4, 8, 16, 32):
        assert TQ.packed_len(n, bits) == JQ.packed_len(n, bits)


@pytest.mark.parametrize("cfg", [dict(bits=8), dict(bits=4),
                                 dict(bits=8, stochastic=False),
                                 dict(bits=2, scale_mode="fixed", s=0.01),
                                 dict(bits=32)],
                         ids=["b8", "b4", "b8-det", "b2-fixed", "b32"])
@pytest.mark.parametrize("shape", [(1000,), (12, 34)])
def test_quantize_bitwise(cfg, shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(JQ.quantize(jnp.asarray(x), JQ.QuantConfig(**cfg),
                                  key))
    got = TQ.quantize(torch.from_numpy(x), TQ.QuantConfig(**cfg),
                      prng.PRNGKey(4))
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pack", [True, False])
def test_quantize_pytree_on_the_2nn_bitwise(bits, pack):
    p = j_init_2nn(jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    delta = {n: (np.asarray(v) + 0.01 * rng.normal(size=v.shape))
             .astype(np.float32) for n, v in p.items()}
    jcfg, tcfg = JQ.QuantConfig(bits=bits), TQ.QuantConfig(bits=bits)
    jw, js = JQ.quantize_pytree({n: jnp.asarray(v) for n, v in
                                 delta.items()}, jcfg,
                                jax.random.PRNGKey(9), pack=pack)
    tdelta = convert.params_from_numpy(delta, device="cpu")
    tw, ts = TQ.quantize_pytree(tdelta, tcfg, prng.PRNGKey(9), pack=pack)
    assert sorted(tw) == sorted(jw)
    for n in jw:
        want = np.asarray(jw[n])
        got = u32(tw[n]) if pack else tw[n].numpy()
        assert np.array_equal(got, want), n
        assert np.array_equal(ts[n].numpy(), np.asarray(js[n])), n
    want = JQ.dequantize_pytree(jw, js, {n: jnp.asarray(v) for n, v in
                                         delta.items()}, jcfg, packed=pack)
    got = TQ.dequantize_pytree(tw, ts, tdelta, tcfg, packed=pack)
    for n in want:
        assert np.array_equal(got[n].numpy(), np.asarray(want[n])), n


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_unpack_dequant_ref_bitwise(bits):
    rng = np.random.default_rng(bits)
    n = 3000
    x = rng.normal(size=n).astype(np.float32)
    noise = rng.random(TR.planar_pad_len(n, bits)[0]
                       * TR.planar_pad_len(n, bits)[1]).astype(np.float32)
    s = np.float32(np.abs(x).max() / (2 ** (bits - 1) - 1))
    words = JR.quantize_pack_ref(jnp.asarray(x), bits, jnp.float32(s),
                                 jnp.asarray(noise[:n]))
    want = np.asarray(JR.unpack_dequant_ref(words, bits, jnp.float32(s), n))
    got = TR.unpack_dequant_ref(
        torch.from_numpy(np.asarray(words).view(np.int32).copy()), bits,
        torch.tensor(s), n)
    assert got.shape == (n,) and np.array_equal(got.numpy(), want)
