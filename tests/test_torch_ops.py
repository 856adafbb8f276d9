"""Port parity for the per-tensor kernel entry points (``kernels/ops.py``)
and their kernels B6 (``quantize_pack``), B7 (``dequant_mix_plan``) and
B8 (``dequant_mix``, the ring form): each against the JAX package's
``repro.kernels.ops`` entry point and Pallas kernel in interpret mode, on
one flat vector of n = 970 values (not a multiple of 512).

Contracts: words and scales bitwise. A decode of k streams onto a base
within k + 1 ulp of the operands' magnitude, the slack XLA's contraction
of each multiply-add into an FMA leaves (as ``test_torch_kernels.py``
states for B2); the heavy-ball update within 2 ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dequant_mix import (dequant_mix_pallas,  # noqa: E402
                                       dequant_mix_plan_pallas)
from repro.kernels.quantize_pack import quantize_pack_pallas  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.kernels import (decode_apply_plan, decode_apply_ring,  # noqa: E402,E501
                                 dequant_mix, dequant_mix_plan, encode_delta,
                                 launch_counts, make_fused_momentum_update,
                                 momentum_update_flat, quantize_pack, ref)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

N = 970
ETA, THETA = 0.05, 0.9


def within_ulp(got, want, scale, n_terms) -> bool:
    tol = n_terms * np.spacing(np.asarray(scale, np.float32))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return bool((err <= tol).all())


def deq_scale(x, streams, scales, weights, bits):
    """Sum of |terms| of ``x + sum_k w_k * deq_k`` in f64, planar."""
    per = 32 // bits
    shifts = (np.arange(per, dtype=np.uint64) * bits)[:, None]
    total = np.abs(x.astype(np.float64))
    for k in range(streams.shape[0]):
        f = ((streams[k].astype(np.uint64)[None] >> shifts)
             & ((1 << bits) - 1)).astype(np.float64) - 2 ** (bits - 1)
        total = total + np.abs(np.float64(weights[k]) * f * scales[k])
    return total


def planar(x, bits):
    per, w = ref.planar_pad_len(x.shape[0], bits)
    return np.pad(x, (0, per * w - x.shape[0])).reshape(per, w)


def random_streams(rng, k, bits, n=N):
    _, w = ref.planar_pad_len(n, bits)
    return rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [8, 4, 2, 16])
def test_encode_delta_words_and_scale_bitwise(bits, stochastic):
    """Words and scale against the JAX package's encode_delta for the same
    key; and the words keyed B6 gives on the card, whose noise is the
    one-leaf table's (``keyed_noise_ref``), are the same words."""
    rng = np.random.default_rng(bits + stochastic)
    for trial, n in enumerate((N, 1, 3000)):
        delta = (rng.normal(size=n) * rng.uniform(1e-3, 3)).astype(
            np.float32)
        jw, js = jops.encode_delta(
            jnp.asarray(delta), bits, stochastic=stochastic,
            key=jax.random.PRNGKey(trial), interpret=True)
        before = launch_counts()
        tw, ts = encode_delta(torch.from_numpy(delta), bits,
                              stochastic=stochastic,
                              key=prng.PRNGKey(trial))
        assert launch_counts() == before
        assert tw.dtype == torch.int32 and tw.shape == jw.shape
        assert np.array_equal(np.asarray(jw).view(np.int32), tw.numpy())
        assert np.float32(js).tobytes() == ts.numpy().tobytes()
        if stochastic:
            x2d = torch.from_numpy(planar(delta, bits))
            noise = one_leaf_noise(prng.PRNGKey(trial), *x2d.shape)
            assert torch.equal(ref.quantize_pack_ref(x2d, ts, bits, noise),
                               tw)


def one_leaf_noise(key, per, w):
    """The noise keyed B6 draws: ``keyed_noise_ref`` over a one-leaf table
    (word offset 0, leaf words W, size per * W) and one client."""
    return ref.keyed_noise_ref(key.reshape(1, 1, 2),
                               ref.NoiseTable((0,), (w,), (per * w,)), per,
                               w)[0]


@pytest.mark.parametrize("n", [1, 511, N, 199210])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_one_leaf_keyed_table_is_uniform(bits, n):
    """Keyed B6's noise (position (i, w) draws element i * W + w of
    uniform(key)) is ``prng.uniform(key, (per, W))`` bit for bit, padding
    included, for a key with both words in use."""
    per, w = ref.planar_pad_len(n, bits)
    key = prng.split(prng.PRNGKey(n), 2)[1]
    assert int(key[0]) and int(key[1])
    got = one_leaf_noise(key, per, w)
    want = prng.uniform(key, (per, w))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_quantize_pack_key_or_noise():
    """B6 takes its noise as a tensor or as a key, not both; keyed on the
    CPU it is the plain encode fed ``prng.uniform(key, (per, W))``."""
    x = torch.from_numpy(planar(np.linspace(-1, 1, N, dtype=np.float32), 8))
    s = torch.tensor(1 / 127, dtype=torch.float32)
    key = prng.PRNGKey(5)
    noise = prng.uniform(key, x.shape)
    with pytest.raises(ValueError, match="key"):
        quantize_pack(x, s, 8, noise, key=key)
    assert torch.equal(quantize_pack(x, s, 8, key=key),
                       ref.quantize_pack_ref(x, s, 8, noise))


def test_encode_delta_zero_and_key_checks():
    words, s = encode_delta(torch.zeros(N), 8, stochastic=False)
    assert float(s) == 1.0
    jw, _ = jops.encode_delta(jnp.zeros(N), 8, stochastic=False,
                              interpret=True)
    assert np.array_equal(np.asarray(jw).view(np.int32), words.numpy())
    with pytest.raises(ValueError, match="key"):
        encode_delta(torch.zeros(N), 8)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quantize_pack_plain_vs_pallas(bits, stochastic):
    rng = np.random.default_rng(10 * bits + stochastic)
    x = planar(rng.normal(size=N).astype(np.float32), bits)
    noise = rng.uniform(size=x.shape).astype(np.float32)
    s = np.float32(np.abs(x).max() / (2 ** (bits - 1) - 1))
    want = quantize_pack_pallas(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(noise), bits=bits,
                                stochastic=stochastic, interpret=True)
    got = quantize_pack(torch.from_numpy(x), torch.tensor(s), bits,
                        torch.from_numpy(noise) if stochastic else None)
    assert np.array_equal(np.asarray(want).view(np.int32), got.numpy())


@pytest.mark.parametrize("bits,k", [(8, 1), (8, 3), (8, 5), (4, 3),
                                    (2, 3), (16, 2)])
def test_decode_apply_plan_vs_jax(bits, k):
    rng = np.random.default_rng(100 * bits + k)
    x = rng.normal(size=N).astype(np.float32)
    streams = random_streams(rng, k, bits)
    scales = rng.uniform(1e-3, 1e-1, size=k).astype(np.float32)
    weights = rng.uniform(0.1, 0.6, size=k).astype(np.float32)
    want = np.asarray(jops.decode_apply_plan(
        jnp.asarray(x), jnp.asarray(streams), jnp.asarray(scales),
        jnp.asarray(weights), bits=bits, interpret=True))
    before = launch_counts()
    got = decode_apply_plan(torch.from_numpy(x),
                            torch.from_numpy(streams.view(np.int32)),
                            torch.from_numpy(scales),
                            torch.from_numpy(weights), bits=bits).numpy()
    assert launch_counts() == before
    assert got.shape == (N,)
    scale = deq_scale(planar(x, bits), streams, scales, weights,
                      bits).reshape(-1)[:N]
    assert within_ulp(got, want, scale, k + 1)
    # The kernel's own plain version on the planar buffer.
    direct = np.asarray(dequant_mix_plan_pallas(
        jnp.asarray(planar(x, bits)), jnp.asarray(streams),
        jnp.asarray(scales), jnp.asarray(weights), bits=bits,
        interpret=True))
    plain = dequant_mix_plan(torch.from_numpy(planar(x, bits)),
                             torch.from_numpy(streams.view(np.int32)),
                             torch.from_numpy(scales),
                             torch.from_numpy(weights), bits).numpy()
    assert within_ulp(plain, direct, deq_scale(planar(x, bits), streams,
                                               scales, weights, bits), k + 1)


@pytest.mark.parametrize("n", [1, 970, 3000, 199210])
@pytest.mark.parametrize("bits,k", [(8, 3), (4, 9), (2, 5), (16, 1)])
def test_decode_apply_plan_ragged_n_vs_jax(bits, k, n):
    """``decode_apply_plan`` on flat vectors whose last planar row is
    partial or whose tail rows are empty (the cases B7's flat entry reads
    with its scalar path on the card) against the JAX package's, within
    k + 1 ulp; its CPU path is the plain decode of the padded view."""
    rng = np.random.default_rng(n + 10 * bits + k)
    x = rng.normal(size=n).astype(np.float32)
    streams = random_streams(rng, k, bits, n)
    scales = rng.uniform(1e-3, 1e-1, size=k).astype(np.float32)
    weights = rng.uniform(0.1, 0.6, size=k).astype(np.float32)
    want = np.asarray(jops.decode_apply_plan(
        jnp.asarray(x), jnp.asarray(streams), jnp.asarray(scales),
        jnp.asarray(weights), bits=bits, interpret=True))
    before = launch_counts()
    got = decode_apply_plan(torch.from_numpy(x),
                            torch.from_numpy(streams.view(np.int32)),
                            torch.from_numpy(scales),
                            torch.from_numpy(weights), bits=bits).numpy()
    assert launch_counts() == before
    assert got.shape == (n,) and got.dtype == np.float32
    scale = deq_scale(planar(x, bits), streams, scales, weights,
                      bits).reshape(-1)[:n]
    assert within_ulp(got, want, scale, k + 1)


@pytest.mark.parametrize("n", [1, 3000, 199210])
def test_decode_apply_ring_ragged_n_vs_jax(n):
    """``decode_apply_ring`` on the same ragged lengths against the JAX
    package's, within 4 ulp (three streams)."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    q = random_streams(rng, 3, 8, n)
    scales = rng.uniform(1e-3, 1e-1, size=3).astype(np.float32)
    want = np.asarray(jops.decode_apply_ring(
        jnp.asarray(x), *(jnp.asarray(a) for a in q), jnp.asarray(scales),
        bits=8, w_self=0.5, w_nb=0.25, interpret=True))
    got = decode_apply_ring(torch.from_numpy(x),
                            *(torch.from_numpy(a.view(np.int32)) for a in q),
                            torch.from_numpy(scales), bits=8, w_self=0.5,
                            w_nb=0.25).numpy()
    assert got.shape == (n,)
    wts = np.asarray([0.5, 0.25, 0.25], np.float32)
    scale = deq_scale(planar(x, 8), q, scales, wts, 8).reshape(-1)[:n]
    assert within_ulp(got, want, scale, 4)


@pytest.mark.parametrize("bits,w_self,w_nb", [(8, 1 / 3, 1 / 3),
                                              (8, 0.5, 0.25),
                                              (4, 0.2, 0.4)])
def test_decode_apply_ring_vs_jax(bits, w_self, w_nb):
    rng = np.random.default_rng(bits)
    x = rng.normal(size=N).astype(np.float32)
    q = random_streams(rng, 3, bits)
    scales = rng.uniform(1e-3, 1e-1, size=3).astype(np.float32)
    want = np.asarray(jops.decode_apply_ring(
        jnp.asarray(x), *(jnp.asarray(a) for a in q), jnp.asarray(scales),
        bits=bits, w_self=w_self, w_nb=w_nb, interpret=True))
    tq = [torch.from_numpy(a.view(np.int32)) for a in q]
    before = launch_counts()
    got = decode_apply_ring(torch.from_numpy(x), *tq,
                            torch.from_numpy(scales), bits=bits,
                            w_self=w_self, w_nb=w_nb).numpy()
    assert launch_counts() == before
    wts = np.asarray([w_self, w_nb, w_nb], np.float32)
    scale = deq_scale(planar(x, bits), q, scales, wts, bits).reshape(-1)[:N]
    assert within_ulp(got, want, scale, 4)
    direct = np.asarray(dequant_mix_pallas(
        jnp.asarray(planar(x, bits)), *(jnp.asarray(a) for a in q),
        jnp.asarray(scales), bits=bits, w_self=w_self, w_nb=w_nb,
        interpret=True))
    plain = dequant_mix(torch.from_numpy(planar(x, bits)), *tq,
                        torch.from_numpy(scales), bits, w_self, w_nb).numpy()
    assert within_ulp(plain, direct, deq_scale(planar(x, bits), q, scales,
                                               wts, bits), 4)


def test_ring_is_the_plan_kernel_at_k3():
    """The ring's plain version is the plan's at k = 3 with the weights
    (w_self, w_nb, w_nb). On the card the two are separate kernels (B8
    over three stream pointers, B7 over a stack), each held to its own
    plain version."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(planar(rng.normal(size=N).astype(np.float32), 8))
    q = torch.from_numpy(random_streams(rng, 3, 8).view(np.int32))
    scales = torch.rand(3)
    got = dequant_mix(x, q[0], q[1], q[2], scales, 8, 0.5, 0.25)
    want = dequant_mix_plan(x, q, scales, torch.tensor([0.5, 0.25, 0.25]), 8)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,eta", [(N, 0.05), (4096, 0.1), (1, 0.013)])
def test_momentum_update_flat_vs_jax(n, eta):
    rng = np.random.default_rng(n)
    y, v, g = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    jy, jv = jops.momentum_update_flat(jnp.asarray(y), jnp.asarray(v),
                                       jnp.asarray(g), eta, THETA,
                                       interpret=True)
    ty, tv = momentum_update_flat(*(torch.from_numpy(a) for a in (y, v, g)),
                                  eta, THETA)
    assert ty.shape == (n,) and tv.shape == (n,)
    v_scale = np.abs(THETA * v.astype(np.float64)) + np.abs(eta * g)
    assert within_ulp(tv.numpy(), np.asarray(jv), v_scale, 2)
    assert within_ulp(ty.numpy(), np.asarray(jy), np.abs(y) + v_scale, 2)


def test_make_fused_momentum_update_over_leaves_vs_jax():
    rng = np.random.default_rng(1)
    shapes = {"b": (16,), "w": (32, 16)}
    y, v, g = ({n: rng.normal(size=s).astype(np.float32)
                for n, s in shapes.items()} for _ in range(3))
    jy, jv = jops.make_fused_momentum_update(interpret=True)(
        *({n: jnp.asarray(a) for n, a in t.items()} for t in (y, v, g)),
        ETA, THETA)
    ty, tv = make_fused_momentum_update()(
        *({n: torch.from_numpy(a) for n, a in t.items()} for t in (y, v, g)),
        ETA, THETA)
    for n in shapes:
        v_scale = np.abs(THETA * v[n].astype(np.float64)) + np.abs(
            ETA * g[n])
        assert within_ulp(tv[n].numpy(), np.asarray(jv[n]), v_scale, 2)
        assert within_ulp(ty[n].numpy(), np.asarray(jy[n]),
                          np.abs(y[n]) + v_scale, 2)
