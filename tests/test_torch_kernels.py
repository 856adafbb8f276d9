"""Port parity: the plain PyTorch versions of the three main-path kernels
against the JAX package's Pallas kernels (interpret mode), on the same
numpy inputs.

Contracts: packed words bitwise. Floats within one ulp per accumulated
term, measured on the operands' magnitude (``|got - want| <= n_terms *
spacing(sum of |terms|)``, element by element): the plain versions round
every multiply and add separately, while XLA may contract each
multiply-add of the Pallas body into one FMA — the JAX package's own
``kernels/ref.py`` states this "~1 ulp per term" slack between its kernel
and oracle. So the heavy-ball update (two terms) gets 2 ulp and a decode
of k streams onto a base k + 1. The bound is on the operands, not the
result, because a result that cancels to near zero keeps the absolute
error of its terms.

On the card, ``chip_smoke.py`` holds each CUDA kernel against these same
plain versions.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dequant_mix import dequant_mix_buffer_pallas  # noqa: E402
from repro.kernels.momentum_sgd import momentum_sgd_pallas  # noqa: E402
from repro.kernels.quantize_pack import quantize_pack_buffer_pallas  # noqa: E402,E501
from repro_torch.kernels import (dequant_mix_buffer, launch_counts,  # noqa: E402,E501
                                 momentum_sgd, quantize_pack_buffer, ref)
from repro_torch.kernels.dequant_mix import dequant_mix_buffer_plain  # noqa: E402,E501

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LB = ref.LANE_BLOCK


def assert_within_ulp(got: np.ndarray, want: np.ndarray,
                      scale: np.ndarray, n_terms: int) -> None:
    """|got - want| <= n_terms ulp of ``scale`` (the sum of the absolute
    values of the terms), element by element."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    tol = n_terms * np.spacing(np.asarray(scale, np.float32))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= tol).all(), float((err / tol).max())


def block_scales(pattern: str, n_blocks: int, bits: int,
                 rng) -> np.ndarray:
    qmax = 2 ** (bits - 1) - 1
    if pattern == "uniform":
        return np.full((n_blocks,), 1.0 / qmax, np.float32)
    if pattern == "per_block":
        return (rng.uniform(0.2, 3.0, n_blocks) / qmax).astype(np.float32)
    # "clipping": steps far too small, so most values saturate
    return np.full((n_blocks,), 1e-3 / qmax, np.float32)


@pytest.mark.parametrize("pattern", ["uniform", "per_block", "clipping"])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quantize_pack_plain_vs_pallas(bits, stochastic, pattern):
    rng = np.random.default_rng(bits * 10 + stochastic)
    per, nb = 32 // bits, 3
    x = rng.normal(size=(per, nb * LB)).astype(np.float32)
    noise = rng.uniform(size=x.shape).astype(np.float32)
    sb = block_scales(pattern, nb, bits, rng)
    want = quantize_pack_buffer_pallas(
        jnp.asarray(x), jnp.asarray(sb[None]), jnp.asarray(noise),
        bits=bits, stochastic=stochastic, interpret=True)
    got = ref.quantize_pack_buffer_ref(
        torch.from_numpy(x), torch.from_numpy(sb), bits,
        torch.from_numpy(noise) if stochastic else None)
    assert got.dtype == torch.int32 and got.shape == (nb * LB,)
    assert np.array_equal(np.asarray(want).view(np.int32), got.numpy())


def test_quantize_pack_wrapper_on_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(3, 4, 2 * LB)).astype(np.float32))
    sb = torch.full((3, 2), 0.01)
    noise = torch.from_numpy(rng.uniform(size=x.shape).astype(np.float32))
    before = launch_counts()
    got = quantize_pack_buffer(x, sb, 8, noise)
    assert launch_counts() == before
    assert torch.equal(got, ref.quantize_pack_buffer_ref(x, sb, 8, noise))


@pytest.mark.parametrize("bits,k", [(8, 1), (8, 2), (8, 3), (8, 4), (8, 5),
                                    (2, 3), (4, 3), (16, 3)])
def test_dequant_mix_plain_vs_pallas(bits, k):
    rng = np.random.default_rng(100 * bits + k)
    per, nb = 32 // bits, 2
    w = nb * LB
    base = rng.normal(size=(per, w)).astype(np.float32)
    streams = rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint64).astype(
        np.uint32)
    sblk = rng.uniform(1e-3, 1e-1, size=(k, nb)).astype(np.float32)
    weights = rng.uniform(0.1, 0.6, size=(k,)).astype(np.float32)
    want = np.asarray(dequant_mix_buffer_pallas(
        jnp.asarray(base), jnp.asarray(streams), jnp.asarray(sblk),
        jnp.asarray(weights), bits=bits, interpret=True))
    got = ref.dequant_mix_buffer_ref(
        torch.from_numpy(base), torch.from_numpy(streams.view(np.int32)),
        torch.from_numpy(sblk), torch.from_numpy(weights), bits).numpy()
    assert_within_ulp(got, want, mix_scale(base, streams, sblk, weights,
                                           bits), k + 1)


def mix_scale(base, streams, sblk, weights, bits):
    """sum of |terms| of ``base + sum_k w_k * deq_k`` in f64."""
    per = 32 // bits
    shifts = (np.arange(per, dtype=np.uint64) * bits)[:, None]
    scol = np.repeat(sblk.astype(np.float64), ref.LANE_BLOCK, axis=-1)
    total = np.abs(base.astype(np.float64))
    for k in range(streams.shape[0]):
        f = ((streams[k].astype(np.uint64)[None] >> shifts)
             & ((1 << bits) - 1)).astype(np.float64) - 2 ** (bits - 1)
        total = total + np.abs(weights[k] * f * scol[k][None])
    return total


def test_dequant_mix_gather_wrapper_matches_pallas_per_client():
    """The port's B2 takes every client's own words once plus the plan's
    src table; per client it must equal the Pallas kernel fed that
    client's gathered stream stack."""
    rng = np.random.default_rng(5)
    m, bits, nb = 4, 8, 2
    per, w = 32 // bits, nb * LB
    base = rng.normal(size=(m, per, w)).astype(np.float32)
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(
        np.uint32)
    sblk = rng.uniform(1e-3, 1e-1, size=(m, nb)).astype(np.float32)
    src = np.stack([np.arange(m), np.roll(np.arange(m), 1),
                    np.roll(np.arange(m), -1)]).astype(np.int32)
    weights = rng.uniform(0.1, 0.6, size=(m, 3)).astype(np.float32)
    before = launch_counts()
    got = dequant_mix_buffer(
        torch.from_numpy(base), torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(sblk), torch.from_numpy(weights),
        torch.from_numpy(src), bits).numpy()
    assert launch_counts() == before
    for c in range(m):
        want = np.asarray(dequant_mix_buffer_pallas(
            jnp.asarray(base[c]), jnp.asarray(words[src[:, c]]),
            jnp.asarray(sblk[src[:, c]]), jnp.asarray(weights[c]),
            bits=bits, interpret=True))
        assert_within_ulp(got[c], want, mix_scale(
            base[c], words[src[:, c]], sblk[src[:, c]], weights[c], bits),
            src.shape[0] + 1)


def test_dequant_mix_plain_is_the_gathered_ref():
    rng = np.random.default_rng(6)
    m, bits = 3, 4
    base = torch.from_numpy(rng.normal(size=(m, 8, LB)).astype(np.float32))
    words = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(m, LB),
                                          dtype=np.int64).astype(np.int32))
    sblk = torch.rand(m, 1)
    weights = torch.rand(m, 2)
    src = torch.tensor([[0, 1, 2], [2, 0, 1]], dtype=torch.int32)
    got = dequant_mix_buffer_plain(base, words, sblk, weights, src, bits)
    want = torch.stack([ref.dequant_mix_buffer_ref(
        base[c], words[src[:, c].long()], sblk[src[:, c].long()],
        weights[c], bits) for c in range(m)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,eta", [((3, 700), 0.05), ((8, 512), 0.1),
                                       ((1, 1), 0.05), ((17, 33), 0.013),
                                       ((200, 10), 0.5)])
def test_momentum_plain_vs_pallas(shape, eta):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    y, v, g = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = momentum_sgd_pallas(jnp.asarray(y), jnp.asarray(v),
                               jnp.asarray(g), eta=jnp.float32(eta),
                               theta=0.9, interpret=True)
    got = momentum_sgd(torch.from_numpy(y), torch.from_numpy(v),
                       torch.from_numpy(g), eta, 0.9)
    v_scale = np.abs(0.9 * v.astype(np.float64)) + np.abs(eta * g)
    assert tuple(got[0].shape) == shape
    assert_within_ulp(got[1].numpy(), want[1], v_scale, 2)
    assert_within_ulp(got[0].numpy(), want[0], np.abs(y) + v_scale, 2)


def _bf16_bits(a) -> np.ndarray:
    return (torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
            .view(torch.int16).numpy())


@pytest.mark.parametrize("shape,eta", [((3, 700), 0.05), ((8, 512), 0.1),
                                       ((17, 33), 0.013), ((64, 96), 3e-2)])
def test_momentum_plain_vs_pallas_bf16(shape, eta):
    """On bf16 leaves the plain B3 and the Pallas kernel in interpret mode
    both widen to f32, compute there and round each result to bf16 at the
    store (y' from the unrounded f32 v'). They differ only where XLA's CPU
    backend contracts ``theta*v - eta*g`` into ``fma(theta, v, -(eta*g))``
    (the slack the f32 test above allows as 2 ulp): the Pallas output is
    bitwise that contracted form rounded to bf16, the plain output bitwise
    the separately rounded form (B3's ``_rn`` arithmetic, which nvcc does
    not contract), and the elements where the two outputs differ are
    exactly those where the two forms round to different bf16 values."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + 7)
    y, v, g = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    want = momentum_sgd_pallas(*(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                                 for a in (y, v, g)),
                               eta=jnp.float32(eta), theta=0.9,
                               interpret=True)
    got = momentum_sgd(y, v, g, eta, 0.9)
    theta32, eta32 = np.float32(0.9), np.float32(eta)
    yf, vf, gf = (a.float().numpy() for a in (y, v, g))
    # theta * v is exact in f64 (24 + 8 significant bits): one rounding.
    v_fma = (np.float64(theta32) * vf.astype(np.float64)
             - (eta32 * gf).astype(np.float64)).astype(np.float32)
    v_sep = (theta32 * vf - eta32 * gf).astype(np.float32)
    forms = {"fma": (yf + v_fma, v_fma), "sep": (yf + v_sep, v_sep)}
    for i, (gt, w) in enumerate(zip(got, want)):
        assert gt.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        got_bits = gt.view(torch.int16).numpy()
        want_bits = np.asarray(w).view(np.int16)
        fma_bits, sep_bits = (_bf16_bits(forms[k][i]) for k in forms)
        assert np.array_equal(got_bits, sep_bits)
        assert np.array_equal(want_bits, fma_bits)
        assert np.array_equal(got_bits != want_bits, sep_bits != fma_bits)


def test_cuda_operand_checks_reject_cpu_tensors():
    from repro_torch.kernels import native
    with pytest.raises(ValueError):
        native.require(torch.zeros(4), "x", torch.float32)
