"""Keyed B4: the fused round's encoder (``momentum_quantize_pack_buffer``)
draws its stochastic-rounding noise from the per-leaf keys and the
layout's ``NoiseTable``, as keyed B1 does, so the fused tail never
materializes the noise.

Contracts: on CPU tensors the keyed wrapper equals the tensor-noise
wrapper fed ``WireLayout.noise_stacked`` for the same keys, bitwise (y',
v' and words), and launches nothing; against the JAX package's
``momentum_quantize_pack_buffer_pallas`` (interpret mode) fed the JAX
``noise_stacked`` for the same key, y' and v' within a few ulp (XLA may
contract ``theta*v - eta*g`` into an FMA) and the words bitwise wherever
y' agrees, one level elsewhere; the quantized fused tail never calls
``noise_stacked`` and gives the same result it gave with it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.mixing import _quant_leaf_keys  # noqa: E402
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro.kernels.quantize_pack import momentum_quantize_pack_buffer_pallas  # noqa: E402,E501
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import MixingSpec, QuantConfig, WireLayout  # noqa: E402
from repro_torch.core.mixing import _quant_leaf_keys as t_leaf_keys  # noqa: E402,E501
from repro_torch.core.local_sgd import loss_and_grad  # noqa: E402
from repro_torch.core.mixing import (_plan_tables,  # noqa: E402
                                     _weighted_replica_base, make_fused_tail)
from repro_torch.kernels import (dequant_mix_momentum_buffer,  # noqa: E402
                                 launch_counts, momentum_quantize_pack_buffer)

torch.set_num_threads(1)

M = 3
ETA, THETA = 0.05, 0.9
# Ragged leaves, one of them a single value ("bias").
RAGGED = {"a": (33,), "kernel": (4, 9), "bias": (), "z": (3, 7, 5),
          "big": (2100,)}


def b4_operands(bits, seed, shapes=RAGGED, m=M):
    """Planar y, v, g, x_held of ``shapes`` for m clients, the block
    scales of the resulting delta in B4's order, and the layout."""
    rng = np.random.default_rng(seed)

    def tree(scale):
        return convert.params_from_numpy(
            {n: (scale * rng.normal(size=(m,) + s)).astype(np.float32)
             for n, s in shapes.items()}, device="cpu")

    x = tree(0.3)
    lay = WireLayout.for_tree(x, bits, stacked=True)
    y = lay.to_planar_stacked({n: t + d for (n, t), d in zip(
        x.items(), tree(0.02).values())})
    v, g = lay.to_planar_stacked(tree(0.01)), lay.to_planar_stacked(
        tree(0.1))
    X = lay.to_planar_stacked(x)
    eta, theta = float(np.float32(ETA)), float(np.float32(THETA))
    delta = (y + (theta * v - eta * g)) - X
    sblk = lay.block_scales(lay.leaf_scales(delta, QuantConfig(bits=bits)))
    return lay, y, v, g, X, sblk


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_keyed_wrapper_on_cpu_equals_tensor_noise_wrapper(bits):
    lay, y, v, g, x, sblk = b4_operands(bits, seed=bits)
    keys = t_leaf_keys(prng.PRNGKey(bits), lay.n_leaves, M)
    before = launch_counts()
    got = momentum_quantize_pack_buffer(y, v, g, x, sblk, bits,
                                        (ETA, THETA), keys=keys,
                                        table=lay.noise_table)
    assert launch_counts() == before
    want = momentum_quantize_pack_buffer(y, v, g, x, sblk, bits,
                                         (ETA, THETA),
                                         lay.noise_stacked(keys))
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # The layout's entry point passes the same keys and table.
    eta, theta = float(np.float32(ETA)), float(np.float32(THETA))
    scales = lay.leaf_scales((y + (theta * v - eta * g)) - x,
                             QuantConfig(bits=bits))
    via_layout = lay.encode_momentum(y, v, g, x, scales, (ETA, THETA),
                                     QuantConfig(bits=bits), keys=keys)
    for a, b in zip(via_layout, got):
        assert torch.equal(a, b)


def test_keyed_b4_refuses_noise_with_keys_and_keys_without_table():
    lay, y, v, g, x, sblk = b4_operands(8, seed=1)
    keys = t_leaf_keys(prng.PRNGKey(1), lay.n_leaves, M)
    noise = lay.noise_stacked(keys)
    with pytest.raises(ValueError):
        momentum_quantize_pack_buffer(y, v, g, x, sblk, 8, (ETA, THETA),
                                      noise, keys=keys,
                                      table=lay.noise_table)
    with pytest.raises(ValueError):
        momentum_quantize_pack_buffer(y, v, g, x, sblk, 8, (ETA, THETA),
                                      keys=keys)
    scales = torch.ones((M, lay.n_leaves))
    with pytest.raises(ValueError, match="needs keys"):
        lay.encode_momentum(y, v, g, x, scales, (ETA, THETA),
                            QuantConfig(bits=8))


def fields(words: np.ndarray, bits: int) -> np.ndarray:
    """uint32 words [W] -> fields [per, W]."""
    shifts = (np.arange(32 // bits, dtype=np.uint64) * bits)[:, None]
    return ((words.astype(np.uint64)[None] >> shifts)
            & ((1 << bits) - 1)).astype(np.int64)


def within_ulp(got, want, scale, n) -> bool:
    """|got - want| within n ulp of ``scale``, the magnitude of the terms
    that were summed (an FMA's one rounding saves at most that)."""
    tol = n * np.spacing(np.asarray(scale, np.float32))
    return bool((np.abs(got.astype(np.float64) - want) <= tol).all())


@pytest.mark.parametrize("bits", [4, 8])
def test_keyed_b4_vs_jax_noise_stacked_and_pallas(bits):
    lay, y, v, g, x, sblk = b4_operands(bits, seed=20 + bits)
    keys = t_leaf_keys(prng.PRNGKey(5), lay.n_leaves, M)
    got = [t.numpy() for t in momentum_quantize_pack_buffer(
        y, v, g, x, sblk, bits, (ETA, THETA), keys=keys,
        table=lay.noise_table)]

    jlay = JWireLayout.for_tree(
        {n: jax.ShapeDtypeStruct(s, jnp.float32) for n, s in RAGGED.items()},
        bits=bits)
    jnoise = jlay.noise_stacked(
        _quant_leaf_keys(jax.random.PRNGKey(5), jlay.n_leaves, M))
    et = jnp.asarray([ETA, THETA], jnp.float32)
    for c in range(M):
        want = [np.asarray(a) for a in momentum_quantize_pack_buffer_pallas(
            *(jnp.asarray(t[c].numpy()) for t in (y, v, g, x)),
            jnp.asarray(sblk[c].numpy())[None], jnoise[c], et, bits=bits,
            stochastic=True, interpret=True)]
        v_scale = (THETA * np.abs(v[c].numpy().astype(np.float64))
                   + ETA * np.abs(g[c].numpy()))
        assert within_ulp(got[1][c], want[1], v_scale, 2)
        assert within_ulp(got[0][c], want[0], np.abs(y[c].numpy()) + v_scale,
                          3)
        same_y = got[0][c] == want[0]
        f_got = fields(got[2][c].view(np.uint32), bits)
        f_want = fields(want[2].astype(np.uint32), bits)
        assert np.array_equal(f_got[same_y], f_want[same_y]), c
        assert np.abs(f_got - f_want).max() <= 1


def lin_loss(p, b, rng):
    del rng
    out = torch.matmul(b["x"], p["w"]) + p["b"][:, None, :]
    return (out ** 2).mean(dim=(1, 2))


@pytest.mark.parametrize("bits", [4, 8])
def test_fused_tail_never_materializes_the_noise(monkeypatch, bits):
    """The quantized fused tail hands B4 the keys: ``noise_stacked`` is
    not called on its path, and the tail's outputs are bitwise those of
    the same steps with B4 fed ``noise_stacked``."""
    m, d, o = 4, 6, 5
    rng = np.random.default_rng(bits)

    def arr(*shape, scale=0.1):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32))

    x = {"w": arr(m, d, o), "b": arr(m, o)}
    y = {n: t + arr(*t.shape, scale=0.01) for n, t in x.items()}
    v = {n: arr(*t.shape, scale=0.01) for n, t in x.items()}
    g = {n: arr(*t.shape) for n, t in x.items()}
    batch = {"x": arr(m, 3, d, scale=1.0)}
    quant = QuantConfig(bits=bits)
    plan = MixingSpec.ring(m, self_weight=0.5).gossip_plan()
    args = (x, y, v, g, batch, prng.split(prng.PRNGKey(2), m),
            prng.PRNGKey(3))

    tail = make_fused_tail(lin_loss, m, eta=ETA, theta=THETA, quant=quant,
                           plan=plan, device="cpu")

    def refuse(self, keys):
        raise AssertionError("noise_stacked called on the fused tail path")

    monkeypatch.setattr(WireLayout, "noise_stacked", refuse)
    x_next, y_pub, loss = tail(*args)
    monkeypatch.undo()

    # The tail as it was when it drew the noise itself: B4 fed
    # noise_stacked for the tail's keys, then the last gradient and B5.
    lay = WireLayout.for_tree(x, bits, stacked=True)
    noise = lay.noise_stacked(t_leaf_keys(args[-1], lay.n_leaves, m))
    X, Y, V, G = (lay.to_planar_stacked(t) for t in (x, y, v, g))
    eta, theta = float(np.float32(ETA)), float(np.float32(THETA))
    sblk = lay.block_scales(lay.leaf_scales((Y + (theta * V - eta * G)) - X,
                                            quant))
    y_out, v_out, words = momentum_quantize_pack_buffer(
        Y, V, G, X, sblk, bits, (ETA, THETA), noise)
    y_want = lay.from_planar_stacked(y_out)
    loss_want, gK = loss_and_grad(lin_loss, y_want, batch, args[5])
    src, w = _plan_tables(plan, torch.device("cpu"))
    out = dequant_mix_momentum_buffer(
        _weighted_replica_base(X, w, src), words, sblk, w, src, v_out,
        lay.to_planar_stacked(gK), (ETA, THETA), bits)
    x_want = lay.from_planar_stacked(out)
    assert torch.equal(loss, loss_want)
    for n in x:
        assert torch.equal(y_pub[n], y_want[n]), n
        assert torch.equal(x_next[n], x_want[n]), n
