"""Port parity: ``repro_torch.prng`` (threefry-2x32, partitionable mode)
against ``jax.random`` — bitwise, for every draw the main path makes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (turns on jax_threefry_partitionable)
from repro.core.mixing import _quant_leaf_keys  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core.mixing import _quant_leaf_keys as t_quant_leaf_keys  # noqa: E402,E501

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def as_i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1])
def test_prngkey(seed):
    assert np.array_equal(as_i64(jax.random.PRNGKey(seed)),
                          prng.PRNGKey(seed).numpy())


@pytest.mark.parametrize("num", [1, 2, 3, 16, 17])
def test_split_bitwise(num):
    key = jax.random.PRNGKey(7)
    ref = jax.random.split(key, num)
    got = prng.split(prng.PRNGKey(7), num)
    assert got.shape == (num, 2)
    assert np.array_equal(as_i64(ref), got.numpy())


def test_round_chain_bitwise():
    """dfedavgm.py:258-259 and local_sgd.py:73 — the round's key chain:
    split(rng, 3), split(key_round, m), split(client_key, K) per client."""
    m, K = 5, 3
    rng = jax.random.PRNGKey(1)
    trng = prng.PRNGKey(1)
    for _ in range(2):
        kr, km, kn = jax.random.split(rng, 3)
        tkr, tkm, tkn = prng.split(trng, 3)
        ck = jax.random.split(kr, m)
        tck = prng.split(tkr, m)
        assert np.array_equal(as_i64(ck), tck.numpy())
        steps = jax.vmap(lambda k: jax.random.split(k, K))(ck)
        assert np.array_equal(as_i64(steps), prng.split(tck, K).numpy())
        assert np.array_equal(as_i64(km), tkm.numpy())
        rng, trng = kn, tkn
    assert np.array_equal(as_i64(rng), trng.numpy())


@pytest.mark.parametrize("n", [1, 2, 7, 512, 1001, 4096])
def test_uniform_bitwise(n):
    key = jax.random.split(jax.random.PRNGKey(3), 2)[1]
    ref = np.asarray(jax.random.uniform(key, (n,), jnp.float32))
    got = prng.uniform(torch.from_numpy(as_i64(key)), (n,)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(ref.view(np.int32), got.view(np.int32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("n_leaves,m,n", [(6, 4, 33), (3, 5, 130),
                                          (1, 2, 2048)])
def test_quant_leaf_keys_and_noise_bitwise(n_leaves, m, n):
    """mixing.py:210-214 then wire_layout.py:247/258: per-(leaf, client)
    keys and each leaf's ``uniform(key, (n,))`` draw."""
    key = jax.random.PRNGKey(11)
    ref_keys = _quant_leaf_keys(key, n_leaves, m)
    got_keys = t_quant_leaf_keys(prng.PRNGKey(11), n_leaves, m)
    assert np.array_equal(as_i64(ref_keys), got_keys.numpy())
    ref_u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (n,))))(
        ref_keys)
    got_u = prng.uniform(got_keys, (n,))
    assert np.array_equal(np.asarray(ref_u).view(np.int32),
                          got_u.numpy().view(np.int32))


def test_uniform_at_matches_uniform():
    key = prng.PRNGKey(9)
    full = prng.uniform(key, (3, 50))
    idx = torch.tensor([[0, 7, 149], [149, 3, 64]])
    got = prng.uniform_at(key[0], key[1], idx)
    assert torch.equal(got, full.reshape(-1)[idx])


def test_seed_out_of_range():
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31)


KEYS64 = [jax.random.fold_in(jax.random.PRNGKey(11), i) for i in range(64)]


def t_key(jkey) -> torch.Tensor:
    return torch.from_numpy(as_i64(jkey))


@pytest.mark.parametrize("d", [0, 1, 5, 1000])
def test_fold_in_is_split_bitwise(d):
    """fold_in(k, d) == split(k, d + 1)[d] in the partitionable mode, and
    the port's fold_in equals jax.random.fold_in over 64 keys."""
    key = jax.random.PRNGKey(7)
    assert np.array_equal(as_i64(jax.random.fold_in(key, d)),
                          as_i64(jax.random.split(key, d + 1)[d]))
    for jk in KEYS64:
        assert np.array_equal(as_i64(jax.random.fold_in(jk, d)),
                              prng.fold_in(t_key(jk), d).numpy())


@pytest.mark.parametrize("n", [1, 2, 16, 100])
def test_permutation_bitwise(n):
    """jax.random.permutation(key, n) over 64 keys (the exact cohort's
    draw and the cap_slack clamp's, with fold_in(key, 1))."""
    for jk in KEYS64:
        want = np.asarray(jax.random.permutation(jk, n))
        assert np.array_equal(want, prng.permutation(t_key(jk), n).numpy())


def test_random_bits_bitwise():
    """T3's plain version is jax.random.bits (uint32)."""
    for jk in KEYS64[:8]:
        want = np.asarray(jax.random.bits(jk, (3, 16), jnp.uint32))
        got = prng.random_bits(t_key(jk), (3, 16))
        assert got.dtype == torch.int64
        assert np.array_equal(want.astype(np.int64), got.numpy())


@pytest.mark.parametrize("row", [
    [0, 1, 0, 0, 0, 0, 0, 1],              # a ring node: p = 1/2
    [1, 1, 1, 0, 0, 0, 0, 0],              # degree 3: p = 1/3
    [0, 1, 0, 1, 1, 0, 1, 1],              # degree 5
    [1, 1, 1, 1, 1, 1, 0, 1]],             # degree 7
    ids=["deg2", "deg3", "deg5", "deg7"])
def test_choice_bitwise(row):
    """jax.random.choice(key, n, p=row / row.sum()) (the stateful walk's
    next node) over 64 keys: the cumsum's summation order decides ties at
    a boundary, so every key must agree."""
    r = np.asarray(row, np.float32)
    jp = jnp.asarray(r) / jnp.asarray(r).sum()
    tp = torch.from_numpy(r) / torch.from_numpy(r).sum()
    for jk in KEYS64:
        want = int(jax.random.choice(jk, len(row), p=jp))
        got = prng.choice(t_key(jk), len(row), tp)
        assert got.dim() == 0 and int(got) == want
