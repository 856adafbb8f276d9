"""The port's ``prng.randint`` and version-keyed data
(``repro_torch.data.lm_round_batches`` / ``lm_client_batches``) against
``jax.random.randint`` and ``repro.data`` on the CPU, and the claims of
the reference's ``tests/test_version_data.py`` held on the port: a
client's batch is a pure function of (key, client, version), invariant
to the query order and to the rest of the fleet; it advances with the
version only; a global-index keying is order-sensitive; and the async
engine fed by a version-keyed ``batch_fn`` equals one hand-fed the same
batches.

Contracts: bitwise everywhere (integer draws; the engines' parameters).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (turns on jax_threefry_partitionable)
from repro import data as JD  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch import core as T  # noqa: E402
from repro_torch.data import lm_client_batches, lm_round_batches  # noqa: E402,E501

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KW = dict(K=2, batch=3, seq=8, vocab=50)
N_KEYS = 64


def keys(n: int, seed: int = 0):
    """n random raw keys: (port int64 [n, 2], jax uint32 [n, 2])."""
    k = np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2),
                                             dtype=np.int64)
    return torch.from_numpy(k), jnp.asarray(k.astype(np.uint32))


# (minval, maxval): a span dividing 2^32, spans that do not, a negative
# range, the whole int32 range, an empty range (maxval <= minval gives
# minval) and one of a single value.
RANGES = [(0, 16), (0, 10), (0, 50), (-5, 7), (3, 8000),
          (-2 ** 31, 2 ** 31 - 1), (0, 2 ** 31 - 1), (7, 7), (9, 2),
          (-1, 0)]


@pytest.mark.parametrize("lo,hi", RANGES)
def test_randint_bitwise_over_64_keys(lo, hi):
    tk, jk = keys(N_KEYS, seed=lo % 997 + hi % 991)
    shape = (3, 5)
    want = jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi))(jk)
    got = prng.randint(tk, shape, lo, hi)
    assert got.dtype == torch.int32 and got.shape == (N_KEYS,) + shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = prng.randint(tk[5], (7,), lo, hi)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jax.random.randint(jk[5], (7,), lo, hi)))


def test_randint_array_bounds_bitwise():
    """minval and maxval as arrays broadcast against the shape."""
    tk, jk = keys(1, seed=5)
    lo = np.array([0, -3, 10, 100], np.int32)
    hi = np.array([7, 3, 1000, 101], np.int32)
    want = jax.random.randint(jk[0], (6, 4), jnp.asarray(lo),
                              jnp.asarray(hi))
    got = prng.randint(tk[0], (6, 4), torch.from_numpy(lo),
                       torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("round_idx", [0, 5, 2 ** 31 + 3])
def test_lm_round_batches_bitwise(round_idx):
    want = JD.lm_round_batches(jax.random.PRNGKey(42), round_idx, m=4, **KW)
    got = lm_round_batches(prng.PRNGKey(42), round_idx, m=4, **KW)
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_lm_client_batches_bitwise():
    ids = np.array([4, 0, 9, 2, 100_000, 3], np.int32)
    vers = np.array([1, 0, 3, 1, 7, 0], np.int32)
    want = JD.lm_client_batches(jax.random.PRNGKey(42), jnp.asarray(ids),
                                jnp.asarray(vers), **KW)
    got = lm_client_batches(prng.PRNGKey(42), torch.from_numpy(ids),
                            torch.from_numpy(vers), **KW)
    for k in ("tokens", "targets"):
        assert got[k].shape == (6, KW["K"], KW["batch"], KW["seq"])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


KEY = prng.PRNGKey(42)


def test_client_batches_are_order_and_fleet_invariant():
    ids = torch.tensor([4, 0, 9, 2])
    vers = torch.tensor([1, 0, 3, 1])
    full = lm_client_batches(KEY, ids, vers, **KW)
    perm = torch.tensor([2, 0, 3, 1])
    shuffled = lm_client_batches(KEY, ids[perm], vers[perm], **KW)
    for k in ("tokens", "targets"):
        assert torch.equal(shuffled[k], full[k][perm])
    # The rest of the fleet is invisible: client 9 queried alone gets the
    # batch it got inside the cohort.
    alone = lm_client_batches(KEY, torch.tensor([9]), torch.tensor([3]),
                              **KW)
    assert torch.equal(alone["tokens"][0], full["tokens"][2])


def test_client_batches_advance_with_version_only():
    a, b = lm_client_batches(KEY, torch.tensor([3, 3]), torch.tensor([0, 1]),
                             **KW)["tokens"]
    assert (a != b).any()                      # the stream advances
    again = lm_client_batches(KEY, torch.tensor([3]), torch.tensor([0]),
                              **KW)["tokens"][0]
    assert torch.equal(again, a)               # and is replayable


def test_global_index_keying_is_order_sensitive():
    """What version keying guards against: ``lm_round_batches`` keyed on a
    global counter gives client 0 other data when an unrelated event
    moves the counter."""
    b5 = lm_round_batches(KEY, 5, m=4, **KW)["tokens"][0]
    b6 = lm_round_batches(KEY, 6, m=4, **KW)["tokens"][0]
    assert (b5 != b6).any()


def test_async_engine_batch_fn_is_version_keyed():
    """An engine that feeds itself ``batch_fn(arange(m), version)`` each
    event equals one hand-fed the same version-keyed batches, bit for bit:
    the fleet's event interleaving cannot change which batch a client
    trains on at a given version."""
    M, V = 6, 50
    spec = T.MixingSpec.ring(M, self_weight=0.5)
    cfg = T.DFedAvgMConfig(eta=0.3, theta=0.5, local_steps=2)
    acfg = T.AsyncConfig(speed=T.SpeedModel.straggler(factor=4.0))

    def loss_fn(p, b, r):
        logits = b["tokens"][..., None] * 0.01 + p["w"][:, None, None]
        logp = torch.log_softmax(logits, -1)
        nll = -logp.gather(-1, b["targets"].long()[..., None])[..., 0]
        return nll.mean(dim=(-1, -2))

    def bf(ids, vers):
        return lm_client_batches(KEY, ids, vers, **{**KW, "vocab": V})

    step_auto = T.make_async_round_step(loss_fn, cfg, spec, acfg,
                                        batch_fn=bf, device="cpu")
    step_manual = T.make_round_step(loss_fn, cfg, spec, async_cfg=acfg,
                                    device="cpu")
    params = {"w": torch.zeros(M, V)}
    sa = T.init_async_state(params, prng.PRNGKey(0), acfg.speed)
    sm = T.init_async_state(params, prng.PRNGKey(0), acfg.speed)
    for _ in range(6):
        sa, _ = step_auto(sa)
        sm, _ = step_manual(sm, bf(torch.arange(M), sm.version))
        assert torch.equal(sa.params["w"], sm.params["w"])
        assert torch.equal(sa.version, sm.version)
    assert int(sa.version.sum()) > 0
