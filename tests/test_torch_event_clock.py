"""Port parity for the event clock: ``prng.normal`` (T4's plain version)
against ``jax.random.normal``, ``SpeedModel`` and ``next_event`` against
``repro.core.event_clock``, over keys and inputs drawn from numpy seeds.

Contracts: the uniform under ``normal`` bitwise; the normal within
NORMAL_ULP of JAX's (XLA's ``log1p`` and its fused multiply-adds round
otherwise than torch's: 3 ulp at most, on 0.2 % of 262 144 draws);
``constant`` draws exact; lognormal and straggler draws within
DURATION_ULP (the normal's ulps through ``exp``, and torch's ``exp``
against XLA's: 2 ulp at most, on 3 % of 1 536 draws); ``next_event``
equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import SpeedModel as JSpeedModel  # noqa: E402
from repro.core import next_event as j_next_event  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import SpeedModel, next_event  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M = 8
NORMAL_ULP = 3
DURATION_ULP = 2
KEYS64 = [jax.random.fold_in(jax.random.PRNGKey(3), i) for i in range(64)]


def as_i64(jkey) -> np.ndarray:
    return np.asarray(jkey).astype(np.int64)


def t_key(jkey) -> torch.Tensor:
    return torch.from_numpy(as_i64(jkey))


def ulp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 units in the last place, elementwise."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("shape", [(M,), (16,), (4096,), (3, 5)])
def test_normal_uniform_bitwise_normal_within_ulp(shape):
    """The uniform on [nextafter(-1, 0), 1) under ``normal`` is JAX's bit
    for bit; the normal is within NORMAL_ULP of ``jax.random.normal``."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    worst = 0
    for jk in KEYS64:
        f = prng.uniform_plain(t_key(jk), shape)
        u = torch.maximum(torch.tensor(float(lo)), f * 2.0 + float(lo))
        ju = jax.random.uniform(jk, shape, jnp.float32, lo, 1.0)
        assert np.array_equal(u.numpy().view(np.int32),
                              np.asarray(ju).view(np.int32))
        got = prng.normal(t_key(jk), shape)
        assert got.shape == shape and got.dtype == torch.float32
        worst = max(worst, int(ulp(got.numpy(), np.asarray(
            jax.random.normal(jk, shape, jnp.float32))).max()))
    assert worst <= NORMAL_ULP, worst


def test_normal_batches_keys_and_is_plain_on_cpu():
    """Leading key dims batch independent draws (as ``uniform`` does);
    on CPU keys ``prng.normal`` is ``normal_plain``."""
    keys = torch.stack([t_key(k) for k in KEYS64[:5]])
    batch = prng.normal(keys, (7,))
    assert batch.shape == (5, 7)
    for i in range(5):
        assert torch.equal(batch[i], prng.normal_plain(keys[i], (7,)))


def test_speed_model_validation_matches_reference():
    for bad in (dict(kind="warp"), dict(mean=0.0), dict(sigma=-1.0),
                dict(straggler_frac=0.0), dict(straggler_frac=1.5),
                dict(straggler_factor=0.5)):
        with pytest.raises(ValueError):
            JSpeedModel(**bad)
        with pytest.raises(ValueError):
            SpeedModel(**bad)
    for m in (1, 8, 16, 33):
        for frac in (0.125, 1 / 16, 0.5, 1.0):
            js = JSpeedModel.straggler(frac=frac, factor=8.0)
            ts = SpeedModel.straggler(frac=frac, factor=8.0)
            assert ts.n_stragglers(m) == js.n_stragglers(m)
            assert np.array_equal(ts.multipliers(m), js.multipliers(m))
    assert SpeedModel.lognormal().n_stragglers(M) == 0
    assert SpeedModel.constant().is_constant


def test_constant_draw_is_exact_and_draws_nothing(monkeypatch):
    monkeypatch.setattr(prng, "normal", lambda *a: pytest.fail("drew"))
    d = SpeedModel.constant(mean=2.5).draw(prng.PRNGKey(0), M)
    assert d.dtype == torch.float32 and torch.equal(d, torch.full((M,),
                                                                  2.5))
    j = JSpeedModel.constant(mean=2.5).draw(jax.random.PRNGKey(0), M)
    assert np.array_equal(d.numpy(), np.asarray(j))


@pytest.mark.parametrize("kind", ["lognormal", "straggler"])
@pytest.mark.parametrize("m", [M, 16])
def test_random_draws_track_reference(kind, m):
    """Lognormal and straggler durations within DURATION_ULP of the
    reference's over 64 keys; the straggler set is the first clients."""
    make = {"lognormal": lambda L: L.lognormal(mean=1.5, sigma=0.5),
            "straggler": lambda L: L.straggler(mean=1.0, sigma=0.5,
                                               frac=1 / m, factor=10.0)}
    js, ts = make[kind](JSpeedModel), make[kind](SpeedModel)
    worst = 0
    for jk in KEYS64:
        want = np.asarray(js.draw(jk, m))
        got = ts.draw(t_key(jk), m).numpy()
        worst = max(worst, int(ulp(got, want).max()))
    assert worst <= DURATION_ULP, worst
    mult = ts.multipliers_on(m, "cpu")
    assert mult is ts.multipliers_on(m, "cpu")       # built once
    assert np.array_equal(mult.numpy(), js.multipliers(m))


def test_next_event_equal():
    rng = np.random.default_rng(0)
    for trial in range(20):
        nr = rng.exponential(size=M).astype(np.float32)
        if trial % 4 == 0:                     # ties fire together
            nr[rng.integers(M)] = nr.min()
        t, ready = next_event(torch.from_numpy(nr))
        jt, jready = j_next_event(jnp.asarray(nr))
        assert float(t) == float(jt)
        assert ready.dtype == torch.float32
        assert np.array_equal(ready.numpy(), np.asarray(jready))
    t, ready = next_event(SpeedModel.constant(2.0).draw(prng.PRNGKey(0), M))
    assert float(t) == 2.0 and int(ready.sum()) == M
