"""Port parity: the round's key chain lives on the parameters' device and
stays bitwise with ``jax.random.split`` (partitionable mode) over many
rounds — the round-level ``split(rng, 3)``, the client keys
``split(key_round, m)``, the per-step keys ``split(client_key, K)`` and
the per-leaf quantizer keys; the rounds' own carried key after 12 port
rounds equals the JAX chain's. ``capture_step`` refuses a CPU round.

Contract: keys bitwise (they are integers).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core  # noqa: E402,F401  (turns on jax_threefry_partitionable)
from repro.core.mixing import _quant_leaf_keys  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import (DFedAvgMConfig, MixerConfig, MixingSpec,  # noqa: E402,E501
                              QuantConfig, RoundState, capture_step,
                              init_round_state, make_mixer, make_round_step)
from repro_torch.core.mixing import _quant_leaf_keys as t_leaf_keys  # noqa: E402,E501
from repro_torch.data import FederatedDataset, classification_dataset  # noqa: E402,E501
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, K, ROUNDS, N_LEAVES = 4, 2, 12, 6
D_IN, HID, B = 8, 4, 4


def as_i64(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def test_twelve_round_chain_bitwise_with_jax():
    rng, trng = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for t in range(ROUNDS):
        kr, km, kn = jax.random.split(rng, 3)
        tkr, tkm, tkn = prng.split(trng, 3)
        ck, tck = jax.random.split(kr, M), prng.split(tkr, M)
        assert np.array_equal(as_i64(ck), tck.numpy()), t
        steps = jax.vmap(lambda k: jax.random.split(k, K))(ck)
        assert np.array_equal(as_i64(steps), prng.split(tck, K).numpy()), t
        assert np.array_equal(as_i64(_quant_leaf_keys(km, N_LEAVES, M)),
                              t_leaf_keys(tkm, N_LEAVES, M).numpy()), t
        rng, trng = kn, tkn
    assert np.array_equal(as_i64(rng), trng.numpy())


@pytest.mark.parametrize("fuse_round", [False, True],
                         ids=["unfused", "fused"])
def test_round_steps_carry_the_jax_chain(fuse_round):
    """12 port rounds carry exactly the key JAX's chain reaches."""
    fed = FederatedDataset.make(classification_dataset(n=64, d=D_IN), M)
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=K,
                         quant=QuantConfig(bits=8), fuse_round=fuse_round)
    step = make_round_step(t_loss, cfg, MixingSpec.ring(M, 0.5),
                           device="cpu")
    p0 = tnets.init_2nn(0, d_in=D_IN, d_hidden=HID, device="cpu")
    st = init_round_state({n: t.expand((M,) + t.shape).contiguous()
                           for n, t in p0.items()}, prng.PRNGKey(1))
    rng = jax.random.PRNGKey(1)
    for t in range(ROUNDS):
        st, _ = step(st, fed.round_batches(t, K=K, batch=B, device="cpu"))
        rng = jax.random.split(rng, 3)[2]
    assert st.round == ROUNDS
    assert np.array_equal(as_i64(rng), st.rng.numpy())


def test_init_round_state_puts_the_key_on_the_params_device():
    params = {"w": torch.zeros((M, 3), device="meta")}
    st = init_round_state(params, prng.PRNGKey(1))   # a CPU key
    assert st.rng.device == params["w"].device and st.round == 0
    cpu = init_round_state({"w": torch.zeros((M, 3))}, prng.PRNGKey(1))
    assert cpu.rng.device.type == "cpu"
    assert torch.equal(cpu.rng, prng.PRNGKey(1))


@pytest.mark.parametrize("impl", ["ring", "dense"])
def test_mixer_refuses_a_key_on_another_device(impl):
    """No silent host-to-device copy of the quantizer key: a key that is
    not on the parameters' device is refused."""
    mixer = make_mixer(MixingSpec.ring(M, 0.5),
                       MixerConfig(impl=impl, quant=QuantConfig(bits=8)),
                       device="cpu")
    x = {"w": torch.zeros((M, 16))}
    z = {"w": torch.ones((M, 16))}
    with pytest.raises(ValueError, match="key must be on"):
        mixer(x, z, prng.PRNGKey(2).to("meta"))
    assert torch.isfinite(mixer(x, z, prng.PRNGKey(2))["w"]).all()


def test_capture_step_refuses_the_cpu():
    params = {"w": torch.zeros((M, 3))}
    calls = []

    def step(state, batches):
        calls.append(1)
        return state, {}

    with pytest.raises(ValueError, match="CUDA"):
        capture_step(step, RoundState(params, prng.PRNGKey(0), 0),
                     {"x": torch.zeros((M, 1, 2))})
    assert not calls          # refused before running anything eagerly


def test_static_buffers_take_only_their_own_shape_and_dtype():
    """What ``run`` copies into the captured graph's buffers: a tensor of
    the captured shape and dtype (any device), nothing else; the buffer
    itself is left as it is."""
    from repro_torch.core.compiled import _load

    dst = torch.zeros((M, 3))
    _load(dst, torch.ones((M, 3)), "w")
    assert torch.equal(dst, torch.ones((M, 3)))
    _load(dst, dst, "w")
    with pytest.raises(ValueError, match="w: captured for"):
        _load(dst, torch.ones((M, 4)), "w")
    with pytest.raises(ValueError, match="rng: captured for"):
        _load(torch.zeros(2, dtype=torch.int64), torch.zeros(2), "rng")


def test_cpu_keys_take_the_plain_versions(monkeypatch):
    """On the CPU ``prng.split`` / ``prng.uniform`` are exactly their plain
    versions (also for a key that is not contiguous), which stay bitwise
    with ``jax.random.split`` / ``uniform``; the kernel wrappers refuse a
    key that is neither on the CPU nor on a card, and count no launch."""
    from repro_torch.kernels import native, threefry

    keys = prng.split_plain(prng.PRNGKey(7), 6)[::2]     # [3, 2], strided
    calls = []
    for name in ("split_plain", "uniform_plain"):
        plain = getattr(prng, name)
        monkeypatch.setattr(prng, name, lambda *a, _f=plain, _n=name:
                            calls.append(_n) or _f(*a))
    jkeys = jax.random.split(jax.random.PRNGKey(7), 6)[::2]
    got = prng.split(keys, 5)
    assert np.array_equal(
        got.numpy(), as_i64(jax.vmap(lambda k: jax.random.split(k, 5))(
            jkeys)))
    u = prng.uniform(keys, (4, 33))
    want = jax.vmap(lambda k: jax.random.uniform(k, (4, 33)))(jkeys)
    assert np.array_equal(u.numpy().view(np.int32),
                          np.asarray(want).view(np.int32))
    assert calls == ["split_plain", "uniform_plain"]
    before = dict(native.LAUNCHES)
    for fn, arg in ((threefry.split, 2), (threefry.uniform, (3,))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(prng.PRNGKey(1).to("meta"), arg)
    assert native.LAUNCHES == before


def test_fused_round_splits_client_keys_once(monkeypatch):
    """The fused round splits the client keys into the per-step keys once
    and hands step K-1's key to its tail: four splits a round (round keys,
    client keys, per-step keys, per-leaf quantizer keys), and the tail's
    keys are ``split(client_keys, K)[:, K-1]`` bitwise."""
    from repro_torch.core import dfedavgm, mixing

    fed = FederatedDataset.make(classification_dataset(n=64, d=D_IN), M)
    cfg = DFedAvgMConfig(eta=0.05, theta=0.9, local_steps=3,
                         quant=QuantConfig(bits=8), fuse_round=True)
    splits, tail_keys = [], []
    real_split = prng.split
    monkeypatch.setattr(prng, "split", lambda key, num=2: splits.append(
        (tuple(key.shape), num)) or real_split(key, num))
    real_tail = mixing.make_fused_tail

    def spy_tail(*a, **kw):
        tail = real_tail(*a, **kw)

        def run(x, y, v, g, batch_last, keys_last, key_q):
            tail_keys.append(keys_last.clone())
            return tail(x, y, v, g, batch_last, keys_last, key_q)
        return run

    monkeypatch.setattr(dfedavgm, "make_fused_tail", spy_tail)
    step = make_round_step(t_loss, cfg, MixingSpec.ring(M, 0.5),
                           device="cpu")
    p0 = tnets.init_2nn(0, d_in=D_IN, d_hidden=HID, device="cpu")
    st = init_round_state({n: t.expand((M,) + t.shape).contiguous()
                           for n, t in p0.items()}, prng.PRNGKey(1))
    splits.clear()          # the keyed init's own splits
    step(st, fed.round_batches(0, K=3, batch=B, device="cpu"))
    assert splits == [((2,), 3), ((2,), M), ((M, 2), 3),
                      ((2,), N_LEAVES * M)]
    kr = jax.random.split(jax.random.PRNGKey(1), 3)[0]
    ck = jax.random.split(kr, M)
    want = jax.vmap(lambda k: jax.random.split(k, 3))(ck)[:, 2]
    assert len(tail_keys) == 1
    assert np.array_equal(tail_keys[0].numpy(), as_i64(want))
