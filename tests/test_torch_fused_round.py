"""Port parity for the fused round (``DFedAvgMConfig.fuse_round``): the
plain versions of B4 (penultimate step + encode) and B5 (decode-apply +
deferred last step) against the JAX package's Pallas kernels in
interpret mode and its refs, ``local_train_deferred`` against JAX, and
three fused rounds against the JAX fused round on a one-device client
mesh (``mixer_impl="ring"``, ``wire="planar"``, the Pallas momentum
update).

Contracts:
  * words bitwise wherever the two packages' deltas agree bitwise; XLA
    may contract ``theta*v - eta*g`` into an FMA, so y' and v' are held
    to a few ulp, and a word field may differ by one level only where
    y' differs (the one-quantizer-step bound of ``test_fused_round.py``);
  * B5 within one ulp of the operands per accumulated term, as B2;
  * rounds: loss and consensus within rtol 1e-5, parameters within a few
    ulp except stochastic-rounding flips (one quantizer step times a
    mixing weight) on under 0.1 % of the elements;
  * in the port, the fused round at eta = 0 equals the unfused round
    bitwise, and the fused plan body equals the fused dense reference
    within one quantizer step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import DFedAvgMConfig as JConfig  # noqa: E402
from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import init_round_state as j_init  # noqa: E402
from repro.core import make_round_step as j_make_round_step  # noqa: E402
from repro.core.local_sgd import local_train_deferred as j_deferred  # noqa: E402,E501
from repro.core.wire_layout import WireLayout as JWireLayout  # noqa: E402
from repro.data import FederatedDataset as JFed  # noqa: E402
from repro.data import classification_dataset as j_dataset  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dequant_mix import dequant_mix_momentum_buffer_pallas  # noqa: E402,E501
from repro.kernels.ops import make_fused_momentum_update  # noqa: E402
from repro.kernels.quantize_pack import momentum_quantize_pack_buffer_pallas  # noqa: E402,E501
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,  # noqa: E402,E501
                              TopologySchedule, WireLayout, init_round_state,
                              make_round_step, ring_graph)
from repro_torch.core.local_sgd import local_train_deferred  # noqa: E402
from repro_torch.core.mixing import make_fused_tail  # noqa: E402
from repro_torch.data import FederatedDataset, classification_dataset  # noqa: E402,E501
from repro_torch.kernels import (dequant_mix_momentum_buffer,  # noqa: E402
                                 launch_counts, momentum_quantize_pack_buffer,
                                 ref)
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LB = ref.LANE_BLOCK
M, K, B, ROUNDS = 4, 3, 8, 3
D_IN, HID = 32, 16
ETA, THETA = 0.05, 0.9
PARAM_ULP_ATOL = 1e-6        # a few ulp at |x| ~ 0.5
FLIP_ATOL = 1e-4             # one 8-bit quantizer step x weight
FLIP_SHARE = 1e-3
QUANTS = {"q8-lemma5-stoch": dict(bits=8),
          "q8-eq7-det": dict(bits=8, stochastic=False, delta_mode="eq7"),
          "fp32": None}
CODECS = [(8, True), (8, False), (4, True)]


def spacing_ok(got, want, scale, n_terms) -> bool:
    tol = n_terms * np.spacing(np.asarray(scale, np.float32))
    return bool((np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)) <= tol).all())


def fields(words: np.ndarray, bits: int) -> np.ndarray:
    """uint32 words [W] -> fields [per, W]."""
    shifts = (np.arange(32 // bits, dtype=np.uint64) * bits)[:, None]
    return ((words.astype(np.uint64)[None] >> shifts)
            & ((1 << bits) - 1)).astype(np.int64)


def b4_inputs(bits, seed):
    rng = np.random.default_rng(seed)
    per, nb = 32 // bits, 3
    shape = (per, nb * LB)
    y = rng.normal(size=shape).astype(np.float32) * 0.5
    x = y - rng.normal(size=shape).astype(np.float32) * 0.02
    v = rng.normal(size=shape).astype(np.float32) * 0.01
    g = rng.normal(size=shape).astype(np.float32) * 0.3
    noise = rng.uniform(size=shape).astype(np.float32)
    # Per-block scales of the resulting delta, in the kernel's order
    # (numpy rounds every operation: no contraction).
    e, t = np.float32(ETA), np.float32(THETA)
    delta = (y + (t * v - e * g)) - x
    amax = np.abs(delta).reshape(per, nb, LB).max(axis=(0, 2))
    sblk = (amax * np.float32(1.0 / np.float32(2 ** (bits - 1) - 1))
            ).astype(np.float32)
    return y, v, g, x, noise, sblk


@pytest.mark.parametrize("bits,stochastic", CODECS)
def test_momentum_quantize_pack_plain_vs_pallas_and_ref(bits, stochastic):
    y, v, g, x, noise, sblk = b4_inputs(bits, 10 * bits + stochastic)
    et = jnp.asarray([ETA, THETA], jnp.float32)
    want = [np.asarray(a) for a in momentum_quantize_pack_buffer_pallas(
        *(jnp.asarray(a) for a in (y, v, g, x)), jnp.asarray(sblk[None]),
        jnp.asarray(noise), et, bits=bits, stochastic=stochastic,
        interpret=True)]
    want_ref = [np.asarray(a) for a in jref.momentum_quantize_pack_buffer_ref(
        *(jnp.asarray(a) for a in (y, v, g, x)), jnp.asarray(sblk), bits,
        jnp.float32(ETA), jnp.float32(THETA),
        jnp.asarray(noise) if stochastic else None)]
    tt = [torch.from_numpy(a) for a in (y, v, g, x)]
    got = [a.numpy() for a in ref.momentum_quantize_pack_buffer_ref(
        *tt, torch.from_numpy(sblk), bits, (ETA, THETA),
        torch.from_numpy(noise) if stochastic else None)]
    v_scale = np.abs(THETA * v.astype(np.float64)) + np.abs(ETA * g)
    for w_y, w_v, w_words in (want, want_ref):
        assert spacing_ok(got[1], w_v, v_scale, 2)
        assert spacing_ok(got[0], w_y, np.abs(y) + v_scale, 3)
        same_y = got[0] == w_y
        f_got = fields(got[2].view(np.uint32), bits)
        f_want = fields(w_words.astype(np.uint32), bits)
        # Bitwise where y' (hence delta) agrees; one level elsewhere.
        assert np.array_equal(f_got[same_y], f_want[same_y])
        assert np.abs(f_got - f_want).max() <= 1
        assert (f_got != f_want).mean() < 1e-3


def test_momentum_quantize_pack_wrapper_on_cpu_is_plain_for_m_clients():
    rng = np.random.default_rng(3)
    m, bits = 3, 8
    y, v, g, x, noise = (torch.from_numpy(rng.normal(size=(m, 4, 2 * LB))
                                          .astype(np.float32))
                         for _ in range(5))
    sb = torch.full((m, 2), 0.02)
    before = launch_counts()
    got = momentum_quantize_pack_buffer(y, v, g, x, sb, bits, (ETA, THETA),
                                        noise)
    assert launch_counts() == before
    for c in range(m):
        want = ref.momentum_quantize_pack_buffer_ref(
            y[c], v[c], g[c], x[c], sb[c], bits, (ETA, THETA), noise[c])
        for a, b in zip(got, want):
            assert torch.equal(a[c], b)


def b5_scale(base, streams, sblk, weights, v, g, bits):
    per = 32 // bits
    shifts = (np.arange(per, dtype=np.uint64) * bits)[:, None]
    scol = np.repeat(sblk.astype(np.float64), LB, axis=-1)
    total = np.abs(base.astype(np.float64))
    for k in range(streams.shape[0]):
        f = ((streams[k].astype(np.uint64)[None] >> shifts)
             & ((1 << bits) - 1)).astype(np.float64) - 2 ** (bits - 1)
        total = total + np.abs(weights[k] * f * scol[k][None])
    return total + np.abs(THETA * v.astype(np.float64)) + np.abs(ETA * g)


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_mix_momentum_plain_vs_pallas_and_ref(bits):
    rng = np.random.default_rng(bits)
    per, nb, k = 32 // bits, 2, 3
    w = nb * LB
    base, v, g = (rng.normal(size=(per, w)).astype(np.float32)
                  for _ in range(3))
    streams = rng.integers(0, 2 ** 32, size=(k, w), dtype=np.uint64).astype(
        np.uint32)
    sblk = rng.uniform(1e-3, 1e-1, size=(k, nb)).astype(np.float32)
    weights = rng.uniform(0.1, 0.6, size=(k,)).astype(np.float32)
    et = np.asarray([ETA, THETA], np.float32)
    args = (jnp.asarray(base), jnp.asarray(streams), jnp.asarray(sblk),
            jnp.asarray(weights), jnp.asarray(v), jnp.asarray(g),
            jnp.asarray(et))
    want = np.asarray(dequant_mix_momentum_buffer_pallas(
        *args, bits=bits, interpret=True))
    want_ref = np.asarray(jref.dequant_mix_momentum_buffer_ref(*args, bits))
    got = ref.dequant_mix_momentum_buffer_ref(
        torch.from_numpy(base), torch.from_numpy(streams.view(np.int32)),
        torch.from_numpy(sblk), torch.from_numpy(weights),
        torch.from_numpy(v), torch.from_numpy(g), (ETA, THETA), bits).numpy()
    scale = b5_scale(base, streams, sblk, weights, v, g, bits)
    assert spacing_ok(got, want, scale, k + 3)
    assert spacing_ok(got, want_ref, scale, k + 3)


def test_dequant_mix_momentum_gather_wrapper_matches_pallas_per_client():
    rng = np.random.default_rng(5)
    m, bits, nb = 4, 8, 2
    per, w = 32 // bits, nb * LB
    base, v, g = (rng.normal(size=(m, per, w)).astype(np.float32)
                  for _ in range(3))
    words = rng.integers(0, 2 ** 32, size=(m, w), dtype=np.uint64).astype(
        np.uint32)
    sblk = rng.uniform(1e-3, 1e-1, size=(m, nb)).astype(np.float32)
    src = np.stack([np.arange(m), np.roll(np.arange(m), 1),
                    np.roll(np.arange(m), -1)]).astype(np.int32)
    weights = rng.uniform(0.1, 0.6, size=(m, 3)).astype(np.float32)
    before = launch_counts()
    got = dequant_mix_momentum_buffer(
        *(torch.from_numpy(a) for a in (base, words.view(np.int32), sblk,
                                        weights, src, v, g)),
        (ETA, THETA), bits).numpy()
    assert launch_counts() == before
    et = jnp.asarray([ETA, THETA], jnp.float32)
    for c in range(m):
        want = np.asarray(dequant_mix_momentum_buffer_pallas(
            jnp.asarray(base[c]), jnp.asarray(words[src[:, c]]),
            jnp.asarray(sblk[src[:, c]]), jnp.asarray(weights[c]),
            jnp.asarray(v[c]), jnp.asarray(g[c]), et, bits=bits,
            interpret=True))
        assert spacing_ok(got[c], want, b5_scale(
            base[c], words[src[:, c]], sblk[src[:, c]], weights[c], v[c],
            g[c], bits), 6)


def j_loss(p, b, rng):
    return jnets.softmax_xent(jnets.apply_2nn(p, b["x"]), b["y"])


def t_loss(p, b, rng):
    return tnets.softmax_xent(tnets.apply_2nn(p, b["x"]), b["y"])


def setup():
    data = j_dataset(n=400, d=D_IN, seed=0)
    params = jnets.init_2nn(jax.random.PRNGKey(0), d_in=D_IN, d_hidden=HID)
    return data, params, jax.tree.map(np.asarray, params)


def t_batches(t=0):
    tfed = FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                        seed=0), M)
    return tfed.round_batches(t, K=K, batch=B, device="cpu")


def test_local_train_deferred_matches_jax():
    data, params, np_params = setup()
    batches = JFed.make(data, M).round_batches(0, K=K, batch=B)
    keys = jax.random.split(jax.random.PRNGKey(4), M)
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), params)
    jy, jv, jg, jl = jax.vmap(lambda p, b, k: j_deferred(
        j_loss, p, b, k, eta=ETA, theta=THETA))(stacked, batches, keys)
    y, v, g, losses = local_train_deferred(
        t_loss, convert.params_from_numpy(np_params, stack=M, device="cpu"),
        t_batches(), prng.split(prng.split(prng.PRNGKey(4), M), K),
        eta=ETA, theta=THETA)
    assert losses.shape == (M, K - 1)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-6)
    for got, want in ((y, jy), (v, jv), (g, jg)):
        for n, t in got.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(want[n]),
                                       rtol=1e-5, atol=1e-7)


def test_local_train_deferred_needs_two_steps():
    _, _, np_params = setup()
    b = {n: t[:, :1] for n, t in t_batches().items()}
    with pytest.raises(ValueError, match="K >= 2"):
        local_train_deferred(t_loss, convert.params_from_numpy(
            np_params, stack=M, device="cpu"), b,
            prng.split(prng.split(prng.PRNGKey(0), M), 1), eta=ETA,
            theta=THETA)


@pytest.mark.parametrize("qname", list(QUANTS))
def test_three_fused_rounds_track_jax_one_device_mesh(qname):
    quant = QUANTS[qname]
    data, params, np_params = setup()
    fed = JFed.make(data, M)
    stacked = jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), params)
    jcfg = JConfig(eta=ETA, theta=THETA, local_steps=K,
                   quant=None if quant is None else JQuantConfig(**quant),
                   mixer_impl="ring", wire="planar", fuse_round=True)
    mesh = Mesh(np.array(jax.devices()[:1]), ("clients",))
    jstep = jax.jit(j_make_round_step(
        j_loss, jcfg, JMixingSpec.ring(M, self_weight=0.5), mesh=mesh,
        client_axes=("clients",),
        fused_update=make_fused_momentum_update(interpret=True)))
    js = j_init(stacked, jax.random.PRNGKey(1))

    tfed = FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                        seed=0), M)
    cfg = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                         quant=None if quant is None
                         else QuantConfig(**quant), fuse_round=True)
    step = make_round_step(t_loss, cfg, MixingSpec.ring(M, self_weight=0.5),
                           device="cpu")
    ts = init_round_state(convert.params_from_numpy(np_params, stack=M,
                                                    device="cpu"),
                          prng.PRNGKey(1))
    for t in range(ROUNDS):
        js, jm = jstep(js, fed.round_batches(t, K=K, batch=B))
        ts, tm = step(ts, tfed.round_batches(t, K=K, batch=B, device="cpu"))
        for name in ("loss", "consensus_dist", "local_drift"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-5), (t, name)
    assert np.array_equal(np.asarray(js.rng).astype(np.int64),
                          ts.rng.numpy())
    total = flipped = 0
    for n, got in convert.params_to_numpy(ts.params).items():
        want = np.asarray(js.params[n])
        err = np.abs(got - want)
        assert err.max() <= FLIP_ATOL, n
        flipped += int((err > PARAM_ULP_ATOL).sum())
        total += err.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)


def run_port(cfg, rounds=ROUNDS):
    _, _, np_params = setup()
    tfed = FederatedDataset.make(classification_dataset(n=400, d=D_IN,
                                                        seed=0), M)
    step = make_round_step(t_loss, cfg, MixingSpec.ring(M, self_weight=0.5),
                           device="cpu")
    s = init_round_state(convert.params_from_numpy(np_params, stack=M,
                                                   device="cpu"),
                         prng.PRNGKey(7))
    for t in range(rounds):
        s, met = step(s, tfed.round_batches(t, K=K, batch=B, device="cpu"))
    return s, met


@pytest.mark.parametrize("qname", list(QUANTS))
def test_fused_eta0_bitwise_equal_to_unfused(qname):
    quant = QUANTS[qname]
    base = DFedAvgMConfig(eta=0.0, theta=THETA, local_steps=K,
                          quant=None if quant is None
                          else QuantConfig(**quant))
    s_u, m_u = run_port(base)
    s_f, m_f = run_port(dataclasses.replace(base, fuse_round=True))
    for n in s_u.params:
        assert torch.equal(s_u.params[n], s_f.params[n]), n
    assert float(m_f["loss"]) == pytest.approx(float(m_u["loss"]), rel=1e-6)


def test_fused_changes_trajectory_at_nonzero_eta():
    base = DFedAvgMConfig(eta=ETA, theta=THETA, local_steps=K,
                          quant=QuantConfig(bits=8))
    s_u, _ = run_port(base, rounds=1)
    s_f, _ = run_port(dataclasses.replace(base, fuse_round=True), rounds=1)
    assert torch.isfinite(s_f.params["w1"]).all()
    assert not torch.equal(s_u.params["w1"], s_f.params["w1"])


@pytest.mark.parametrize("qname", ["q8-lemma5-stoch", "q8-eq7-det", "fp32",
                                   "q4-lemma5-stoch"])
def test_fused_plan_body_matches_fused_dense_reference(qname):
    quant = (QuantConfig(bits=4) if qname == "q4-lemma5-stoch"
             else None if QUANTS[qname] is None
             else QuantConfig(**QUANTS[qname]))
    _, _, np_params = setup()
    x = convert.params_from_numpy(np_params, stack=M, device="cpu")
    client_keys = prng.split(prng.PRNGKey(2), M)
    batches = t_batches()
    step_keys = prng.split(client_keys, K)
    y, v, g, _ = local_train_deferred(t_loss, x, batches, step_keys,
                                      eta=ETA, theta=THETA)
    spec = MixingSpec.ring(M, self_weight=0.5)
    args = (x, y, v, g, {n: b[:, K - 1] for n, b in batches.items()},
            step_keys[:, K - 1], prng.PRNGKey(3))
    outs = [make_fused_tail(t_loss, M, eta=ETA, theta=THETA, quant=quant,
                            plan=plan, W=spec.W, device="cpu")(*args)
            for plan in (spec.gossip_plan(), None)]
    (xp, yp, lp), (xd, yd, ld) = outs
    assert torch.equal(lp, ld)
    for n in x:
        assert torch.equal(yp[n], yd[n]), n
    # One quantizer step: the largest per-leaf step of this delta times
    # the largest weight, never more.
    layout = WireLayout.for_tree(x, 8, stacked=True)
    delta = layout.to_planar_stacked({n: yp[n] - x[n] for n in x})
    step = 0.0 if quant is None else float(
        layout.leaf_scales(delta, quant).max()) * 0.5
    for n in x:
        err = float((xp[n] - xd[n]).abs().max())
        assert err <= max(step, 1e-6), (n, err, step)


def test_flatten_f32_matches_jax_and_round_trips():
    _, params, np_params = setup()
    st = convert.params_from_numpy(np_params, stack=M, device="cpu")
    layout = WireLayout.for_tree(st, 32, stacked=True)
    flat = layout.flatten_f32(st)
    want = np.asarray(JWireLayout.for_tree(params).flatten_f32(params))
    assert flat.shape == (M, want.shape[0])
    for c in range(M):
        assert np.array_equal(flat[c].numpy(), want)
    back = layout.unflatten(flat)
    assert all(torch.equal(back[n], st[n]) for n in st)


def test_fuse_round_config_validation():
    spec = MixingSpec.ring(M, self_weight=0.5)
    with pytest.raises(ValueError, match="local_steps >= 2"):
        make_round_step(t_loss, DFedAvgMConfig(local_steps=1,
                                               fuse_round=True), spec,
                        device="cpu")
    with pytest.raises(ValueError, match="skip_inactive_compute"):
        make_round_step(t_loss, DFedAvgMConfig(local_steps=3,
                                               fuse_round=True), spec,
                        device="cpu", skip_inactive_compute=True)
    with pytest.raises(TypeError, match="MixingSpec or a TopologySchedule"):
        make_round_step(t_loss, DFedAvgMConfig(local_steps=3,
                                               fuse_round=True), object(),
                        device="cpu")
    # The reference's own refusals of a schedule in the fused round.
    walk = TopologySchedule.random_walk(ring_graph(M), stateful=True)
    with pytest.raises(ValueError, match="stateful"):
        make_round_step(t_loss, DFedAvgMConfig(local_steps=3,
                                               fuse_round=True), walk,
                        device="cpu")
    with pytest.raises(ValueError, match="skip_inactive_compute"):
        make_round_step(t_loss, DFedAvgMConfig(local_steps=3,
                                               fuse_round=True),
                        TopologySchedule.partial(ring_graph(M), 0.5,
                                                 exact=True),
                        device="cpu", skip_inactive_compute=True)


def test_fused_round_without_a_card_the_default_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_round_step(t_loss, DFedAvgMConfig(local_steps=3,
                                               fuse_round=True),
                        MixingSpec.ring(M))
