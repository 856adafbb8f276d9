"""Port parity for the paper's CNN, CharLSTM and MiniResNet and their data:
the port's models against the JAX package's (``repro.models.paper_nets``)
at small widths on the CPU, from the same numpy parameters — a different
model for each client, so a grouped convolution that mixed clients would
show — and the same inputs; the flat ``/`` names of a nested tree against
``jax.tree.flatten``'s order; ``convert``'s round trip; ``char_stream``;
and three DFedAvgM rounds of the CNN (16-bit wire) and the CharLSTM
(8-bit) on the dense quantized mixer against ``repro.core``'s round.

Contracts: logits and per-client gradients within rtol 1e-5, atol 1e-6
(float32 sums taken in other orders by XLA and by PyTorch: convolutions,
matmuls, the LSTM's 4d_h-wide gate products); leaf order and data
bitwise; round loss and consensus within rtol 1e-5, parameters as in
``test_torch_round.py`` (a few ulp, except elements where a
stochastic-rounding decision flipped, at most a quantizer step times a
weight, on under 0.1 % of elements).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import DFedAvgMConfig as JConfig  # noqa: E402
from repro.core import MixingSpec as JMixingSpec  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import init_round_state as j_init  # noqa: E402
from repro.core import make_round_step as j_make_round_step  # noqa: E402
from repro.data import char_stream as j_char_stream  # noqa: E402
from repro.models import paper_nets as jnets  # noqa: E402
from repro_torch import convert, prng  # noqa: E402
from repro_torch.configs.paper_models import PAPER_MODELS  # noqa: E402
from repro_torch.core import (DFedAvgMConfig, MixingSpec, QuantConfig,  # noqa: E402,E501
                              init_round_state, make_round_step)
from repro_torch.core.local_sgd import loss_and_grad  # noqa: E402
from repro_torch.data import char_stream  # noqa: E402
from repro_torch.models import paper_nets as tnets  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

M, B = 3, 4
RTOL, ATOL = 1e-5, 1e-6
LSTM = dict(vocab=11, d_embed=4, d_h=8)
SEQ = 6
RESNET = dict(in_ch=3, width=4, blocks=2)
PARAM_ULP_ATOL = 1e-6
FLIP_SHARE = 1e-3


def per_client(init, **kw):
    """m different JAX models stacked on a leading client axis, as numpy."""
    init = jax.jit(functools.partial(init, **kw))
    trees = [jax.tree.map(np.asarray, init(jax.random.PRNGKey(c)))
             for c in range(M)]
    return jax.tree.map(lambda *a: np.stack(a), *trees)


def leaf_names(tree) -> list[str]:
    """``jax.tree.flatten`` order of a nested dict, keys joined by '/'."""
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(k.key for k in path) for path, _ in paths]


def j_xent(logits, labels):
    """The reference's mean cross-entropy, per client under ``vmap``."""
    return jnets.softmax_xent(logits, labels)


def t_lm_xent(logits, labels):
    """The LM loss: mean over batch and time, as the reference's
    ``softmax_xent`` means over [B, L]."""
    return tnets.softmax_xent(logits.flatten(-3, -2), labels.flatten(-2))


def images(img, ch, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, B, img, img, ch)).astype(np.float32)
    y = rng.integers(0, 10, size=(M, B)).astype(np.int32)
    return x, y


def check_close(got: dict, want, what: str):
    for name, a in zip(leaf_names(want), jax.tree.leaves(want)):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(a),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {name}")


def model_cases():
    return {
        "cnn": (jnets.init_cnn, jnets.apply_cnn, tnets.apply_cnn,
                dict(in_ch=3, img=8)),
        "miniresnet": (jnets.init_miniresnet, jnets.apply_miniresnet,
                       tnets.apply_miniresnet, dict(RESNET, img=6)),
    }


@pytest.mark.parametrize("case", list(model_cases()))
def test_image_models_logits_and_grads_match_jax(case):
    """CNN, and MiniResNet at side 6: its first stride-2 block meets an
    even side (6 -> 3: the 3x3 convolution pads 0 before and 1 after, as
    JAX "SAME" does, the 1x1 shortcut nothing), its second an odd one
    (3 -> 2: 1 and 1)."""
    j_init_fn, j_apply, t_apply, cfg = model_cases()[case]
    cfg = dict(cfg)
    img = cfg.pop("img")
    init_kw = cfg if case != "cnn" else dict(cfg, img=img)
    kw = ({} if case == "cnn" else dict(width=cfg["width"],
                                        blocks=cfg["blocks"]))
    params = per_client(j_init_fn, **init_kw)
    x, y = images(img, cfg["in_ch"], 1)

    def j_loss(p, xb, yb):
        return j_xent(j_apply(p, xb, **kw), yb)

    j_logits = jax.jit(jax.vmap(lambda p, xb: j_apply(p, xb, **kw)))(
        params, x)
    j_grads = jax.jit(jax.vmap(jax.grad(j_loss)))(params, x, y)
    tp = convert.params_from_numpy(params, device="cpu")
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(t_apply(tp, tx, **kw).detach().numpy(),
                               np.asarray(j_logits), rtol=RTOL, atol=ATOL)
    _, grads = loss_and_grad(
        lambda p, b, k: tnets.softmax_xent(t_apply(p, b["x"], **kw),
                                           b["y"]),
        tp, {"x": tx, "y": ty}, None)
    check_close(grads, j_grads, case)
    # One client alone, without the client axis, is the same model.
    one = {n: t[1] for n, t in tp.items()}
    np.testing.assert_allclose(t_apply(one, tx[1], **kw).detach().numpy(),
                               np.asarray(j_logits)[1], rtol=RTOL,
                               atol=ATOL)


def test_charlstm_logits_and_grads_match_jax():
    params = per_client(jnets.init_charlstm, **LSTM)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, LSTM["vocab"], size=(M, B, SEQ + 1)).astype(
        np.int32)

    def j_loss(p, t):
        return j_xent(jnets.apply_charlstm(p, t[:, :-1]), t[:, 1:])

    j_logits = jax.jit(jax.vmap(jnets.apply_charlstm))(params,
                                                       tokens[..., :-1])
    j_grads = jax.jit(jax.vmap(jax.grad(j_loss)))(params, tokens)
    tp = convert.params_from_numpy(params, device="cpu")
    tt = torch.from_numpy(tokens)
    got = tnets.apply_charlstm(tp, tt[..., :-1]).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(j_logits), rtol=RTOL,
                               atol=ATOL)
    losses, grads = loss_and_grad(
        lambda p, b, k: t_lm_xent(tnets.apply_charlstm(p, b["t"][..., :-1]),
                                  b["t"][..., 1:]),
        tp, {"t": tt}, None)
    np.testing.assert_allclose(
        losses.numpy(), np.asarray(jax.vmap(j_loss)(params, tokens)),
        rtol=RTOL)
    check_close(grads, j_grads, "charlstm")


@pytest.mark.parametrize("model", ["charlstm", "miniresnet", "cnn", "2nn"])
def test_leaf_order_is_jax_flatten_order(model):
    """The port's flat names, sorted, are ``jax.tree.flatten``'s order of
    the reference's (nested) tree, with the same shapes: the order that
    picks each leaf's noise key and wire position."""
    inits = {"charlstm": (jnets.init_charlstm, tnets.init_charlstm),
             "miniresnet": (jnets.init_miniresnet, tnets.init_miniresnet),
             "cnn": (jnets.init_cnn, tnets.init_cnn),
             "2nn": (jnets.init_2nn, tnets.init_2nn)}
    j_init_fn, t_init_fn = inits[model]
    jtree = jax.eval_shape(functools.partial(j_init_fn,
                                             **PAPER_MODELS[model]),
                           jax.random.PRNGKey(0))
    tree = t_init_fn(0, device="cpu", **PAPER_MODELS[model])
    names = leaf_names(jtree)
    assert list(convert.params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jtree),
        device="cpu")) == names
    assert sorted(tree) == names
    assert [tuple(tree[n].shape) for n in names] == [
        a.shape for a in jax.tree.leaves(jtree)]


def test_paper_sizes():
    counts = {m: tnets.count_params(init(0, device="cpu", **PAPER_MODELS[m]))
              for m, init in (("cnn", tnets.init_cnn),
                              ("charlstm", tnets.init_charlstm),
                              ("2nn", tnets.init_2nn))}
    assert counts == {"cnn": 1_663_370, "charlstm": 820_522, "2nn": 199_210}


def test_convert_round_trip_of_a_nested_tree():
    tree = per_client(jnets.init_charlstm, **LSTM)
    flat = convert.params_from_numpy(tree, device="cpu")
    assert flat["l1/wx"].shape == (M, LSTM["d_embed"], 4 * LSTM["d_h"])
    back = convert.params_to_numpy(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="separator"):
        convert.params_from_numpy({"a/b": np.zeros(1)}, device="cpu")


@pytest.mark.parametrize("bias_seed", [None, 3])
def test_char_stream_bitwise(bias_seed):
    got = char_stream(3000, vocab=60, bias_seed=bias_seed, seed=5)
    want = j_char_stream(3000, vocab=60, bias_seed=bias_seed, seed=5)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def lm_batches(streams, rnd, K):
    """The reference bench's draw (``benchmarks/bench_charlm.py``)."""
    out = np.zeros((M, K, B, SEQ + 1), np.int32)
    rng = np.random.default_rng(rnd)
    for i, s in enumerate(streams):
        starts = rng.integers(0, len(s) - SEQ - 1, size=(K, B))
        for k in range(K):
            for b in range(B):
                out[i, k, b] = s[starts[k, b]:starts[k, b] + SEQ + 1]
    return out


@pytest.mark.parametrize("model", ["cnn", "charlstm"])
def test_three_rounds_track_jax_dense_quantized(model):
    """Three DFedAvgM rounds on the dense quantized mixer (16-bit CNN,
    8-bit CharLSTM, ring of 3, K = 2) from the same parameters, batches
    and key as ``repro.core.make_round_step``."""
    K, rounds = 2, 3
    if model == "cnn":
        bits, eta = 16, 0.03
        p0 = jax.tree.map(lambda a: a[0], per_client(jnets.init_cnn,
                                                     in_ch=3, img=8))
        rng = np.random.default_rng(4)
        data = [{"x": rng.normal(size=(M, K, B, 8, 8, 3)).astype(np.float32),
                 "y": rng.integers(0, 10, size=(M, K, B)).astype(np.int32)}
                for _ in range(rounds)]

        def j_loss(p, b, key):
            return j_xent(jnets.apply_cnn(p, b["x"]), b["y"])

        def t_loss(p, b, key):
            return tnets.softmax_xent(tnets.apply_cnn(p, b["x"]), b["y"])
    else:
        bits, eta = 8, 1.0
        p0 = jax.tree.map(lambda a: a[0], per_client(jnets.init_charlstm,
                                                     **LSTM))
        streams = [char_stream(200, vocab=LSTM["vocab"], bias_seed=i,
                               seed=i) for i in range(M)]
        data = [{"t": lm_batches(streams, t, K)} for t in range(rounds)]

        def j_loss(p, b, key):
            return j_xent(jnets.apply_charlstm(p, b["t"][:, :-1]),
                          b["t"][:, 1:])

        def t_loss(p, b, key):
            return t_lm_xent(tnets.apply_charlstm(p, b["t"][..., :-1]),
                             b["t"][..., 1:])

    jstep = jax.jit(j_make_round_step(j_loss, JConfig(
        eta=eta, theta=0.9, local_steps=K, quant=JQuantConfig(bits=bits),
        mixer_impl="dense"), JMixingSpec.ring(M, self_weight=0.5)))
    js = j_init(jax.tree.map(
        lambda t: jnp.broadcast_to(t[None], (M,) + t.shape), p0),
        jax.random.PRNGKey(1))
    step = make_round_step(t_loss, DFedAvgMConfig(
        eta=eta, theta=0.9, local_steps=K, quant=QuantConfig(bits=bits),
        mixer_impl="dense"), MixingSpec.ring(M, self_weight=0.5),
        device="cpu")
    ts = init_round_state(convert.params_from_numpy(p0, stack=M,
                                                    device="cpu"),
                          prng.PRNGKey(1))
    for t in range(rounds):
        js, jm = jstep(js, data[t])
        ts, tm = step(ts, {n: torch.from_numpy(a)
                           for n, a in data[t].items()})
        for name in ("loss", "consensus_dist"):
            assert float(tm[name]) == pytest.approx(float(jm[name]),
                                                    rel=1e-5), (t, name)
    assert np.array_equal(np.asarray(js.rng).astype(np.int64),
                          ts.rng.numpy())
    step_size = 2.0 ** -(bits - 1)      # a quantizer step per unit amax
    total = flipped = 0
    for name, want in zip(leaf_names(js.params),
                          jax.tree.leaves(js.params)):
        want = np.asarray(want)
        err = np.abs(ts.params[name].numpy() - want)
        amax = max(float(np.abs(want).max()), 1e-3)
        assert err.max() <= step_size * amax, name
        flipped += int((err > PARAM_ULP_ATOL).sum())
        total += err.size
    assert flipped <= FLIP_SHARE * total, (flipped, total)
