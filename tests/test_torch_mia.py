"""The port's membership-inference probe (``repro_torch.privacy``) and its
bench (``repro_torch.bench.mia``) against the JAX package's
(``repro.privacy``, ``benchmarks/bench_mia.py``) on the CPU, from the
same numpy inputs and the reference's 2NN converted to the port.

Contracts:

* ``mia_split`` arrays and ``roc_auc`` (random, tied and one-class
  scores) equal: both are the same numpy.
* ``attack_features`` within 2 ulp on the same logits, and within rtol
  1e-5 through the converted 2NN (its f32 products sum in another order,
  so the logits differ before the softmax).
* The attack model's init within 4 ulp (``jax.random.normal`` contracts
  erf_inv's Horner steps: up to 3 ulp, then the f32 scale); its scores
  after 300 gradient steps on the same features within rtol 1e-5.
* ``attack_auc`` end to end within 2e-3: the scores differ by ulps, and
  one swapped pair of near-tied scores moves the AUC by 1 / (n_pos *
  n_neg) = 1.6e-5 at n 1 200.
* The reference's two sanity tests (``tests/test_mia.py``) on the port:
  an overfit model leaks (AUC > 0.6), an untrained one does not (within
  0.12 of 0.5).
* ``bench.mia``'s ``_train_on`` (3 rounds, n 400) within rtol 1e-5 of
  the reference's consensus model (atol 1e-6 for the biases near 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import classification_dataset as j_data  # noqa: E402
from repro.models.paper_nets import apply_2nn as j_apply  # noqa: E402
from repro.models.paper_nets import init_2nn as j_init  # noqa: E402
from repro.privacy import mia as J  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data import classification_dataset  # noqa: E402
from repro_torch.models.paper_nets import apply_2nn, init_2nn, softmax_xent  # noqa: E402,E501
from repro_torch.privacy import mia as T  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FEATURE_ULP = 2
FEATURE_RTOL = 1e-5
INIT_ULP = 4
SCORE_RTOL = 1e-5
AUC_ATOL = 2e-3
TRAIN_RTOL, TRAIN_ATOL = 1e-5, 1e-6


def ulp(a, b) -> int:
    """Largest distance in f32 ulps between two arrays of one shape."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)

    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max()) if a.size else 0


def port(tree):
    return convert.params_from_numpy(
        {n: np.asarray(v) for n, v in tree.items()}, device="cpu")


def predictors(seed: int):
    """The reference's ``init_2nn(PRNGKey(seed), d_in=64)`` and the same
    weights on the port."""
    p = j_init(jax.random.PRNGKey(seed), d_in=64)
    tp = port(p)
    return (lambda v: j_apply(p, v)), (lambda v: apply_2nn(tp, v))


def test_port_exports_the_reference_names():
    import repro.privacy as jp
    import repro_torch.privacy as tp
    assert T.__all__ == J.__all__
    for name in ("mia_split", "attack_features", "train_attack_model",
                 "attack_auc", "roc_auc", "MIASplit"):
        assert hasattr(jp, name) and hasattr(tp, name), name


@pytest.mark.parametrize("n, seed", [(1600, 0), (1201, 3), (7, 1)])
def test_mia_split_equal(n, seed):
    a, b = J.mia_split(n, seed=seed), T.mia_split(n, seed=seed)
    for f in ("shadow_train", "shadow_out", "target_train", "target_out"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _scores(kind):
    rng = np.random.default_rng(5)
    if kind == "random":
        return rng.random(500).astype(np.float32), rng.integers(0, 2, 500)
    if kind == "tied":
        return (rng.integers(0, 4, 300).astype(np.float32) / 4,
                rng.integers(0, 2, 300))
    return rng.random(50).astype(np.float32), np.ones(50, np.int64)


@pytest.mark.parametrize("kind", ["random", "tied", "one_class"])
def test_roc_auc_equal(kind):
    s, lab = _scores(kind)
    got = T.roc_auc(s, lab)
    assert got == J.roc_auc(s, lab)
    if kind == "one_class":
        assert got == 0.5


@pytest.mark.parametrize("inputs", ["same_logits", "converted_2nn"])
def test_attack_features_within_2_ulp(inputs):
    """On the same logits the softmax and the sort are within 2 ulp. Through
    the converted 2NN the logits already differ (2.4e-6 at |logit| 5.4,
    f32 products summed in another order), and the features follow them:
    within rtol 1e-5 (measured 2.1e-6)."""
    data = j_data(n=400, d=64, noise=3.0, seed=3)
    jp, tp = predictors(0)
    if inputs == "same_logits":
        logits = np.asarray(jp(data.x))
        want = J.attack_features(lambda v: logits, data.x)
        got = T.attack_features(lambda v: torch.from_numpy(logits.copy()),
                                data.x, device="cpu")
        assert ulp(got, want) <= FEATURE_ULP
    else:
        want = J.attack_features(jp, data.x)
        got = T.attack_features(tp, data.x, device="cpu")
        np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL, atol=0)
    assert got.dtype == np.float32 and got.shape == want.shape == (400, 3)
    assert np.all(np.diff(got, axis=1) <= 0)


@pytest.mark.parametrize("d, seed", [(3, 0), (3, 7), (10, 1)])
def test_attack_init_within_4_ulp(d, seed):
    """The reference's split order (``privacy/mia.py:62-69``)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    want = {"w1": jax.random.normal(k1, (d, 64)) * (1.0 / np.sqrt(d)),
            "w2": jax.random.normal(k2, (64, 2)) * (1.0 / np.sqrt(64))}
    got = T.attack_init(d, seed=seed, device="cpu")
    for n, w in want.items():
        assert got[n].dtype == torch.float32
        assert ulp(got[n].numpy(), np.asarray(w)) <= INIT_ULP, n
    assert not got["b1"].any() and not got["b2"].any()
    assert got["b1"].shape == (64,) and got["b2"].shape == (2,)


def test_attack_scores_after_300_steps():
    data = j_data(n=800, d=64, noise=3.0, seed=3)
    jp, _ = predictors(0)
    feats = J.attack_features(jp, data.x)
    labels = (np.arange(800) < 400).astype(np.float64)
    want = J.train_attack_model(feats, labels, seed=0)(feats)
    got = T.train_attack_model(feats, labels, seed=0, device="cpu")(feats)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=0)


def test_attack_auc_end_to_end():
    data = j_data(n=1200, d=64, noise=3.0, seed=3)
    split = J.mia_split(len(data.y), seed=0)
    js, ts = predictors(0)
    jt, tt = predictors(1)
    want = J.attack_auc(js, jt, data, split)
    got = T.attack_auc(ts, tt, data, split, device="cpu")
    assert 0.0 <= got <= 1.0 and abs(got - want) <= AUC_ATOL, (got, want)


def _train(params, x, y, steps, lr=0.2):
    """The reference test's full-batch gradient descent on the 2NN."""
    names = list(params)
    for _ in range(steps):
        p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
        g = torch.autograd.grad(softmax_xent(apply_2nn(p, x), y),
                                [p[n] for n in names])
        params = {n: p[n].detach() - lr * gw for n, gw in zip(names, g)}
    return params


def test_overfit_model_leaks_membership():
    data = classification_dataset(n=1200, d=64, noise=3.0, seed=3)
    split = T.mia_split(len(data.y), seed=0)
    x, y = torch.from_numpy(data.x), torch.from_numpy(data.y)
    shadow = _train(init_2nn(0, d_in=64, device="cpu"),
                    x[split.shadow_train], y[split.shadow_train], 400)
    target = _train(init_2nn(1, d_in=64, device="cpu"),
                    x[split.target_train], y[split.target_train], 400)
    auc = T.attack_auc(lambda v: apply_2nn(shadow, v),
                       lambda v: apply_2nn(target, v), data, split,
                       device="cpu")
    assert auc > 0.6, auc


def test_untrained_model_private():
    data = classification_dataset(n=1200, d=64, noise=3.0, seed=3)
    split = T.mia_split(len(data.y), seed=0)
    fresh_s = init_2nn(5, d_in=64, device="cpu")
    fresh_t = init_2nn(6, d_in=64, device="cpu")
    auc = T.attack_auc(lambda v: apply_2nn(fresh_s, v),
                       lambda v: apply_2nn(fresh_t, v), data, split,
                       device="cpu")
    assert abs(auc - 0.5) < 0.12, auc


def test_bench_train_on_tracks_the_reference():
    from benchmarks.bench_mia import _train_on as j_train_on
    from repro_torch.bench.mia import _train_on
    jd = j_data(n=400, d=64, noise=3.0, seed=3)
    td = classification_dataset(n=400, d=64, noise=3.0, seed=3)
    assert np.array_equal(jd.x, td.x) and np.array_equal(jd.y, td.y)
    idx = J.mia_split(400, seed=0).shadow_train
    want = j_train_on(jd, idx, 3, seed=1)
    got = _train_on(td, idx, 3, seed=1, device="cpu")
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=n)
