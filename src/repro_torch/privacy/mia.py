"""Membership-inference attack (paper §6, following Salem et al. / the
paper's shadow-model protocol) — the port of the JAX package's
``privacy/mia.py``:

  1. split the training pool into D_shadow / D_target, each split in half
     (train / out);
  2. train a SHADOW model on D_shadow^train; featurize every point in
     D_shadow by its top-3 predicted class probabilities; label 1 if the
     point was in D_shadow^train else 0;
  3. train the ATTACK model (MLP, one hidden layer of 64, softmax) on
     those features;
  4. train the TARGET model on D_target^train (with the algorithm under
     evaluation — DFedAvgM etc.), featurize D_target, and report the
     attack ROC AUC. AUC 0.5 = perfect membership privacy.

``mia_split`` and ``roc_auc`` are the reference's numpy, line for line.
The features and the attack model run on ``device`` (the card unless
``"cpu"`` is given): the attack model's init draws through ``prng``
(T1 and T4 on the card) in the reference's split order, and its 300
full-batch gradient steps run through ``torch.autograd``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .. import prng
from ..data.synthetic import ClassificationData
from ..device import resolve_device

__all__ = ["mia_split", "attack_features", "train_attack_model",
           "attack_auc", "MIASplit"]


@dataclasses.dataclass
class MIASplit:
    shadow_train: np.ndarray
    shadow_out: np.ndarray
    target_train: np.ndarray
    target_out: np.ndarray


def mia_split(n: int, *, seed: int = 0) -> MIASplit:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    shadow, target = idx[:n // 2], idx[n // 2:]
    return MIASplit(shadow_train=shadow[:len(shadow) // 2],
                    shadow_out=shadow[len(shadow) // 2:],
                    target_train=target[:len(target) // 2],
                    target_out=target[len(target) // 2:])


def attack_features(predict_fn: Callable, x: np.ndarray, top_k: int = 3,
                    *, device=None) -> np.ndarray:
    """Top-k softmax probabilities, sorted descending — the attack input.
    ``x`` goes to ``device``, the predictor's (the card unless
    ``"cpu"``); the softmax is f32."""
    dev = resolve_device(device)
    with torch.no_grad():
        logits = predict_fn(torch.as_tensor(np.asarray(x), device=dev))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values[:, :top_k]
    return top.cpu().numpy().astype(np.float32)


def attack_init(d: int, *, hidden: int = 64, seed: int = 0, device=None
                ) -> dict[str, torch.Tensor]:
    """The attack MLP's initial weights, drawn as the reference draws them:
    ``k1, k2 = split(PRNGKey(seed))``, ``w1 = normal(k1, (d, hidden)) *
    (1/sqrt(d))``, ``w2 = normal(k2, (hidden, 2)) * (1/sqrt(hidden))``,
    zero biases; the scales are f32, as JAX's weak-typed constants."""
    dev = resolve_device(device)
    k1, k2 = prng.split(prng.PRNGKey(seed, device=dev))
    return {
        "w1": prng.normal(k1, (d, hidden)) * _f32(1.0 / np.sqrt(d)),
        "b1": torch.zeros((hidden,), dtype=torch.float32, device=dev),
        "w2": prng.normal(k2, (hidden, 2)) * _f32(1.0 / np.sqrt(hidden)),
        "b2": torch.zeros((2,), dtype=torch.float32, device=dev),
    }


def _f32(v: float) -> float:
    return float(np.float32(v))


def _logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def train_attack_model(feats: np.ndarray, labels: np.ndarray, *,
                       hidden: int = 64, steps: int = 300,
                       lr: float = 0.05, seed: int = 0, device=None):
    """MLP with one 64-unit hidden layer + softmax (paper's attack model),
    trained by full-batch gradient descent (``w - lr * g`` in f32) on the
    mean of ``-log_softmax`` at the label. Returns score_fn(feats) ->
    P(member) as numpy."""
    dev = resolve_device(device)
    params = attack_init(feats.shape[1], hidden=hidden, seed=seed,
                         device=dev)
    xf = torch.as_tensor(np.array(feats, np.float32), device=dev)
    yl = torch.as_tensor(labels.astype(np.int64), device=dev)
    lr_f = _f32(lr)
    names = list(params)

    for _ in range(steps):
        p = {n: t.requires_grad_(True) for n, t in params.items()}
        lp = torch.log_softmax(_logits(p, xf), dim=-1)
        loss = -lp.gather(1, yl[:, None]).mean()
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        with torch.no_grad():
            params = {n: p[n].detach() - lr_f * g
                      for n, g in zip(names, grads)}

    def score(f: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            pr = torch.softmax(_logits(params, torch.as_tensor(
                np.array(f, np.float32), device=dev)), dim=-1)
        return pr[:, 1].cpu().numpy()

    return score


def roc_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """AUC via the rank statistic (threshold-sweep ROC area)."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def attack_auc(shadow_predict: Callable, target_predict: Callable,
               data: ClassificationData, split: MIASplit, *,
               seed: int = 0, device=None) -> float:
    """Full pipeline: shadow features -> attack model -> target AUC, on
    ``device`` (the predictors' device)."""
    def feats(fn, idx):
        return attack_features(fn, data.x[idx], device=device)

    f_in = feats(shadow_predict, split.shadow_train)
    f_out = feats(shadow_predict, split.shadow_out)
    feats_ = np.concatenate([f_in, f_out])
    labels = np.concatenate([np.ones(len(f_in)), np.zeros(len(f_out))])
    score = train_attack_model(feats_, labels, seed=seed, device=device)

    t_in = feats(target_predict, split.target_train)
    t_out = feats(target_predict, split.target_out)
    t_feats = np.concatenate([t_in, t_out])
    t_labels = np.concatenate([np.ones(len(t_in)), np.zeros(len(t_out))])
    return roc_auc(score(t_feats), t_labels)
