"""Deterministic synthetic data (numpy; copied from the JAX package's
``data/synthetic.py``): a 10-class Gaussian-mixture "MNIST-like"
(784-dim) or "CIFAR-like" (32x32x3) dataset whose class means are fixed
random directions and whose within-class noise sets the difficulty, a
Markov character stream for the char-LM (``char_stream``), and the
key-derived next-token batches (``lm_round_batches``, keyed on a round;
``lm_client_batches``, keyed on each client's own version), drawn with
``prng`` on the key's device."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng

__all__ = ["classification_dataset", "ClassificationData", "char_stream",
           "lm_round_batches", "lm_client_batches"]


@dataclasses.dataclass
class ClassificationData:
    x: np.ndarray          # [n, ...features]
    y: np.ndarray          # [n] int
    n_classes: int


def classification_dataset(n: int = 12000, *, d: int = 784,
                           n_classes: int = 10, noise: float = 1.2,
                           image: bool = False, img_side: int = 32,
                           seed: int = 0) -> ClassificationData:
    """Gaussian mixture with unit-norm class means scaled to give a
    learnable-but-not-trivial problem (paper-qualitative regime)."""
    rng = np.random.default_rng(seed)
    if image:
        shape = (img_side, img_side, 3)
        d = int(np.prod(shape))
        # low-frequency class templates (4x4 upsampled): spatially
        # coherent, so convolutional models can actually pick them up
        up = img_side // 4
        coarse = rng.normal(size=(n_classes, 4, 4, 3)).astype(np.float32)
        means = np.kron(coarse, np.ones((1, up, up, 1), np.float32))
        means = means.reshape(n_classes, d)
    else:
        means = rng.normal(size=(n_classes, d)).astype(np.float32)
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    means *= 4.0
    y = rng.integers(0, n_classes, size=n)
    x = means[y] + noise * rng.normal(size=(n, d)).astype(np.float32)
    if image:
        x = x.reshape(n, *shape)
    else:
        x = x.astype(np.float32)
    return ClassificationData(x=x, y=y.astype(np.int64),
                              n_classes=n_classes)


def char_stream(n_chars: int = 200_000, *, vocab: int = 90, order: float = 4.0,
                bias_seed: int | None = None, seed: int = 0) -> np.ndarray:
    """Markov chain over ``vocab`` symbols. ``bias_seed`` perturbs the
    transition matrix -> per-client distribution shift (non-IID)."""
    rng = np.random.default_rng(seed)
    # sharpen the transition rows (temperature 1/order) => low-entropy,
    # learnable stream; order=1 is near-uniform
    base = rng.dirichlet(np.full(vocab, 0.5), size=vocab) ** order
    if bias_seed is not None:
        brng = np.random.default_rng(bias_seed)
        base = base * brng.dirichlet(np.full(vocab, 2.0), size=vocab)
    base /= base.sum(axis=1, keepdims=True)
    out = np.empty(n_chars, dtype=np.int32)
    s = int(rng.integers(vocab))
    cum = np.cumsum(base, axis=1)
    u = rng.random(n_chars)
    for i in range(n_chars):
        s = int(np.searchsorted(cum[s], u[i]))
        s = min(s, vocab - 1)
        out[i] = s
    return out


def _tokens(start: torch.Tensor, seq: int, vocab: int) -> dict:
    """Tokens and targets of the sequences ``t+1 = (t*5 + c) % vocab``
    from their first tokens ``start`` [..., 1] (int32)."""
    ar = torch.arange(seq + 1, dtype=torch.int32, device=start.device)
    tokens = (start + 5 * ar) % vocab
    return {"tokens": tokens[..., :seq].contiguous(),
            "targets": tokens[..., 1:].contiguous()}


def lm_round_batches(key: torch.Tensor, round_idx: int, *, m: int, K: int,
                     batch: int, seq: int, vocab: int) -> dict:
    """Synthetic next-token batches [m, K, batch, seq] (int32) for one
    round, deterministic in (key, round_idx): ``randint(fold_in(key,
    round_idx), (m, K, batch, 1), 0, vocab)`` starts each sequence, as in
    the JAX package, on the key's device."""
    k = prng.fold_in(key, round_idx)
    return _tokens(prng.randint(k, (m, K, batch, 1), 0, vocab), seq, vocab)


def lm_client_batches(key: torch.Tensor, client_ids, versions, *, K: int,
                      batch: int, seq: int, vocab: int) -> dict:
    """Per-client next-token batches [n, K, batch, seq] (int32), batch
    ``i`` a pure function of ``(key, client_ids[i], versions[i])``: the
    key ``fold_in(fold_in(key, client_ids[i]), versions[i])`` draws
    ``randint(.., (K, batch, 1), 0, vocab)``, the JAX package's ``vmap``
    over the clients. A client's stream advances only when its own version
    does, so its data does not depend on how events interleave across the
    fleet. ``client_ids`` and ``versions`` are int tensors [n] (or
    sequences) taken to the key's device; two T1 launches fold them in,
    one for the ids and one for the versions, then ``randint``."""
    dev = key.device
    ids = torch.as_tensor(client_ids).to(device=dev, dtype=torch.int64)
    ver = torch.as_tensor(versions).to(device=dev, dtype=torch.int64)
    keys = prng.fold_in(prng.fold_in(key, ids), ver)
    return _tokens(prng.randint(keys, (K, batch, 1), 0, vocab), seq, vocab)
