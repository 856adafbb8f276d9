"""Quantized DFedAvgM (the paper's Algorithm 2 in its Lemma-5 form) as
its description runs it, one client at a time.

A round from the held state x (every client's parameters, stacked on a
leading client axis, stored in the configuration's dtypes) and a key:

1. ``key_round, key_mix, key_next = split(key, 3)``.
2. Every client runs K heavy-ball steps from v = 0 on its K minibatches:
   ``v' = theta v - eta g`` and ``y' = y + v'`` in float32 (eta and theta
   as float32), each stored back in its leaf's dtype (y' adds the
   unrounded v'); g is the gradient of the client's mean next-token
   cross-entropy, computed in float32 from the stored values. The round's
   loss is the clients' mean of their K steps' mean loss.
3. Every client sends ``Q(z - x)`` per leaf: the difference taken in the
   leaf's dtype, then in float32; the step ``s = max|delta| * f32(1 /
   qmax)`` (1 where that is 0); the level ``floor(delta / s)``, plus one
   where the noise ``u`` lies below the remainder, clamped to [qmin,
   qmax]. Leaf ``l`` (in sorted-name order) of client ``c`` draws
   ``u = uniform(keys[l, c], n_l)`` over its flat elements, ``keys =
   split(key_mix, n_leaves * m)`` laid out [n_leaves, m].
4. ``x'_c = sum_j W[c, j] (x_j + q_j)``, accumulated in float32 (the held
   states first, then the received deltas, each in the order own client
   first), stored in the leaf's dtype.

Variants for the checks of the comparison: ``precision="fp8"`` (the
control), ``half_batch`` (a fault: each loss over the first half of its
batch's rows, or of its tokens for a batch of one row) and
``no_exchange`` (a fault: W = I, no client hears another).
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry
from .precision import PRECISIONS


def _f32(v: float) -> float:
    return float(np.float32(v))


def _half(t: torch.Tensor) -> torch.Tensor:
    """The first half of a batch [b, l]: its rows, or for one row its
    tokens."""
    b, l = t.shape
    return t[:b // 2] if b > 1 else t[:, :l // 2]


def ring(m: int, self_weight: float) -> np.ndarray:
    """The ring's mixing matrix: ``self_weight`` on the diagonal, the rest
    shared by the two neighbours (by the one, for m = 2)."""
    W = np.eye(m) * self_weight
    for c in range(m):
        for j in {(c - 1) % m, (c + 1) % m} - {c}:
            W[c, j] += (1 - self_weight) / (1 if m == 2 else 2)
    return W


def norms(new: dict, old: dict) -> dict:
    """Each leaf's norms (float64) of ``new - old``, one a client: leaf ->
    [m floats]."""
    out = {}
    for n in sorted(new):
        t = (new[n].detach().float() - old[n].float()).flatten(1)
        out[n] = torch.linalg.vector_norm(t, dim=1,
                                          dtype=torch.float64).tolist()
    return out


def local_steps(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
                loss_of, eta: float, theta: float, half: bool):
    """K heavy-ball steps of one client (``tokens`` [K, b, l]). Returns
    (y_K, the steps' mean loss, the first step's gradient)."""
    eta, theta = _f32(eta), _f32(theta)
    y = {n: t.clone() for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, first = [], None
    for k in range(tokens.shape[0]):
        p = {n: t.float().requires_grad_(True) for n, t in y.items()}
        tk, gk = tokens[k], targets[k]
        if half:
            tk, gk = _half(tk), _half(gk)
        loss = loss_of(p, tk, gk)
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True,
                                    materialize_grads=True)
        if first is None:
            first = dict(zip(p, grads))
        for n, g in zip(p, grads):
            vn = theta * v[n].float() - eta * g
            y[n] = (y[n].float() + vn).to(y[n].dtype)
            v[n] = vn.to(v[n].dtype)
        losses.append(loss.detach())
    return y, torch.stack(losses).mean(), first


def one_round(x: dict, batch: dict, key: torch.Tensor, *, family, cfg: dict,
              eta: float, theta: float, W: np.ndarray, bits: int,
              precision: str = "f32", half_batch: bool = False,
              no_exchange: bool = False):
    """One round (module docstring). ``batch``: tokens and targets [m, K,
    b, l]. Returns (x', loss, key', squared norms of the clients' first
    gradients a leaf)."""
    prec = PRECISIONS[precision]
    names = sorted(x)
    m = x[names[0]].shape[0]
    W = np.eye(m, dtype=np.float32) if no_exchange else np.asarray(
        W, np.float32)
    key_round, key_mix, key_next = threefry.split(key, 3)
    del key_round     # the loss draws no randomness

    def loss_of(p, t, g):
        return family.loss(p, t, g, cfg, prec)

    z = {n: torch.empty_like(x[n]) for n in names}
    grad_sq = {n: 0.0 for n in names}
    losses = []
    for c in range(m):
        yc, lc, g0 = local_steps({n: x[n][c] for n in names},
                                 batch["tokens"][c], batch["targets"][c],
                                 loss_of, eta, theta, half_batch)
        for n in names:
            z[n][c] = yc[n]
            grad_sq[n] += float(torch.linalg.vector_norm(
                g0[n], dtype=torch.float64)) ** 2
        losses.append(lc)
        del yc, g0

    qmax, qmin = 2 ** (bits - 1) - 1, -2 ** (bits - 1)
    inv = _f32(1.0 / np.float32(qmax))
    keys = threefry.split(key_mix, len(names) * m).reshape(len(names), m, 2)
    x_next = {}
    for li, n in enumerate(names):
        delta = (z[n] - x[n]).float().reshape(m, -1)
        s = delta.abs().amax(dim=1) * inv
        s = torch.where(s > 0, s, torch.ones_like(s))
        q = torch.empty_like(delta)
        for c in range(m):
            u = threefry.uniform(keys[li, c], delta.shape[1])
            a = delta[c] / s[c]
            lev = torch.floor(a)
            lev = lev + (u < a - lev).float()
            q[c] = lev.clamp(qmin, qmax) * s[c]
            del u, a, lev
        held = x[n].float().reshape(m, -1)
        out = torch.empty_like(held)
        for c in range(m):
            srcs = [c] + [j for j in range(m) if j != c and W[c, j] != 0]
            acc = float(W[c, c]) * held[c]
            for j in srcs[1:]:
                acc = acc + float(W[c, j]) * held[j]
            for j in srcs:
                acc = acc + float(W[c, j]) * q[j]
            out[c] = acc
        x_next[n] = out.reshape(x[n].shape).to(x[n].dtype)
        del delta, q, held, out
    return x_next, torch.stack(losses).mean(), key_next, grad_sq


def rounds(x0: dict, batches: list, key: torch.Tensor, **kw) -> dict:
    """The rounds of ``batches`` from ``x0`` under ``key`` (keyword
    arguments: :func:`one_round`'s). Returns each round's loss, each
    leaf's norm of the first gradients (round 1, step 1, every client),
    and its norms a client (:func:`norms`) of the first round's change and
    of the change over all the rounds."""
    with _no_tf32():
        x, losses, first, update1 = x0, [], None, None
        for t, batch in enumerate(batches):
            x_new, loss, key, grad_sq = one_round(x, batch, key, **kw)
            if t == 0:
                first = {n: g ** 0.5 for n, g in grad_sq.items()}
                update1 = norms(x_new, x0)
            if x is not x0:
                del x
            x = x_new
            losses.append(float(loss))
        return {"losses": losses, "grad_norms": first, "update1": update1,
                "change": norms(x, x0)}


class _no_tf32:
    """TF32 off for the reference's float32 products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
