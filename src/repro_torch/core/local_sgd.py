"""Local training: K steps of SGD with heavy-ball momentum (paper eq. 4),
batched over the client axis.

  v_0 = 0;  v_{k+1} = theta * v_k - eta * g_k;  y_{k+1} = y_k + v_{k+1}

The momentum buffer restarts at the beginning of every communication
round. ``local_train_deferred`` stops one update short for the fused
round. The JAX package vmaps one client's scan over the client axis; here
the client axis is a batch dimension and the K steps are a Python loop.
Each step sums the m per-client mean losses before ``backward``, so every
client gets exactly its own gradient. The update goes through
``kernels.momentum_update`` — B3 on CUDA tensors, its plain version on
CPU tensors.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import prng
from ..kernels.ops import momentum_update

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]  # (params, batch, rng [m, 2]) -> [m]

__all__ = ["local_train", "local_train_deferred", "heavy_ball_update",
           "loss_and_grad"]


def heavy_ball_update(y: Params, v: Params, g: Params, eta: float,
                      theta: float) -> tuple[Params, Params]:
    """One heavy-ball step on a parameter dict. Returns (y_next, v_next)."""
    return momentum_update(y, v, g, eta, theta)


def loss_and_grad(loss_fn: LossFn, params: Params, batch: Params,
                  keys: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """Per-client losses [m] at ``params`` and each client's gradient:
    one backward of the summed losses (clients do not interact)."""
    p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    loss = loss_fn(p, batch, keys)
    grads = torch.autograd.grad(loss.sum(), list(p.values()))
    return loss.detach(), {n: gr.contiguous() for n, gr in zip(p, grads)}


def _steps(loss_fn: LossFn, params: Params, batches: Params,
           step_keys: torch.Tensor, n_steps: int, eta: float, theta: float
           ) -> tuple[Params, Params, list]:
    """The first ``n_steps`` heavy-ball steps from v = 0."""
    y = {n: t.detach() for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in y.items()}
    losses = []
    for k in range(n_steps):
        loss, g = loss_and_grad(loss_fn, y, {n: b[:, k] for n, b in
                                             batches.items()},
                                step_keys[:, k])
        y, v = heavy_ball_update(y, v, g, eta, theta)
        losses.append(loss)
    return y, v, losses


def local_train(loss_fn: LossFn, params: Params, batches: Params,
                keys: torch.Tensor, *, eta: float, theta: float
                ) -> tuple[Params, torch.Tensor]:
    """Run K heavy-ball SGD steps on every client.

    Args:
      loss_fn: (params [m, ...], batch [m, ...], rng [m, 2]) -> per-client
               losses [m].
      params:  stacked client parameters x^t, leaves [m, ...].
      batches: dict whose leaves are [m, K, ...] — one minibatch per
               client per local step.
      keys:    client PRNG keys [m, 2]; step k of client c gets
               ``split(keys[c], K)[k]``, as in the JAX package.
      eta, theta: learning rate and momentum of eq. (4).

    Returns:
      (y^{t,K} stacked, per-client mean local loss over the K steps [m]).
    """
    K = next(iter(batches.values())).shape[1]
    y, _, losses = _steps(loss_fn, params, batches, prng.split(keys, K), K,
                          eta, theta)
    return y, torch.stack(losses, dim=1).mean(dim=1)


def local_train_deferred(loss_fn: LossFn, params: Params, batches: Params,
                         step_keys: torch.Tensor, *, eta: float, theta: float
                         ) -> tuple[Params, Params, Params, torch.Tensor]:
    """Fused-round variant of :func:`local_train`: stop BEFORE applying
    step K-2's update, returning the raw material of the last two steps
    for the fused tail (``core.mixing.make_fused_tail``):

      * steps ``0 .. K-3`` run exactly as in :func:`local_train` (same
        batches; ``step_keys`` [m, K, 2] is ``split(keys, K)`` of the
        client keys, which the fused round splits once and whose step K-1
        key it keeps for its tail);
      * step ``K-2``'s loss and gradient are computed, its update is not
        applied (B4 folds it into the wire encode);
      * step ``K-1`` is left to the caller.

    Needs K >= 2. Returns ``(y_{K-2}, v_{K-2}, g_{K-2}, losses [m, K-1])``
    with the per-step losses of steps ``0 .. K-2``.
    """
    K = next(iter(batches.values())).shape[1]
    if K < 2:
        raise ValueError(f"deferred local training needs K >= 2, got {K}")
    y, v, losses = _steps(loss_fn, params, batches, step_keys, K - 2, eta,
                          theta)
    loss, g = loss_and_grad(loss_fn, y, {n: b[:, K - 2] for n, b in
                                         batches.items()},
                            step_keys[:, K - 2])
    losses.append(loss)
    return y, v, g, torch.stack(losses, dim=1)
