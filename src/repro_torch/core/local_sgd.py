"""Local training: K steps of SGD with heavy-ball momentum (paper eq. 4),
batched over the client axis.

  v_0 = 0;  v_{k+1} = theta * v_k - eta * g_k;  y_{k+1} = y_k + v_{k+1}

The momentum buffer restarts at the beginning of every communication
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

__all__ = ["local_train", "heavy_ball_update"]


def heavy_ball_update(y: Params, v: Params, g: Params, eta: float,
                      theta: float) -> tuple[Params, Params]:
    """One heavy-ball step on a parameter dict. Returns (y_next, v_next)."""
    return momentum_update(y, v, g, eta, theta)


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
    step_keys = prng.split(keys, K)                         # [m, K, 2]
    y = {n: t.detach() for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in y.items()}
    losses = []
    for k in range(K):
        yk = {n: t.requires_grad_(True) for n, t in y.items()}
        batch = {n: b[:, k] for n, b in batches.items()}
        loss = loss_fn(yk, batch, step_keys[:, k])
        grads = torch.autograd.grad(loss.sum(), list(yk.values()))
        g = {n: gr.contiguous() for n, gr in zip(yk, grads)}
        y, v = heavy_ball_update({n: t.detach() for n, t in yk.items()}, v,
                                 g, eta, theta)
        losses.append(loss.detach())
    return y, torch.stack(losses, dim=1).mean(dim=1)
