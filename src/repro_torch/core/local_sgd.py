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

On a 2D ``(clients, model)`` mesh, ``local_train(..., group=)`` trains
one shard's row of cells tensor-parallel: each step is one
``autograd.grad`` of the loss's column-parallel form
(``sharding.tensor_parallel``) over every cell's leaves, a replicated
leaf takes column 0's gradient on every column (so its copies stay
bitwise equal, which the 2D mixer relies on), and B3 runs once a cell on
the cell's device.
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import prng
from ..kernels.ops import momentum_update
from ..launch.cost_model import repeats_on_meta
from ..sharding.tensor_parallel import ColumnGroup

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]  # (params, batch, rng [m, 2]) -> [m]

__all__ = ["local_train", "local_train_deferred", "heavy_ball_update",
           "loss_and_grad", "loss_and_grad_columns"]


def heavy_ball_update(y: Params, v: Params, g: Params,
                      eta: float | torch.Tensor,
                      theta: float) -> tuple[Params, Params]:
    """One heavy-ball step on a parameter dict (``eta`` a float, or f32
    [m] on the device, one a client). Returns (y_next, v_next)."""
    return momentum_update(y, v, g, eta, theta)


def _twice(x):
    """Every leaf of a dict, or a tensor (None stays None), with its lane
    axis doubled: a lone lane run as two (:func:`loss_and_grad`)."""
    if isinstance(x, dict):
        return {n: torch.cat([t, t]) for n, t in x.items()}
    return None if x is None else torch.cat([x, x])


def loss_and_grad(loss_fn: LossFn, params: Params, batch: Params,
                  keys: torch.Tensor) -> tuple[torch.Tensor, Params]:
    """Per-client losses [m] at ``params`` and each client's gradient:
    one backward of the summed losses (clients do not interact).

    One client is run as two (the second a copy whose results are
    dropped): cuBLAS takes another algorithm for a batched product of
    batch count 1 than for 2 or more (a split of the inner dimension), so
    a lone lane (``ready_capacity=1``, a cohort of one) would part from
    the same lane trained beside others."""
    lone = next(iter(params.values())).shape[0] == 1
    if lone:
        params, batch, keys = _twice(params), _twice(batch), _twice(keys)
    p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
    loss = loss_fn(p, batch, keys)
    # A leaf the loss does not reach (a model's encoder when the batch
    # carries no frontend) gets a zero gradient, as under jax.grad.
    grads = torch.autograd.grad(loss.sum(), list(p.values()),
                                allow_unused=True, materialize_grads=True)
    if lone:
        loss, grads = loss[:1], [gr[:1] for gr in grads]
    return loss.detach(), {n: gr.contiguous() for n, gr in zip(p, grads)}


def loss_and_grad_columns(group: ColumnGroup, loss_fn: LossFn,
                          cells: list[Params], batch: Params,
                          keys: torch.Tensor
                          ) -> tuple[torch.Tensor, list[Params]]:
    """:func:`loss_and_grad` of one shard's row of cells (``group``'s
    columns) through ``loss_fn.column_parallel``: the losses [m_local]
    on the group's home and each cell's gradients, from one
    ``autograd.grad`` over column 0's leaves and every cut leaf. A
    replicated leaf's gradient is column 0's, copied to each column (the
    copies are not read by the form). A lone lane runs as two.

    The backward runs on the calling thread alone: with the columns on
    several cards the autograd engine would otherwise run each card's
    nodes on a thread of its own, and two of them may unpack a
    recomputed (``cfg.remat``) block's saved tensors at once, each
    starting the block's recomputation (``torch.utils.checkpoint`` takes
    no lock), which it then refuses as a mismatch."""
    lone = next(iter(cells[0].values())).shape[0] == 1
    if lone:
        cells = [_twice(c) for c in cells]
        batch, keys = _twice(batch), _twice(keys)
    p = [{n: t.detach().requires_grad_(True) for n, t in cell.items()
          if c == 0 or group.dims.get(n) is not None}
         for c, cell in enumerate(cells)]
    loss = loss_fn.column_parallel.fn(group, group.view(p), batch, keys)
    leaves = [t for cell in p for t in cell.values()]
    with torch.autograd.set_multithreading_enabled(False):
        flat = iter(torch.autograd.grad(loss.sum(), leaves,
                                        allow_unused=True,
                                        materialize_grads=True))
    got = [{n: next(flat) for n in cell} for cell in p]
    grads = [{n: (got[c][n] if n in got[c] else got[0][n].to(d))
              for n in cell}
             for c, (cell, d) in enumerate(zip(cells, group.devices))]
    if lone:
        loss = loss[:1]
        grads = [{n: gr[:1] for n, gr in g.items()} for g in grads]
    return loss.detach(), [{n: gr.contiguous() for n, gr in g.items()}
                           for g in grads]


def _on(eta: float | torch.Tensor, dev: torch.device):
    return eta.to(dev) if isinstance(eta, torch.Tensor) else eta


def _steps(loss_fn: LossFn, params: Params | list[Params],
           batches: Params, step_keys: torch.Tensor, n_steps: int,
           eta: float | torch.Tensor, theta: float,
           group: ColumnGroup | None = None) -> tuple:
    """The first ``n_steps`` heavy-ball steps from v = 0 (on a row of
    cells with ``group``: one update a cell)."""
    cells = [params] if group is None else params
    y = [{n: t.detach() for n, t in c.items()} for c in cells]
    v = [{n: torch.zeros_like(t) for n, t in c.items()} for c in y]
    etas = ([eta] if group is None else
            [_on(eta, d) for d in group.devices])
    losses = []
    for k in range(n_steps):
        batch = {n: b[:, k] for n, b in batches.items()}
        if group is None:
            loss, g = loss_and_grad(loss_fn, y[0], batch, step_keys[:, k])
            g = [g]
        else:
            loss, g = loss_and_grad_columns(group, loss_fn, y, batch,
                                            step_keys[:, k])
        yv = [heavy_ball_update(*a, theta) for a in zip(y, v, g, etas)]
        y, v = [a for a, _ in yv], [b for _, b in yv]
        losses.append(loss)
    if group is None:
        return y[0], v[0], losses
    return y, v, losses


@repeats_on_meta
def local_train(loss_fn: LossFn, params: Params | list[Params],
                batches: Params, keys: torch.Tensor, *,
                eta: float | torch.Tensor, theta: float,
                group: ColumnGroup | None = None
                ) -> tuple[Params | list[Params], torch.Tensor]:
    """Run K heavy-ball SGD steps on every client.

    Args:
      loss_fn: (params [m, ...], batch [m, ...], rng [m, 2]) -> per-client
               losses [m].
      params:  stacked client parameters x^t, leaves [m, ...].
      batches: dict whose leaves are [m, K, ...] — one minibatch per
               client per local step.
      keys:    client PRNG keys [m, 2]; step k of client c gets
               ``split(keys[c], K)[k]``, as in the JAX package.
      eta, theta: learning rate and momentum of eq. (4); ``eta`` may be
               an f32 tensor [m] on the parameters' device, one a client
               (the async engine's staleness-decayed rate).
      group:   a 2D mesh shard's :class:`ColumnGroup`: ``params`` is then
               the shard's row of cells (batches, keys and a tensor eta
               on the group's home) and the step is tensor-parallel
               through ``loss_fn.column_parallel``.

    Returns:
      (y^{t,K} stacked — the row of cells with ``group`` — per-client
      mean local loss over the K steps [m]).
    """
    K = next(iter(batches.values())).shape[1]
    y, _, losses = _steps(loss_fn, params, batches, prng.split(keys, K), K,
                          eta, theta, group)
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
