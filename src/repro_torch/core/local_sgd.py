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

On a ``launch.mesh.ServeMesh`` of ``("data", "model")`` cells (the
reference's strategies B, B2 and B3, whose specs cut weights over the
data axis too), :func:`local_train_rows` trains every cell: each data
row is a column group that reads its weights' data-cut blocks as
``DataCut`` gathers (``sharding.tensor_parallel.gather_data``) and
computes its loss on its batch block (B2, B3) or on the whole batch
(B). Each row runs its own backward (rows share no activation; one
backward a row bounds the live activations to one row's and lets a
count on ``meta`` replay a row); the rows' gradients then meet in
data-row order (:func:`_reduce_rows`): with a cut batch a data-cut
block sums every row's slice of it (a reduce-scatter) and any other
block every row's gradient of it (an all-reduce over the data column,
the same value on every row's cell); with the whole batch on every row a
data-cut block keeps its own row's slice and any other block row 0's
gradient, so the replicated blocks stay bitwise equal. Each row's loss
is weighted by its share of the batch's tokens in the backward (1/dp
without a mask), so no gradient is counted twice. B3 then runs once a
cell. A leaf the loss's form reads as a column's contiguous channels
(an SSM's inner dim) but whose dim the specs cut over ``("data",
"model")`` is gathered from the cells that hold its column's channels
(``ServeMesh.row_cells(..., heads=)``) and its gradient returned to
them. A MoE that the reference routes as one group over a cut batch
routes every row first, in batch order (``routing``), so that each
row's forward and backward reads the whole batch's expert counts. On
the pod mesh ``("pod", "data", "model")`` every pod trains its own
clients on its ``("data", "model")`` cells (``ServeMesh.pod``); nothing
crosses pods.
:func:`local_train_rows` can stop as :func:`local_train_deferred` does,
and :func:`rows_loss_and_grad` gives one step's gradient on the rows
(the fused round's head and last gradient on cells).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import prng
from ..kernels.ops import momentum_update
from ..launch import hlo_stats
from ..launch.cost_model import repeats_on_meta, uncounted
from ..sharding.rules import cuts_data, model_sharded_dims, pod_specs
from ..sharding.tensor_parallel import ColumnGroup, DataCut, ordered_sum

Params = dict[str, torch.Tensor]
LossFn = Callable[..., torch.Tensor]  # (params, batch, rng [m, 2]) -> [m]

__all__ = ["local_train", "local_train_deferred", "local_train_rows",
           "rows_loss_and_grad", "heavy_ball_update", "loss_and_grad",
           "loss_and_grad_columns"]


def heavy_ball_update(y: Params, v: Params, g: Params,
                      eta: float | torch.Tensor,
                      theta: float) -> tuple[Params, Params]:
    """One heavy-ball step on a parameter dict (``eta`` a float, or f32
    [m] on the device, one a client). Returns (y_next, v_next)."""
    return momentum_update(y, v, g, eta, theta)


def _twice(x):
    """Every leaf of a dict (a data-cut one block by block), or a tensor
    (None stays None), with its lane axis doubled: a lone lane run as
    two (:func:`loss_and_grad`)."""
    if isinstance(x, dict):
        return {n: _twice(t) for n, t in x.items()}
    if isinstance(x, DataCut):
        return x.with_parts([torch.cat([t, t]) for t in x.parts])
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


def _leaf(x):
    """A cell's entry as the backward's leaf: a tensor, or a
    ``DataCut`` whose own block alone (every row computing the whole
    batch) or every block (each row its own batch block) needs a
    gradient."""
    if isinstance(x, DataCut):
        return x.with_parts([
            t.detach().requires_grad_(x.own is None or i == x.own)
            for i, t in enumerate(x.parts)])
    return x.detach().requires_grad_(True)


def _needing(x) -> list:
    if isinstance(x, DataCut):
        return [t for t in x.parts if t.requires_grad]
    return [x]


def _grad_of(x, flat):
    """The gradient of one entry from the backward's ``flat`` results (a
    leaf the loss does not reach gets zeros, as under ``jax.grad``): a
    tensor, a ``DataCut``'s own block's, or its blocks' list."""
    def one(t):
        g = next(flat)
        return torch.zeros_like(t) if g is None else g
    if not isinstance(x, DataCut):
        return one(x)
    if x.own is not None:
        return one(x.parts[x.own])
    return [one(t) for t in x.parts]


def _copy_to(g, entry):
    """A replicated leaf's gradient (column 0's) on another column's
    entry's devices."""
    if isinstance(g, list):
        return [gi.to(t.device) for gi, t in zip(g, entry.parts)]
    t = entry if not isinstance(entry, DataCut) else entry.parts[entry.own]
    return g.to(t.device)


def _each(fn, g):
    return [fn(t) for t in g] if isinstance(g, list) else fn(g)


def loss_and_grad_columns(group: ColumnGroup, loss_fn: LossFn,
                          cells: list[Params], batch: Params,
                          keys: torch.Tensor, weight=None,
                          pair_lone: bool = True
                          ) -> tuple[torch.Tensor, list[Params]]:
    """:func:`loss_and_grad` of a row of cells (``group``'s columns)
    through ``loss_fn.column_parallel``: the losses [m_local] on the
    group's home and each cell's gradients, from one ``autograd.grad``
    over column 0's leaves and every cut leaf. A replicated leaf's
    gradient is column 0's, copied to each column (the copies are not
    read by the form). A lone lane runs as two unless ``pair_lone`` is
    False (a pod's one client, held against the reference within
    tolerance, not bitwise against a batch of two: its pair would double
    the pod's work).

    An entry may be a ``DataCut`` (a row of a ``launch.mesh.ServeMesh``,
    :func:`local_train_rows`): its gradient is its own block's where its
    ``own`` is set, else the list of every block's, each on its block's
    device. ``weight`` (a float, or [m_local] on the home) scales each
    client's loss in the backward; the losses return unscaled.

    The backward runs on the calling thread alone: with the columns on
    several cards the autograd engine would otherwise run each card's
    nodes on a thread of its own, and two of them may unpack a
    recomputed (``cfg.remat``) block's saved tensors at once, each
    starting the block's recomputation (``torch.utils.checkpoint`` takes
    no lock), which it then refuses as a mismatch."""
    first = next(iter(cells[0].values()))
    lanes = (first.parts[0] if isinstance(first, DataCut) else first).shape[0]
    lone = lanes == 1 and pair_lone
    if lone:
        cells = [_twice(c) for c in cells]
        batch, keys = _twice(batch), _twice(keys)
        if isinstance(weight, torch.Tensor):
            weight = _twice(weight)
    p = [{n: _leaf(t) for n, t in cell.items()
          if c == 0 or group.dims.get(n) is not None}
         for c, cell in enumerate(cells)]
    loss = loss_fn.column_parallel.fn(group, group.view(p), batch, keys)
    seed = loss if weight is None else loss * weight
    leaves = [t for cell in p for x in cell.values() for t in _needing(x)]
    with torch.autograd.set_multithreading_enabled(False):
        flat = iter(torch.autograd.grad(seed.sum(), leaves,
                                        allow_unused=True))
    got = [{n: _grad_of(x, flat) for n, x in cell.items()} for cell in p]
    grads = [{n: (got[c][n] if n in got[c] else _copy_to(got[0][n], t))
              for n, t in cell.items()}
             for c, cell in enumerate(cells)]
    if lone:
        loss = loss[:1]
        grads = [{n: _each(lambda t: t[:1], gr) for n, gr in g.items()}
                 for g in grads]
    return loss.detach(), [{n: _each(lambda t: t.contiguous(), gr)
                            for n, gr in g.items()} for g in grads]


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@repeats_on_meta
def _row_loss_and_grad(group, loss_fn, entries, batch, keys, weight):
    """One mesh row's losses and gradients (a function of its arguments'
    shapes alone on ``meta``, so a count replays the rows after the
    first); a lone lane runs alone."""
    return loss_and_grad_columns(group, loss_fn, entries, batch, keys,
                                 weight=weight, pair_lone=False)


def _row_weights(batches: Params, slices: list, scatter: bool) -> list:
    """Each row's share of a client's loss in the backward, one a local
    step: 1 with the whole batch on every row; with a cut batch the
    share of the batch's tokens its block holds, 1/dp without a mask
    (``[m, K]`` on the mask's device with one)."""
    if not scatter:
        return [1.0] * len(slices)
    mask = batches.get("mask")
    if mask is None:
        return [1.0 / len(slices)] * len(slices)
    dims = tuple(range(2, mask.dim()))
    total = torch.clamp(mask.sum(dim=dims), min=1).to(torch.float32)
    return [mask[:, :, sl].sum(dim=dims).to(torch.float32) / total
            for sl in slices]


def _reduce_rows(mesh, rows: list, per_row: list, specs: dict,
                 scatter: bool, weights: list, k: int,
                 heads: frozenset = frozenset()
                 ) -> tuple[torch.Tensor, list[Params]]:
    """The rows' (losses, column gradients) of one local step -> the
    clients' losses [m] on the first cell's device and every cell's
    gradients, in the module docstring's order; records the data
    column's all-reduces (the reduce-scatters record themselves in the
    gathers' backward) and B's row-0 broadcasts. A leaf of ``heads``
    (re-cut to contiguous channels, ``ServeMesh.row_cells``) finds cell
    ``(r, c)``'s block as part ``i`` of column ``c'``'s entry, ``(c',
    i) = divmod(r * mp + c, dp)``: every row's slice summed under a cut
    batch, row r's own otherwise."""
    home = mesh.devices.flat[0]
    dp, mp = len(rows), mesh.model_parallel
    if scatter:
        loss = None
        for (ls, _), w in zip(per_row, weights):
            w = w[:, k].to(home) if isinstance(w, torch.Tensor) else w
            part = ls.to(home) * w
            loss = part if loss is None else loss + part
    else:
        loss = per_row[0][0].to(home)
    data_cut = {n: cuts_data(specs[n]) for n in per_row[0][1][0]}
    summed: dict = {}
    out = []
    for coord, dev in np.ndenumerate(mesh.devices):
        r, c = rows.index(coord[:-1]), coord[-1]
        cell = {}
        for n, cut in data_cut.items():
            g = per_row[r][1][c][n]
            if n in heads:                # a block of another column
                cc, i = divmod(r * mp + c, dp)
                cell[n] = (ordered_sum([q[1][cc][n][i] for q in per_row],
                                       dev) if scatter
                           else per_row[r][1][cc][n][i].to(dev))
            elif cut and scatter:         # reduce-scatter: block r's sum
                cell[n] = ordered_sum([q[1][c][n][r] for q in per_row],
                                       dev)
            elif cut:                     # the row's own slice
                cell[n] = g
            elif scatter:                 # all-reduce over the data column
                if (c, n) not in summed:
                    parts = [q[1][c][n] for q in per_row]
                    hlo_stats.record("all-reduce", _nbytes(parts[0]), dp)
                    summed[c, n] = ordered_sum(parts, parts[0].device)
                cell[n] = summed[c, n].to(dev)
            else:                         # row 0's, on every row
                if r:
                    hlo_stats.record("collective-permute", _nbytes(g), dp)
                cell[n] = per_row[0][1][c][n].to(dev)
        out.append(cell)
    return loss, out


@repeats_on_meta
def _row_route(group, loss_fn, entries, batch, keys):
    """One mesh row's forward alone, without a gradient: the pass that
    routes every row's tokens (``routing``, :func:`local_train_rows`)
    before any row's backward. Returns its losses."""
    with torch.no_grad():
        return loss_fn.column_parallel.fn(group, group.view(entries), batch,
                                          keys)


class _PodRows:
    """One pod's rows for :func:`local_train_rows`: its ``("data",
    "model")`` mesh, specs, column groups, batch blocks, the leaves its
    loss's form reads as contiguous channels and its routing."""

    def __init__(self, loss_fn: LossFn, mesh, specs: dict,
                 batch_axes: tuple, b: int, routing=None):
        self.mesh, self.specs, self.routing = mesh, specs, routing
        dims = model_sharded_dims(specs, "model")
        form = loss_fn.column_parallel
        declined = [n for n, d in dims.items() if d is not None
                    and not form.covers(n, dims)]
        if declined:
            raise ValueError(f"the loss's column-parallel form declines "
                             f"{len(declined)} cut leaves, e.g. "
                             f"{declined[0]}")
        self.heads = frozenset(
            n for n, spec in specs.items() if form.heads(n) and any(
                {"data", "model"} <= set(spec.names(i))
                for i in range(len(spec))))
        self.rows = mesh.rows()
        self.groups = [mesh.row_group(r, dims) for r in self.rows]
        self.scatter = bool(batch_axes)
        self.slices = [mesh.batch_rows(r, tuple(batch_axes), b)
                       for r in self.rows]

    def step(self, loss_fn: LossFn, y: list[Params], batches: Params,
             step_keys: torch.Tensor, k: int
             ) -> tuple[torch.Tensor, list[Params]]:
        """Local step ``k``'s losses [m] and every cell's gradient at
        ``y``."""
        weights = _row_weights(batches, self.slices, self.scatter)
        args = []
        for row, group, sl, w in zip(self.rows, self.groups, self.slices,
                                     weights):
            with uncounted():
                batch = {n: t[:, k, sl].to(group.home)
                         for n, t in batches.items()}
                kk = step_keys[:, k].to(group.home)
                w = w[:, k].to(group.home) if isinstance(
                    w, torch.Tensor) else w
            entries = self.mesh.row_cells(y, self.specs, row,
                                          scatter=self.scatter,
                                          heads=self.heads)
            args.append((group, loss_fn, entries, batch, kk, w))
        if self.routing is None:
            per_row = [_row_loss_and_grad(*a) for a in args]
        else:
            # One routing group over the rows' blocks: every row routes
            # (a forward, in batch order) before any row's backward.
            starts = sorted(sl.start for sl in self.slices)
            blocks = [starts.index(sl.start) for sl in self.slices]
            with self.routing(len(starts)) as route:
                for blk, a in sorted(zip(blocks, args), key=lambda v: v[0]):
                    route.enter(blk)
                    _row_route(*a[:5])
                per_row = []
                for blk, a in zip(blocks, args):
                    route.enter(blk)
                    per_row.append(_row_loss_and_grad(*a))
        return _reduce_rows(self.mesh, self.rows, per_row, self.specs,
                            self.scatter, weights, k, self.heads)

    def train(self, loss_fn: LossFn, cells: list[Params], batches: Params,
              step_keys: torch.Tensor, n_steps: int, eta, theta: float,
              deferred: bool) -> tuple:
        """``n_steps`` heavy-ball steps from v = 0 -> (y, losses [m,
        n_steps]); ``deferred``: one step more whose gradient g is
        returned unapplied -> (y, v, g, losses [m, n_steps + 1])."""
        devs = list(self.mesh.devices.flat)
        y = [{n: t.detach() for n, t in c.items()} for c in cells]
        v = [{n: torch.zeros_like(t) for n, t in c.items()} for c in y]
        etas = [_on(eta, d) for d in devs]
        losses = []
        for k in range(n_steps):
            loss, g = self.step(loss_fn, y, batches, step_keys, k)
            yv = [heavy_ball_update(*a, theta) for a in zip(y, v, g, etas)]
            y, v = [a for a, _ in yv], [c for _, c in yv]
            losses.append(loss)
        if not deferred:
            return y, torch.stack(losses, dim=1)
        loss, g = self.step(loss_fn, y, batches, step_keys, n_steps)
        losses.append(loss)
        return y, v, g, torch.stack(losses, dim=1)


def _pods(loss_fn: LossFn, mesh, cells: list[Params], specs: dict,
          batches: Params, keys: torch.Tensor, batch_axes: tuple,
          routing=None) -> list:
    """Per pod of ``mesh`` (one without a pod axis): its
    :class:`_PodRows`, its cells, its clients' batches and keys (the
    clients the ``"pod"`` axis gives it, a contiguous block)."""
    if tuple(mesh.axis_names)[-2:] != ("data", "model"):
        raise ValueError(f"the train step on cells runs on ('data', "
                         f"'model') or ('pod', 'data', 'model'), got "
                         f"{tuple(mesh.axis_names)}")
    if getattr(loss_fn, "column_parallel", None) is None:
        raise ValueError("the train step on (data, model) cells needs a "
                         "loss with a column-parallel form "
                         "(models.model.make_loss)")
    n = mesh.n_pods
    m = keys.shape[0]
    if m % n:
        raise ValueError(f"{m} clients do not block over {n} pods")
    ml = m // n
    sp = pod_specs(specs)
    b = next(iter(batches.values())).shape[2]
    out = []
    for p in range(n):
        lanes = slice(p * ml, (p + 1) * ml)
        out.append((_PodRows(loss_fn, mesh.pod(p), sp, batch_axes, b,
                             routing),
                    mesh.pod_cells(cells, p),
                    {k: t[lanes] for k, t in batches.items()}, keys[lanes]))
    return out


def local_train_rows(loss_fn: LossFn, mesh, cells: list[Params],
                     specs: dict, batches: Params, keys: torch.Tensor, *,
                     eta: float, theta: float,
                     batch_axes: tuple = (), deferred: bool = False,
                     routing=None) -> tuple:
    """K heavy-ball steps on every cell of a ``launch.mesh.ServeMesh``
    of ``("data", "model")`` or ``("pod", "data", "model")`` cells
    (module docstring). On the pod mesh each pod trains its own clients
    (the ``"pod"`` axis cuts the client dim) on its ``("data",
    "model")`` cells (``ServeMesh.pod``), with those clients' batches
    and keys; nothing crosses pods.

    Args:
      loss_fn:  a loss carrying a column-parallel form
                (``models.model.make_loss``) that covers every leaf the
                model axis cuts.
      cells:    the stacked client parameters laid out by ``specs`` (flat
                name -> ``PartitionSpec``), one dict a cell, row-major.
      batches:  dict of [m, K, b, ...] leaves, the whole batch (on any
                device; each row takes its block to its home).
      keys:     client PRNG keys [m, 2] (``split(keys[c], K)[k]`` for
                step k, as :func:`local_train`).
      batch_axes: the mesh axes that cut the batch's dim 2 (``("data",)``
                under B2 and B3; empty under B: every row the whole
                batch).
      deferred: stop as :func:`local_train_deferred` does: K-2 steps
                applied and step K-2's gradient computed, not applied
                (the fused round's head; K >= 2).
      routing:  ``n_blocks -> RowRouting`` (``models.moe``, with
                ``whole_aux``) to route a cut batch's rows as one
                dispatch group a client (the reference's MoE where the
                model axis does not divide ``moe_d_ff``): each step's
                rows first run their forwards alone, in batch order, so
                every block's expert counts are known, then each row its
                forward and backward; None: each row routes its own
                tokens.

    Returns:
      (y^{t,K} as cells, each client's mean local loss over the K steps
      [m] on the first cell's device); ``deferred``: (y_{K-2}, v_{K-2},
      g_{K-2} as cells, the losses of steps 0..K-2 [m, K-1]).
    """
    K = next(iter(batches.values())).shape[1]
    if deferred and K < 2:
        raise ValueError(f"deferred local training needs K >= 2, got {K}")
    home = mesh.devices.flat[0]
    parts = []
    for rows, pc, pb, pk in _pods(loss_fn, mesh, cells, specs, batches,
                                  keys, tuple(batch_axes), routing):
        parts.append(rows.train(loss_fn, pc, pb, prng.split(pk, K),
                                K - 2 if deferred else K, eta, theta,
                                deferred))
    losses = torch.cat([p[-1].to(home) for p in parts])
    outs = ([mesh.join_pods([p[i] for p in parts])
             for i in range(len(parts[0]) - 1)] if mesh.n_pods > 1
            else list(parts[0][:-1]))
    if deferred:
        return (*outs, losses)
    return outs[0], losses.mean(dim=1)


def rows_loss_and_grad(loss_fn: LossFn, mesh, cells: list[Params],
                       specs: dict, batch: Params, keys: torch.Tensor, *,
                       batch_axes: tuple = (), routing=None
                       ) -> tuple[torch.Tensor, list[Params]]:
    """One step's losses [m] (on the first cell's device) and every
    cell's gradient at ``cells``, the rows' as :func:`local_train_rows`
    takes them: ``batch`` leaves [m, b, ...], ``keys`` the step's [m,
    2]. The fused round's last gradient."""
    home = mesh.devices.flat[0]
    batches = {n: t[:, None] for n, t in batch.items()}
    losses, grads = [], []
    for rows, pc, pb, pk in _pods(loss_fn, mesh, cells, specs, batches,
                                  keys, tuple(batch_axes), routing):
        loss, g = rows.step(loss_fn, pc, pb, pk[:, None], 0)
        losses.append(loss.to(home))
        grads.append(g)
    if mesh.n_pods > 1:
        return torch.cat(losses), mesh.join_pods(grads)
    return losses[0], grads[0]


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
