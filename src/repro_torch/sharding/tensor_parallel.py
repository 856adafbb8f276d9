"""Column groups: the cross-column operations of the tensor-parallel
local step on a 2D ``(clients, model)`` mesh.

A shard's row of ``mp`` cells (``grid[s, :]``, ``core.mixing._mesh_grid``)
forms a :class:`ColumnGroup`. Its home is column 0's device, where the
batch, the replicated activations and the loss live. A loss's
column-parallel form (:class:`ColumnParallel`) reads the row's cells as
they are at rest, through :meth:`ColumnGroup.view`: a leaf that the
model axis cuts is the list of its mp slices, one a column on the
column's device; a replicated leaf is column 0's copy. Nothing gathers a
cut weight whole. The operations are torch compositions, so autograd
carries gradients across devices:

  * :meth:`~ColumnGroup.broadcast` copies a home tensor to every column;
    its backward sums the columns' gradients at home in column order;
  * :meth:`~ColumnGroup.reduce_sum` adds the columns' partials at home in
    column order 0..mp-1, so a round is deterministic;
    :meth:`~ColumnGroup.all_sum` broadcasts that sum back to every column
    (a statistic over a cut dim, such as the SSM's gated norm);
  * :meth:`~ColumnGroup.gather` concatenates cut slices at home (a cut
    bias that meets a full activation);
  * :meth:`~ColumnGroup.slice` cuts a home activation into the columns'
    parts;
  * :meth:`~ColumnGroup.all_gather` concatenates cut slices on every
    column (a serving row's query heads, or a head_dim-cut cache's
    slices, where every column reads them whole).

A row of a ``launch.mesh.ServeMesh`` (``launch.build``'s prefill and
decode, and its train step under strategies B, B2 and B3) is a column
group too. Where the specs also cut a weight over the data axis (the
reference's ``RULES_SERVE_2D`` and ``RULES_B`` cut ``"embed"``,
``RULES_B2`` cuts ``"mlp"`` over ``("data", "model")``) the row's view
holds it as a :class:`DataCut`, the blocks of its data column, which
:func:`gather_data` concatenates on the column's device at its use (the
FSDP-style all-gather those rules imply), layer by layer, so a gathered
weight lives as long as its layer. Its backward returns the gradient to
the data column's cells: where every row computes the whole batch (B,
serving) each row keeps its own block's slice, no collective; where each
row holds its own batch block (B2, B3) every block goes back to its cell
(a ``reduce-scatter``, which ``core.local_sgd`` sums in data-row order).
The rows never exchange activations.

The reference leaves this step to GSPMD, which partitions the whole
model's step over the ``"model"`` axis (``launch/train.py``); the port
writes the partition by hand for the losses that carry a form. Each
operation but ``slice`` (whose home tensor the reference's program holds
replicated, with no collective) records the collective it stands for,
and its backward pass the adjoint one, in ``launch.hlo_stats``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..launch import hlo_stats

Params = dict[str, torch.Tensor]

__all__ = ["ColumnGroup", "ColumnParallel", "DataCut", "gather_data",
           "ordered_sum", "with_column_parallel", "local_step_kind"]


class _Broadcast(torch.autograd.Function):
    """x on its device -> one copy a device (a view where the device is
    x's own); the gradient is the sum of the copies' gradients, added on
    x's device in the order of the devices."""

    @staticmethod
    def forward(ctx, x, devs, record):
        ctx.home = x.device
        ctx.record = record
        return tuple(x.view_as(x) if torch.device(d) == x.device
                     else x.to(d) for d in devs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.record:
            hlo_stats.record("all-reduce", _nbytes(grads[0]), len(grads))
        acc = grads[0].to(ctx.home)
        for g in grads[1:]:
            acc = acc + g.to(ctx.home)
        return acc, None, None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _on_backward(t: torch.Tensor, kind: str, result_bytes: int, g: int
                 ) -> torch.Tensor:
    """Record ``kind`` when the gradient of ``t`` passes (a no-op for a
    tensor that needs none)."""
    if t.requires_grad and hlo_stats.RECORDERS:
        t.register_hook(lambda grad: hlo_stats.record(kind, result_bytes,
                                                      g))
    return t


def ordered_sum(parts: Sequence[torch.Tensor], dev) -> torch.Tensor:
    """``parts`` added on ``dev`` in their order (in f32 for a narrower
    float type, rounded once at the end), so a sum across devices is
    deterministic."""
    dtype = parts[0].dtype
    narrow = dtype in (torch.bfloat16, torch.float16)
    acc = parts[0].to(dev)
    acc = acc.to(torch.float32) if narrow else acc
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc.to(dtype) if narrow else acc


class ColumnGroup:
    """One shard's row of cells: ``devices`` one a column (column 0 the
    home) and ``dims``, flat name -> the stacked leaf's dim the model
    axis cuts (None: replicated), as ``core.mixing._column_dims`` gives
    it."""

    def __init__(self, devices: Sequence, dims: dict):
        self.devices = [torch.device(d) for d in devices]
        self.dims = dict(dims)
        self.mp = len(self.devices)
        self.home = self.devices[0]

    def view(self, cells: list[Params]) -> dict:
        """The row's cells as one dict: a cut leaf the list of its slices
        (column order), a replicated leaf column 0's copy (the other
        columns' copies are not read)."""
        return {n: [c[n] for c in cells] if self.dims.get(n) is not None
                else t for n, t in cells[0].items()}

    def broadcast(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A home tensor on every column (its backward sums the columns'
        gradients at home, in column order): an ``all-gather`` of x, its
        backward an ``all-reduce``."""
        hlo_stats.record("all-gather", _nbytes(x), self.mp)
        return list(_Broadcast.apply(x, tuple(self.devices), True))

    def reduce_sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The columns' partials added at home in column order (in f32
        for a narrower float type, rounded once at the end): an
        ``all-reduce`` of one partial, its backward an ``all-gather``."""
        hlo_stats.record("all-reduce", _nbytes(parts[0]), self.mp)
        return _on_backward(self._sum(parts), "all-gather",
                            _nbytes(parts[0]), self.mp)

    def _sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return ordered_sum(parts, self.home)

    def all_sum(self, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """:meth:`reduce_sum` of the columns' partials, on every column:
        one ``all-reduce``, its backward one more."""
        hlo_stats.record("all-reduce", _nbytes(parts[0]), self.mp)
        total = _on_backward(self._sum(parts), "all-reduce",
                             _nbytes(parts[0]), self.mp)
        return list(_Broadcast.apply(total, tuple(self.devices), False))

    def gather(self, parts: Sequence[torch.Tensor], dim: int
               ) -> torch.Tensor:
        """Cut slices concatenated along ``dim`` at home: an
        ``all-gather`` of the whole, its backward a ``reduce-scatter`` of
        one slice."""
        out = torch.cat([p.to(self.home) for p in parts], dim=dim)
        hlo_stats.record("all-gather", _nbytes(out), self.mp)
        return _on_backward(out, "reduce-scatter", _nbytes(parts[0]),
                            self.mp)

    def slice(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        """A home tensor cut along ``dim`` into mp equal parts, part c on
        column c's device."""
        w = x.shape[dim] // self.mp
        return [p.to(d) for p, d in zip(torch.split(x, w, dim=dim),
                                        self.devices)]

    def all_gather(self, parts: Sequence[torch.Tensor], dim: int
                   ) -> list[torch.Tensor]:
        """Cut slices concatenated along ``dim`` on every column: one
        ``all-gather`` of the whole (the serving step's; no backward
        collective is recorded)."""
        out = torch.cat([p.to(self.home) for p in parts], dim=dim)
        hlo_stats.record("all-gather", _nbytes(out), self.mp)
        return list(_Broadcast.apply(out, tuple(self.devices), False))


class DataCut:
    """A weight cut over the data axis in a mesh row's view: its blocks
    along ``axis``, one a data cell of the column (in the order of the
    data axis), to be joined on ``device`` (the row's cell of that
    column) at its use by :func:`gather_data`. ``own``: the index of the
    row's own block where every row computes the whole batch (the
    gradient keeps that block's slice), None where each row holds its
    own batch block (the gradient of every block goes back to its cell).
    ``unbind`` and ``unsqueeze`` act on the blocks, so a stage's leaf
    splits into its layers, and ``dim`` is the rank a block has, as a
    tensor's."""

    __slots__ = ("parts", "axis", "device", "own")

    def __init__(self, parts: Sequence[torch.Tensor], axis: int, device,
                 own: int | None = None):
        self.parts = list(parts)
        self.axis = axis
        self.device = torch.device(device)
        self.own = own

    def dim(self) -> int:
        return self.parts[0].dim()

    def with_parts(self, parts: Sequence[torch.Tensor]) -> "DataCut":
        """The same cut over other blocks (of the same shapes)."""
        return DataCut(parts, self.axis, self.device, self.own)

    def unbind(self, dim: int) -> list["DataCut"]:
        if dim == self.axis:
            raise ValueError("a DataCut unbinds a dim the data axis does "
                             "not cut")
        axis = self.axis - (self.axis > dim)
        return [DataCut(ps, axis, self.device, self.own)
                for ps in zip(*(p.unbind(dim) for p in self.parts))]

    def unsqueeze(self, dim: int) -> "DataCut":
        return DataCut([p.unsqueeze(dim) for p in self.parts],
                       self.axis + (dim <= self.axis), self.device,
                       self.own)


class _GatherData(torch.autograd.Function):
    """A :class:`DataCut`'s blocks concatenated on its device. The
    backward cuts the gradient into the blocks' slices: with ``own`` set
    only that block's (a copy of its own, so the whole gradient can be
    freed), else every block's, each on its block's device (a
    ``reduce-scatter``: the caller sums the rows' slices)."""

    @staticmethod
    def forward(ctx, axis, device, own, *parts):
        ctx.axis, ctx.own = axis, own
        ctx.sizes = [p.shape[axis] for p in parts]
        ctx.devices = [p.device for p in parts]
        return torch.cat([p.to(device) for p in parts], dim=axis)

    @staticmethod
    def backward(ctx, grad):
        slices = torch.split(grad, ctx.sizes, dim=ctx.axis)
        if ctx.own is not None:
            out = [None] * len(slices)
            out[ctx.own] = slices[ctx.own].to(
                ctx.devices[ctx.own], copy=True,
                memory_format=torch.contiguous_format)
            return (None, None, None, *out)
        hlo_stats.record("reduce-scatter", _nbytes(slices[0]),
                         len(slices), senders=1)
        return (None, None, None,
                *(s.to(d).contiguous() for s, d in zip(slices,
                                                      ctx.devices)))


def gather_data(x):
    """A mesh row's view of a leaf as its layer reads it: a
    :class:`DataCut` joined on its device (an ``all-gather`` over its
    data column, of which this row records its own cell's share; its
    backward :class:`_GatherData`'s), a list of them column by column;
    any other value as it is."""
    if isinstance(x, list):
        return [gather_data(t) for t in x]
    if not isinstance(x, DataCut):
        return x
    out = _GatherData.apply(x.axis, x.device, x.own, *x.parts)
    hlo_stats.record("all-gather", _nbytes(out), len(x.parts), senders=1)
    return out


def _no_heads(name: str) -> bool:
    return False


@dataclasses.dataclass(frozen=True)
class ColumnParallel:
    """A loss's column-parallel form: ``fn(group, view, batch, rng) ->
    losses [m]`` on the group's home, computing the loss of the row's
    cells (``view`` from :meth:`ColumnGroup.view`) without joining them;
    ``covers(name, dims)`` says whether the form handles leaf ``name``
    cut, given every leaf's cut dim ``dims`` (a form may take a leaf
    only together with others); ``heads(name)`` whether it reads leaf
    ``name``'s column as a contiguous block of channels (an SSM's inner
    dim), so that a dim cut over ``("data", "model")`` (strided across
    the columns) is re-cut contiguously at the row's gather
    (``launch.mesh.ServeMesh.row_cells``)."""

    fn: Callable
    covers: Callable[[str, dict], bool]
    heads: Callable[[str], bool] = _no_heads


def with_column_parallel(loss_fn: Callable, fn: Callable,
                         covers: Callable[[str, dict], bool],
                         heads: Callable[[str], bool] = _no_heads
                         ) -> Callable:
    """``loss_fn`` carrying the column-parallel form ``fn`` (the callable
    the round calls on one device and on a 1D mesh is ``loss_fn``
    itself)."""
    def loss(params, batch, rng):
        return loss_fn(params, batch, rng)

    loss.column_parallel = ColumnParallel(fn, covers, heads)
    return loss


def local_step_kind(loss_fn: Callable, dims: dict | None) -> str:
    """Which local step a round runs: ``"whole"`` without a 2D mesh
    (``dims`` None: every lane's whole model on its shard's device),
    ``"tensor_parallel"`` when the loss carries a column-parallel form
    that covers every leaf ``dims`` cuts, else ``"joined"`` (the row's
    cells joined on column 0's device)."""
    if dims is None:
        return "whole"
    form = getattr(loss_fn, "column_parallel", None)
    if form is not None and all(form.covers(n, dims)
                                for n, d in dims.items() if d is not None):
        return "tensor_parallel"
    return "joined"
