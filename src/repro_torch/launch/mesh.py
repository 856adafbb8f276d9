"""The client mesh, 1D ``("clients",)`` or 2D ``("clients", "model")``,
and the pooled runner's lane sizing — the port of the JAX package's
``launch/mesh.py`` for a mesh of client shards.

A 1D :class:`ClientMesh` is a row of devices, one a shard: shard ``s``
holds the contiguous lane block ``[s * m_local, (s+1) * m_local)`` of
every stacked leaf on ``devices[s]``. A 2D one is an ``[n_shards,
model_parallel]`` grid of cells: cell ``(s, c)`` holds shard s's lanes
with every leaf that the param specs cut over ``"model"`` narrowed to
column c's contiguous block (a replicated leaf whole on every column).
It is the counterpart of a ``jax.sharding.Mesh`` of those axes, and
exposes ``devices.shape`` and ``axis_names`` as the reference's code
reads them. Its sharded form of a stacked dict is a list of dicts, one a
cell, row-major (one a shard on a 1D mesh): :meth:`ClientMesh.shard` and
:meth:`ClientMesh.gather`, the counterparts of
``device_put(NamedSharding)`` and ``np.asarray``.

``make_client_mesh`` takes distinct CUDA devices, one a cell, as the
reference takes distinct accelerators; ``make_test_mesh`` builds a mesh
whose cells may repeat one device (the CPU in tests, one card in
``chip_smoke.py``) — the port's counterpart of the reference tests'
``--xla_force_host_platform_device_count``.

A :class:`ServeMesh` is a mesh of the reference's deployment axes,
``("data", "model")`` or ``("pod", "data", "model")`` (``make_named_mesh``),
whose cells are distinct cards, one device repeated (the CPU in tests,
cuda:0 in ``chip_smoke.py``) or ``meta``. ``make_production_mesh`` is the
reference's 256- and 512-chip deployment meshes of ``meta`` cells
(``launch.build`` maps a strategy-A train step's client axes onto a
``ClientMesh``; B, B2 and B3 train on the cells themselves),
and the roofline constants are the H100's (NVIDIA H100 80GB HBM3, SXM,
700 W), not the reference's v5e numbers. A ``ServeMesh`` lays an
*unstacked* parameter dict and the list-of-stages cache tree out by
``PartitionSpec``s that cut a dim over ``"model"``, over ``"data"`` (and
``"pod"``), or over both (:meth:`ServeMesh.shard`, a :class:`Cells`
list, row-major; :meth:`ServeMesh.gather` the inverse), and gives each
row of cells (every axis but ``"model"``) as a column group with its
view (:meth:`ServeMesh.row_view`, or :meth:`ServeMesh.row_cells` one
column at a time for the train step). ``launch.build``'s serving steps
and its B, B2 and B3 train steps run on ``meta`` cells and on real ones
alike.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core.mixing import (_column_dims, _mesh_grid, cut_columns,
                           join_columns, join_lanes, split_lanes)
from ..device import resolve_device
from ..sharding.rules import pod_specs
from ..sharding.tensor_parallel import ColumnGroup, DataCut

CPU_BUDGET_BYTES = 2 << 30

Params = dict[str, torch.Tensor]

__all__ = ["Cells", "ClientMesh", "ServeMesh",
           "make_client_mesh", "make_named_mesh", "make_production_mesh",
           "make_test_mesh",
           "resident_lane_capacity",
           "HBM_BW", "PEAK_FLOPS_BF16", "NVLINK_BW"]

# NVIDIA H100 80GB HBM3 (SXM, 700 W) roofline constants, from NVIDIA's
# H100 datasheet: per card, and per direction of its NVLink 4 links. The
# reference's ``ICI_BW`` (a v5e ICI link) is the constant NVLINK_BW
# stands for in the collective term.
HBM_BW = 3.35e12                # B/s
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense
NVLINK_BW = 450e9               # B/s, one direction


@dataclasses.dataclass(frozen=True, eq=False)
class ClientMesh:
    """A mesh of client shards: ``devices`` a numpy object array of
    ``torch.device``, ``[n_shards]`` under one axis (``("clients",)``)
    or ``[n_shards, model_parallel]`` under two (``("clients",
    "model")``), one a cell."""

    devices: np.ndarray
    axis_names: tuple = ("clients",)

    def __post_init__(self):
        grid = np.asarray(self.devices, dtype=object)
        if grid.ndim != len(self.axis_names) or grid.ndim not in (1, 2):
            raise ValueError(
                f"a 1D client mesh is [n_shards] under ('clients',), a "
                f"2D one [n_shards, model_parallel] under ('clients', "
                f"'model'); "
                f"got devices of shape {grid.shape} under "
                f"{tuple(self.axis_names)}")
        devs = np.empty(grid.shape, dtype=object)
        for i, d in np.ndenumerate(grid):
            devs[i] = torch.device(d)
        if devs.size < 1:
            raise ValueError("a client mesh needs at least one shard")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def n_shards(self) -> int:
        return int(self.devices.shape[0])

    @property
    def model_parallel(self) -> int:
        return 1 if self.devices.ndim == 1 else int(self.devices.shape[1])

    @property
    def shared(self) -> bool:
        """Whether every cell lies on one device (a test mesh)."""
        return len({str(d) for d in self.devices.flat}) == 1

    def m_local(self, m: int) -> int:
        if m % self.n_shards:
            raise ValueError(f"m={m} does not block over "
                             f"{self.n_shards} shards")
        return m // self.n_shards

    def shard(self, tree: Params, specs=None) -> list[Params]:
        """A stacked dict (leaves [m, ...]) -> one dict a cell, row-major:
        cell ``(s, c)`` holds lanes ``[s * m_local, (s+1) * m_local)``
        on ``devices[s, c]``, each leaf that ``specs`` cut over the model
        axis narrowed to column c's block (``core.mixing.split_lanes``,
        ``cut_columns``); each leaf its own contiguous storage (a state
        the round updates must not alias the caller's tree)."""
        self.m_local(next(iter(tree.values())).shape[0])
        grid = _mesh_grid(self)
        rows = split_lanes(tree, list(grid[:, 0]))
        cells = cut_columns(rows, _column_dims(self, specs), grid)
        return [{n: t.clone() if t.device == tree[n].device else t
                 for n, t in cell.items()} for cell in cells]

    def gather(self, cells: list[Params], specs=None) -> Params:
        """The inverse of :meth:`shard`: one stacked dict on the first
        cell's device (lane order; ``join_columns``, ``join_lanes``)."""
        grid = _mesh_grid(self)
        return join_lanes(join_columns(cells, _column_dims(self, specs),
                                       grid), grid[0, 0])


class Cells(list):
    """A tree laid out on a :class:`ServeMesh`: one entry a cell (the
    tree's nest, each leaf that cell's block), row-major over the mesh's
    devices."""


_SERVE_AXES = ("pod", "data", "model")


def _nest_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a dict (name -> tensor) or a list of them
    (None entries kept), ``specs`` of the same nest."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {n: fn(t, specs[n]) for n, t in tree.items()}
    return [_nest_map(fn, t, s) for t, s in zip(tree, specs)]


def _paths(fn, tree, path=()):
    """``fn(path)`` for every leaf of a nest like :func:`_nest_map`'s, a
    leaf's path its keys and list indices from the root."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {n: fn(path + (n,)) for n in tree}
    return [_paths(fn, t, path + (i,)) for i, t in enumerate(tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@dataclasses.dataclass(frozen=True, eq=False)
class ServeMesh:
    """A deployment mesh: ``devices`` an object array of ``torch.device``
    over ``axis_names``, a subsequence of ``("pod", "data", "model")``
    ending in ``"model"`` (the reference's ``("data", "model")`` and
    ``("pod", "data", "model")``), read as the reference reads a
    ``jax.sharding.Mesh`` (``devices.shape``, ``axis_names``,
    ``devices.size``). A *row* is a cell's coordinates on every axis but
    ``"model"``; its cells, one a model column, form a
    :class:`~repro_torch.sharding.tensor_parallel.ColumnGroup`."""

    devices: np.ndarray
    axis_names: tuple = ("data", "model")

    def __post_init__(self):
        names = tuple(self.axis_names)
        grid = np.asarray(self.devices, dtype=object)
        if (not names or names[-1] != "model"
                or names != tuple(a for a in _SERVE_AXES if a in names)
                or grid.ndim != len(names)):
            raise ValueError(
                f"a serving mesh's axes are ('data', 'model') or ('pod', "
                f"'data', 'model'), one a devices dim; got devices of "
                f"shape {grid.shape} under {names}")
        devs = np.empty(grid.shape, dtype=object)
        for i, d in np.ndenumerate(grid):
            devs[i] = torch.device(d)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def model_parallel(self) -> int:
        return self.sizes["model"]

    def rows(self) -> list[tuple]:
        """Every row's coordinates (all axes but ``"model"``), row-major."""
        return list(np.ndindex(self.devices.shape[:-1]))

    @property
    def n_pods(self) -> int:
        return self.sizes.get("pod", 1)

    def pod(self, p: int) -> "ServeMesh":
        """Pod ``p``'s cells as a ``("data", "model")`` mesh (the mesh
        itself when it has no pod axis)."""
        if not 0 <= p < self.n_pods:
            raise ValueError(f"pod {p} of {self.n_pods}")
        if "pod" not in self.axis_names:
            return self
        return ServeMesh(devices=self.devices[p],
                         axis_names=self.axis_names[1:])

    def pod_cells(self, cells: Cells, p: int) -> Cells:
        """Pod ``p``'s entries of a tree laid out on this mesh, row-major
        over its ``("data", "model")`` cells: the tree as :meth:`pod`
        lays it out by :func:`pod_specs` (a leaf's client dim, cut over
        ``"pod"``, holds that pod's clients)."""
        if not 0 <= p < self.n_pods:
            raise ValueError(f"pod {p} of {self.n_pods}")
        n = self.devices.size // self.n_pods
        return Cells(cells[p * n:(p + 1) * n])

    def join_pods(self, parts: list) -> Cells:
        """The inverse of :meth:`pod_cells`: every pod's cells, in pod
        order, as one laid-out tree."""
        if len(parts) != self.n_pods:
            raise ValueError(f"{len(parts)} pods' cells for {self.n_pods}")
        return Cells(c for part in parts for c in part)

    def _block(self, t: torch.Tensor, spec, coord: tuple) -> torch.Tensor:
        """Cell ``coord``'s block of ``t`` under ``spec``: each dim cut
        into the product of its axes' sizes, its block index row-major
        over them (``jax.sharding``'s order)."""
        index = dict(zip(self.axis_names, coord))
        for i in range(t.dim()):
            names = spec.names(i)
            if not names:
                continue
            k, total = 0, 1
            for a in names:
                k, total = k * self.sizes[a] + index[a], total * self.sizes[a]
            if t.shape[i] % total:
                raise ValueError(f"dim {i} of {tuple(t.shape)} does not "
                                 f"divide over {names}")
            w = t.shape[i] // total
            t = t.narrow(i, k * w, w)
        return t

    def shard(self, tree, specs) -> Cells:
        """A tree (a dict name -> tensor, or the list-of-stages cache
        tree) -> one copy a cell, its leaves that cell's blocks on its
        device, each with its own storage (the counterpart of
        ``device_put(NamedSharding)``)."""
        def cell(coord, dev):
            def one(t, spec):
                b = self._block(t, spec, coord)
                return b.clone() if b.device == dev else b.to(dev)
            return _nest_map(one, tree, specs)
        return Cells(cell(c, d) for c, d in np.ndenumerate(self.devices))

    def empty(self, tree, specs) -> Cells:
        """Like :meth:`shard` for a tree of shapes (``meta`` leaves, say):
        each cell's blocks allocated, uninitialized, on its device."""
        def cell(coord, dev):
            return _nest_map(
                lambda t, spec: torch.empty(
                    self._block(t, spec, coord).shape, dtype=t.dtype,
                    device=dev), tree, specs)
        return Cells(cell(c, d) for c, d in np.ndenumerate(self.devices))

    def gather(self, cells: Cells, specs):
        """The inverse of :meth:`shard`: the whole tree on the first
        cell's device (each block from the cells at index 0 of the axes
        its spec does not cut)."""
        coords = list(np.ndindex(self.devices.shape))

        def leaf(path):
            first, spec = _at(cells[0], path), _at(specs, path)
            used = {a for i in range(len(spec)) for a in spec.names(i)}
            shape = [first.shape[i] * int(np.prod(
                [self.sizes[a] for a in spec.names(i)] or [1]))
                for i in range(first.dim())]
            out = torch.empty(shape, dtype=first.dtype,
                              device=self.devices.flat[0])
            for coord, cell in zip(coords, cells):
                index = dict(zip(self.axis_names, coord))
                if not any(index[a] for a in self.axis_names
                           if a not in used):
                    self._block(out, spec, coord).copy_(_at(cell, path))
            return out
        return _paths(leaf, cells[0])

    def _cell(self, cells: Cells, row: tuple, column: int):
        return cells[int(np.ravel_multi_index(row + (column,),
                                              self.devices.shape))]

    def row_group(self, row: tuple, dims: dict) -> ColumnGroup:
        """Row ``row``'s cells as a column group (``dims``: flat name ->
        the dim the model axis cuts, None when replicated)."""
        return ColumnGroup([self.devices[row + (c,)]
                            for c in range(self.model_parallel)], dims)

    def _data_cut(self, cells: Cells, path: tuple, spec, row: tuple,
                  c: int, scatter: bool, heads: bool = False):
        """Column ``c``'s entry of the leaf at ``path`` for row ``row``:
        the cell's block, or, where ``spec`` cuts a dim over the data (or
        pod) axes, a :class:`DataCut` of that column's blocks over those
        axes, in their order. A dim cut over ``("data", "model")``
        (``RULES_B2``'s ``"mlp"``) is cut data-major, as ``jax.sharding``
        orders it: column c's blocks are then the sub-blocks at positions
        ``d * mp + c`` of the full dim, strided, joined in data order (a
        partition across the columns that a product summed over that dim
        takes as exactly as a contiguous one, when every weight it meets is
        cut alike). ``heads`` (such a dim, read as a column's contiguous
        channels: an SSM's inner dim, on head boundaries or across them)
        re-cuts it contiguously instead: column c's entry holds the
        sub-blocks ``c * dp .. (c+1) * dp - 1`` of the full dim, sub-block
        k from cell ``(k // mp, k % mp)``, so the column holds the channels
        ``[c * w, (c+1) * w)``, as a cut over ``"model"`` alone gives them;
        its gradient goes back to every block (``own`` None). ``scatter``:
        each row holds its own batch block (the gradient goes back to every
        block), else the cut's ``own`` is the row's block."""
        cut = [i for i in range(len(spec))
               if any(a != "model" for a in spec.names(i))]
        if not cut:
            return _at(self._cell(cells, row, c), path)
        names = spec.names(cut[0])
        if len(cut) > 1 or ("model" in names and names[-1] != "model"):
            raise ValueError(
                f"{'/'.join(map(str, path))}: {spec!r} cuts the data axis "
                "over two dims, or ahead of the model axis in one, which a "
                "mesh row does not gather")
        if heads and "model" in names:
            if tuple(self.axis_names) != ("data", "model") or \
                    names != ("data", "model"):
                raise ValueError(f"{'/'.join(map(str, path))}: a re-cut to "
                                 f"contiguous channels takes a dim cut over "
                                 f"('data', 'model'), got {spec!r}")
            dp, mp = self.sizes["data"], self.model_parallel
            parts = [_at(self._cell(cells, (k // mp,), k % mp), path)
                     for k in range(c * dp, (c + 1) * dp)]
            return DataCut(parts, cut[0], self.devices[row + (c,)], None)
        axes = [a for a in names if a != "model"]
        pos = [self.axis_names.index(a) for a in axes]
        parts, own = [], None
        for i, k in enumerate(np.ndindex(*[self.sizes[a] for a in axes])):
            r = list(row)
            for p, v in zip(pos, k):
                r[p] = v
            if tuple(r) == tuple(row):
                own = i
            parts.append(_at(self._cell(cells, tuple(r), c), path))
        return DataCut(parts, cut[0], self.devices[row + (c,)],
                       None if scatter else own)

    def row_view(self, cells: Cells, specs, row: tuple, *,
                 every_column: bool = False):
        """Row ``row``'s view of a laid-out tree, as the model's
        column-parallel code reads it: a leaf the model axis cuts the
        list of its columns' blocks, a replicated one column 0's block,
        and a weight cut over the data (or pod) axis a :class:`DataCut`
        of its data column's blocks, joined at its use
        (:meth:`_data_cut`, its ``own`` the row's block).
        ``every_column`` (a cache tree): every leaf the list of the
        row's own blocks, one a column (a copy where the model axis does
        not cut it), which each column updates; its data-cut dim is the
        row's batch rows."""
        mp = self.model_parallel

        def view(path):
            spec = _at(specs, path)
            if every_column:
                return [_at(self._cell(cells, row, c), path)
                        for c in range(mp)]
            if any("model" in spec.names(i) for i in range(len(spec))):
                return [self._data_cut(cells, path, spec, row, c, False)
                        for c in range(mp)]
            return self._data_cut(cells, path, spec, row, 0, False)
        return _paths(view, cells[0])

    def row_cells(self, cells: Cells, specs: dict, row: tuple, *,
                  scatter: bool = False,
                  heads: frozenset = frozenset()) -> list[dict]:
        """Row ``row``'s entries of a laid-out flat dict, one dict a
        column (:meth:`_data_cut`'s: a block, or a :class:`DataCut`; the
        leaves named in ``heads`` re-cut to contiguous channels), as
        ``ColumnGroup.view`` reads a row's cells: the train step's
        (``core.local_sgd.loss_and_grad_columns``)."""
        return [{n: self._data_cut(cells, (n,), specs[n], row, c, scatter,
                                   n in heads)
                 for n in cells[0]} for c in range(self.model_parallel)]

    def batch_rows(self, row: tuple, dp: tuple, batch: int) -> slice:
        """The batch rows ``row`` serves: its block over the batch's mesh
        axes ``dp`` (the whole batch when ``dp`` is empty). Raises when
        the axes do not divide the batch."""
        index = dict(zip(self.axis_names, row + (0,)))
        k, total = 0, 1
        for a in dp:
            k, total = k * self.sizes[a] + index[a], total * self.sizes[a]
        if batch % total:
            raise ValueError(f"a batch of {batch} does not divide over "
                             f"{dp} ({total} rows)")
        w = batch // total
        return slice(k * w, (k + 1) * w)


def make_named_mesh(shape, axes=("data", "model"), device=None,
                    devices=None) -> ServeMesh:
    """A mesh of ``shape`` under ``axes``: its cells ``devices`` (distinct
    cards, row-major, one a cell) when given, else ``device`` repeated
    (the reference's host-device test mesh, ``(4, 2)`` ``("data",
    "model")``): the card when None (raises without one), else as named
    (``"cpu"``, ``"meta"``)."""
    shape = tuple(shape)
    grid = np.empty(shape, dtype=object)
    if devices is not None:
        if len(devices) != grid.size:
            raise ValueError(f"a {shape} mesh needs {grid.size} devices, "
                             f"got {len(devices)}")
        grid.flat[:] = [torch.device(d) for d in devices]
    else:
        dev = resolve_device(device)
        for i in np.ndindex(shape):
            grid[i] = dev
    return ServeMesh(devices=grid, axis_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> ServeMesh:
    """Single pod: 256 chips (16, 16) ("data", "model").
    Multi-pod: 2 pods = 512 chips (2, 16, 16) ("pod", "data", "model"),
    their cells ``meta``."""
    if multi_pod:
        return make_named_mesh((2, 16, 16), ("pod", "data", "model"),
                               device="meta")
    return make_named_mesh((16, 16), device="meta")


def make_test_mesh(n_shards: int, device=None,
                   model_parallel: int = 1) -> ClientMesh:
    """A client mesh of ``n_shards`` shards (times ``model_parallel``
    columns: a 2D ``("clients", "model")`` mesh when above 1) whose
    cells all lie on one device (``"cpu"`` in tests; the card by
    default). Transfers between its cells are device copies."""
    dev = resolve_device(device)
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    if model_parallel == 1:
        return ClientMesh(devices=np.array([dev] * n_shards, dtype=object))
    grid = np.empty((n_shards, model_parallel), dtype=object)
    for i in np.ndindex(grid.shape):
        grid[i] = dev
    return ClientMesh(devices=grid, axis_names=("clients", "model"))


# (m, clients_per_shard, model_parallel) already warned about: the dense
# fallback is worth one loud line a shape, not one a round.
_FALLBACK_WARNED: set = set()


def make_client_mesh(m: int, clients_per_shard: int = 1,
                     model_parallel: int = 1,
                     devices=None) -> ClientMesh | None:
    """Client mesh for the sparse executor: each of the ``m //
    clients_per_shard`` shards holds a contiguous block of
    ``clients_per_shard`` clients on a device of its own, the first of
    ``devices`` (default: every CUDA card). Returns ``None`` when there
    are too few, with a one-time warning naming the dense fallback (the
    reference's behaviour). A mesh of shards that share one card is
    :func:`make_test_mesh`. ``model_parallel > 1`` composes the client
    axis with a ``"model"`` axis into a 2D ``(clients, model)`` mesh of
    ``n_shards * model_parallel`` distinct devices, row-major (the
    reference's ``reshape(n_shards, model_parallel)``): each cell then
    holds its model slice of its client block."""
    if clients_per_shard < 1 or m % clients_per_shard:
        raise ValueError(
            f"clients_per_shard={clients_per_shard} must divide m={m}")
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    n_shards = m // clients_per_shard
    need = n_shards * model_parallel
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(
            torch.cuda.device_count() if torch.cuda.is_available() else 0)]
    n_devices = len(devices)
    if n_devices < need:
        key = (m, clients_per_shard, model_parallel)
        if key not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(key)
            warnings.warn(
                f"make_client_mesh: m={m} clients at clients_per_shard="
                f"{clients_per_shard}, model_parallel={model_parallel} "
                f"needs {need} devices but this host has {n_devices} "
                f"({need - n_devices} short); returning None, so "
                f"callers FALL BACK TO THE DENSE MIXER (all-gather "
                f"traffic, not O(degree) transfers) and any --placement "
                f"partition request cannot apply (placement permutes "
                f"block lanes, which only exist on the sparse mesh "
                f"backend). Raise --clients-per-shard so that "
                f"m/clients_per_shard * model_parallel <= {n_devices}, "
                f"or pass --mixer-impl dense to make the fallback "
                f"explicit.",
                UserWarning, stacklevel=2)
        return None
    devs = np.empty(need, dtype=object)
    devs[:] = [torch.device(d) for d in devices[:need]]
    if len({str(d) for d in devs}) < need:
        raise ValueError(f"make_client_mesh needs {need} distinct devices, "
                         f"got {[str(d) for d in devs]} (a mesh whose cells "
                         "share a device is make_test_mesh)")
    if model_parallel == 1:
        return ClientMesh(devices=devs)
    return ClientMesh(devices=devs.reshape(n_shards, model_parallel),
                      axis_names=("clients", "model"))


def resident_lane_capacity(bytes_per_client: int,
                           budget_bytes: int | None = None,
                           overhead: float = 4.0,
                           model_parallel: int = 1, device=None) -> int:
    """How many client lanes fit device memory — the pooled-execution
    sizing heuristic (``--resident-lanes`` defaults from this).

    ``bytes_per_client`` is one client's parameter bytes; ``overhead``
    budgets the working set per lane (params + momentum + grads + update
    temporaries ~= 4x params). ``budget_bytes`` defaults to the card's
    free memory (``torch.cuda.mem_get_info``) on ``device`` (CUDA unless
    ``"cpu"``), or 2 GiB on the CPU. On a 2D ``(clients, model)`` mesh
    each device holds only ``1/model_parallel`` of every lane's params
    at rest, so a lane bills ``ceil(bytes / model_parallel)`` (the
    reference's sizing: a tensor-parallel local step — every registered
    arch's and the 2NN's — keeps each cell's working set to its slice;
    the joined step of an opaque loss or a declined cut holds a shard's
    full lanes on its first column, which this does not bill). Always
    returns at least 1.
    """
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    if budget_bytes is None:
        dev = resolve_device(device)
        budget_bytes = (torch.cuda.mem_get_info(dev)[0]
                        if dev.type == "cuda" else CPU_BUDGET_BYTES)
    per_device = -(-bytes_per_client // model_parallel)
    return max(1, int(budget_bytes / (overhead * per_device)))
