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

``make_production_mesh`` is the reference's 256- and 512-chip
deployment meshes as a stand-in of ``meta`` cells (``launch.build``
maps its client axes onto a ``ClientMesh``), and the roofline constants
are the H100's (NVIDIA H100 80GB HBM3, SXM, 700 W), not the reference's
v5e numbers.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core.mixing import (_column_dims, _mesh_grid, cut_columns,
                           join_columns, join_lanes, split_lanes)
from ..device import resolve_device

CPU_BUDGET_BYTES = 2 << 30

Params = dict[str, torch.Tensor]

__all__ = ["ClientMesh", "ProductionMesh", "make_client_mesh",
           "make_named_mesh", "make_production_mesh", "make_test_mesh",
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


@dataclasses.dataclass(frozen=True, eq=False)
class ProductionMesh:
    """A deployment mesh's shape without its chips: ``devices`` an object
    array of ``meta`` devices, ``axis_names`` the reference's names. Read
    as the reference reads a ``jax.sharding.Mesh`` (``devices.shape``,
    ``axis_names``, ``devices.size``)."""

    devices: np.ndarray
    axis_names: tuple


def make_named_mesh(shape, axes, device="meta") -> ProductionMesh:
    """A mesh of ``shape`` under ``axes`` whose cells all lie on
    ``device`` (the reference's host-device test mesh, ``(4, 2)``
    ``("data", "model")``, on one card or on ``meta``)."""
    devs = np.empty(tuple(shape), dtype=object)
    for i in np.ndindex(devs.shape):
        devs[i] = torch.device(device)
    return ProductionMesh(devices=devs, axis_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """Single pod: 256 chips (16, 16) ("data", "model").
    Multi-pod: 2 pods = 512 chips (2, 16, 16) ("pod", "data", "model")."""
    if multi_pod:
        return make_named_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_named_mesh((16, 16), ("data", "model"))


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
