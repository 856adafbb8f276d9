"""The 1D client mesh and the pooled runner's lane sizing — the port of
the JAX package's ``launch/mesh.py`` for a mesh of client shards.

A :class:`ClientMesh` is a tuple of devices, one a shard: shard ``s``
holds the contiguous lane block ``[s * m_local, (s+1) * m_local)`` of
every stacked leaf on ``devices[s]``. It is the counterpart of a
``jax.sharding.Mesh`` with one ``"clients"`` axis, and exposes
``devices.shape`` and ``axis_names`` as the reference's code reads them.
Its sharded form of a stacked dict is a list of dicts, one a shard
(:meth:`ClientMesh.shard`, :meth:`ClientMesh.gather`): the counterparts of
``device_put(NamedSharding)`` and ``np.asarray``.

``make_client_mesh`` takes distinct CUDA devices, one a shard, as the
reference takes distinct accelerators; ``make_test_mesh`` builds a mesh
whose shards may repeat one device (the CPU in tests, one card in
``chip_smoke.py``) — the port's counterpart of the reference tests'
``--xla_force_host_platform_device_count``. The 2D ``(clients, model)``
mesh (``model_parallel > 1``) and the TPU roofline constants are not
ported (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ..core.mixing import join_lanes, split_lanes
from ..device import resolve_device

CPU_BUDGET_BYTES = 2 << 30

Params = dict[str, torch.Tensor]

__all__ = ["ClientMesh", "make_client_mesh", "make_test_mesh",
           "resident_lane_capacity"]


@dataclasses.dataclass(frozen=True, eq=False)
class ClientMesh:
    """A 1D mesh of client shards: ``devices`` a numpy object array of
    ``torch.device``, one a shard, under the axis ``axis_names[0]``."""

    devices: np.ndarray
    axis_names: tuple = ("clients",)

    def __post_init__(self):
        devs = np.empty(len(self.devices), dtype=object)
        devs[:] = [torch.device(d) for d in self.devices]
        if devs.size < 1:
            raise ValueError("a client mesh needs at least one shard")
        if len(self.axis_names) != 1:
            raise ValueError("the port's client mesh is 1D; the 2D "
                             "(clients, model) mesh is not ported yet")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def n_shards(self) -> int:
        return int(self.devices.size)

    @property
    def shared(self) -> bool:
        """Whether every shard lies on one device (a test mesh)."""
        return len({str(d) for d in self.devices}) == 1

    def m_local(self, m: int) -> int:
        if m % self.n_shards:
            raise ValueError(f"m={m} does not block over "
                             f"{self.n_shards} shards")
        return m // self.n_shards

    def shard(self, tree: Params) -> list[Params]:
        """A stacked dict (leaves [m, ...]) -> one dict a shard: shard s
        holds lanes ``[s * m_local, (s+1) * m_local)`` on ``devices[s]``
        (``core.mixing.split_lanes``), each leaf its own storage (a state
        the round updates must not alias the caller's tree)."""
        self.m_local(next(iter(tree.values())).shape[0])
        return [{n: t.clone() if t.device == tree[n].device else t
                 for n, t in s.items()}
                for s in split_lanes(tree, list(self.devices))]

    def gather(self, sharded: list[Params]) -> Params:
        """The inverse of :meth:`shard`: one stacked dict on
        ``devices[0]`` (lane order; ``core.mixing.join_lanes``)."""
        return join_lanes(sharded, self.devices[0])


def make_test_mesh(n_shards: int, device=None) -> ClientMesh:
    """A 1D client mesh of ``n_shards`` shards that all lie on one device
    (``"cpu"`` in tests; the card by default). Transfers between its
    shards are device copies."""
    dev = resolve_device(device)
    if n_shards < 1:
        raise ValueError(f"n_shards={n_shards} must be >= 1")
    return ClientMesh(devices=np.array([dev] * n_shards, dtype=object))


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
    :func:`make_test_mesh`. ``model_parallel > 1`` (the 2D mesh) raises:
    it is the next slice."""
    if clients_per_shard < 1 or m % clients_per_shard:
        raise ValueError(
            f"clients_per_shard={clients_per_shard} must divide m={m}")
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be >= 1")
    if model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the 2D (clients, model) mesh "
            "is not ported yet (ROADMAP, the next slice)")
    n_shards = m // clients_per_shard
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(
            torch.cuda.device_count() if torch.cuda.is_available() else 0)]
    n_devices = len(devices)
    if n_devices < n_shards:
        key = (m, clients_per_shard, model_parallel)
        if key not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(key)
            warnings.warn(
                f"make_client_mesh: m={m} clients at clients_per_shard="
                f"{clients_per_shard}, model_parallel={model_parallel} "
                f"needs {n_shards} devices but this host has {n_devices} "
                f"({n_shards - n_devices} short); returning None, so "
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
    devs = np.empty(n_shards, dtype=object)
    devs[:] = [torch.device(d) for d in devices[:n_shards]]
    return ClientMesh(devices=devs)


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
    ``"cpu"``), or 2 GiB on the CPU. ``model_parallel > 1`` (a 2D mesh)
    is the next slice of the port (ROADMAP A17) and raises. Always
    returns at least 1.
    """
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the (clients, model) mesh is "
            "not ported yet (ROADMAP A17)")
    if budget_bytes is None:
        dev = resolve_device(device)
        budget_bytes = (torch.cuda.mem_get_info(dev)[0]
                        if dev.type == "cuda" else CPU_BUDGET_BYTES)
    return max(1, int(budget_bytes / (overhead * bytes_per_client)))
