"""Logical-axis -> mesh-axis sharding rules (MaxText-style) — the port of
the JAX package's ``sharding/rules.py``.

``models.model.model_axes(cfg)`` gives every parameter leaf a tuple of
logical dim names (``("embed", "mlp")``, ``("layers", "heads", ...)``).
This module turns those into :class:`PartitionSpec` entries for a given
*strategy*:

  A "replicated-client" — paper-faithful: every client owns a full copy;
     the stacked client axis shards over (pod, data); within a client,
     heads/mlp/vocab/experts shard over "model".
  B "sharded-client"    — few clients, client axis over "pod" (multi-pod)
     or replicated; weight matrices 2-D sharded over ("data", "model").

Divisibility is always checked: a dim that does not divide by its mesh
axes falls back to replicated (e.g. kv_heads=3 over model=2). A mesh is
anything with ``axis_names`` and ``devices.shape`` (a
``launch.mesh.ClientMesh``, or a stand-in of those two attributes), as
the reference reads a ``jax.sharding.Mesh``. Trees are the port's flat
name -> leaf dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["PartitionSpec", "P", "ShardingStrategy", "spec_for_leaf",
           "specs_for_tree", "stack_shapes", "shapes_and_axes",
           "model_sharded_dims", "cuts_data", "pod_specs", "RULES_A",
           "RULES_B",
           "RULES_B2",
           "RULES_B3", "RULES_SERVE", "RULES_SERVE_2D"]


class PartitionSpec(tuple):
    """One leaf's sharding: an entry a dim, each ``None`` (replicated), a
    mesh axis name, or a tuple of names — ``jax.sharding.PartitionSpec``'s
    meaning. Immutable; compares equal to another spec of the same
    entries; its ``repr`` reads ``P('clients', None, 'model')``."""

    def __new__(cls, *entries):
        for e in entries:
            names = e if isinstance(e, tuple) else (e,)
            if not all(n is None or isinstance(n, str) for n in names) or (
                    isinstance(e, tuple) and None in e):
                raise TypeError(f"a spec entry is None, an axis name or a "
                                f"tuple of names, got {e!r}")
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)

    def names(self, i: int) -> tuple:
        """The mesh axes of dim ``i`` (empty when replicated)."""
        e = self[i] if i < len(self) else None
        return () if e is None else e if isinstance(e, tuple) else (e,)


P = PartitionSpec

# logical name -> candidate mesh axes, per strategy
RULES_A = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "embed2": ("model",),
}

RULES_B = {
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "embed2": ("model",),
}

# B2: batch data-parallel over "data"; weights 2-D sharded on parallel
# dims (d_ff over (data, model)).
RULES_B2 = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("data", "model"),
    "experts": ("model",),
    "ssm_inner": ("data", "model"),
    "ssm_heads": ("model",),
    "embed2": ("model",),
}

# B3: batch over "data" + grouped MoE dispatch; weights on "model" only.
RULES_B3 = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads": ("model",),
    "embed2": ("model",),
}

# serving (consensus model, no client axis): like A by default
RULES_SERVE = RULES_A
RULES_SERVE_2D = RULES_B            # huge archs: 2-D sharded weights


def _axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, np.asarray(mesh.devices).shape))


@dataclasses.dataclass(frozen=True)
class ShardingStrategy:
    """How clients, batch, and weights map onto the mesh."""

    name: str                        # "A" | "B" | "B2" | "B3"
    num_clients: int
    client_axes: tuple[str, ...]     # mesh axes carrying the client dim
    rules: dict
    batch_axes: tuple[str, ...] = ()  # mesh axes for the per-client batch

    @staticmethod
    def for_arch(arch_name: str, mesh, *, strategy: str | None = None
                 ) -> "ShardingStrategy":
        axis_sizes = _axis_sizes(mesh)
        multi_pod = "pod" in axis_sizes
        big = arch_name.startswith("mixtral")
        s = strategy or ("B" if big else "A")
        if s == "A":
            ca = ("pod", "data") if multi_pod else ("data",)
            m = int(np.prod([axis_sizes[a] for a in ca]))
            return ShardingStrategy("A", m, ca, RULES_A)
        # strategy B/B2: few clients; client axis over pod when available
        ca = ("pod",) if multi_pod else ()
        m = axis_sizes["pod"] if multi_pod else 2
        if s == "B2":
            return ShardingStrategy("B2", m, ca, RULES_B2,
                                    batch_axes=("data",))
        if s == "B3":
            return ShardingStrategy("B3", m, ca, RULES_B3,
                                    batch_axes=("data",))
        return ShardingStrategy("B", m, ca, RULES_B)


def _dim_spec(name: str | None, size: int, rules: dict,
              axis_sizes: dict[str, int], used: set[str]):
    if name is None or name not in rules:
        return None
    axes = tuple(a for a in rules[name] if a in axis_sizes and a not in used)
    if not axes:
        return None
    total = int(np.prod([axis_sizes[a] for a in axes]))
    if size % total != 0:
        # try single-axis fallback
        for a in axes:
            if size % axis_sizes[a] == 0:
                used.add(a)
                return a
        return None
    used.update(axes)
    return axes if len(axes) > 1 else axes[0]


def spec_for_leaf(axes_names: Sequence[str | None], shape: Sequence[int],
                  rules: dict, mesh, *,
                  leading_client: tuple[str, ...] | None = None
                  ) -> PartitionSpec:
    """The PartitionSpec of one leaf. ``leading_client``: mesh axes for a
    prepended client dim (stacked params; ``()`` replicates it); None for
    unstacked (serving) params. The ``"layers"`` dim is never sharded."""
    axis_sizes = _axis_sizes(mesh)
    used: set[str] = set()
    entries = []
    offset = 0
    if leading_client is not None:
        if leading_client:
            used.update(leading_client)
            entries.append(leading_client if len(leading_client) > 1
                           else leading_client[0])
        else:
            entries.append(None)
        offset = 1
    for i, name in enumerate(axes_names):
        size = shape[offset + i]
        if name == "layers":           # scan axis: never sharded
            entries.append(None)
            continue
        entries.append(_dim_spec(name, size, rules, axis_sizes, used))
    return P(*entries)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape if hasattr(leaf, "shape") else leaf)


def specs_for_tree(axes_tree: dict, shapes_tree: dict, rules: dict, mesh,
                   *, leading_client: tuple[str, ...] | None = None
                   ) -> dict[str, PartitionSpec]:
    """Flat name -> logical axes and flat name -> shaped leaf (a tensor,
    a meta tensor, or a shape tuple) WITH the client dim already
    prepended when ``leading_client`` is not None -> flat name ->
    PartitionSpec, in ``shapes_tree``'s names."""
    if set(axes_tree) != set(shapes_tree):
        raise ValueError("axes and shapes name different leaves: "
                         f"{sorted(set(axes_tree) ^ set(shapes_tree))}")
    return {n: spec_for_leaf(axes_tree[n], _shape(shapes_tree[n]), rules,
                             mesh, leading_client=leading_client)
            for n in shapes_tree}


def stack_shapes(shapes_tree: dict, m: int) -> dict:
    """Prepend the client axis to every leaf's shape: meta tensors of the
    leaves' dtypes (a shape tuple stays a tuple)."""
    def one(s):
        if isinstance(s, torch.Tensor):
            return torch.empty((m,) + tuple(s.shape), dtype=s.dtype,
                               device="meta")
        return (m,) + tuple(s)
    return {n: one(s) for n, s in shapes_tree.items()}


def shapes_and_axes(init_fn: Callable[[torch.Tensor], tuple[dict, Any]]
                    ) -> tuple[dict, Any]:
    """Evaluate an init that returns ``(params, axes)`` WITHOUT
    allocating: ``init_fn`` gets a PRNG key on the ``meta`` device, so
    the key chain and every draw are shape-only (the threefry wrappers
    return empty meta tensors for a meta key). Returns (flat name -> meta
    tensor, axes), e.g. ``shapes_and_axes(lambda k: (init_model(k, cfg,
    device="meta"), model_axes(cfg)))``."""
    key = torch.zeros(2, dtype=torch.int64, device="meta")
    params, axes = init_fn(key)
    bad = [n for n, t in params.items() if t.device.type != "meta"]
    if bad:
        raise ValueError(f"init allocated leaves off the meta device: {bad}")
    return params, axes


def model_sharded_dims(specs: dict[str, PartitionSpec], model_axis: str
                       ) -> dict[str, int | None]:
    """Flat name -> the dim its spec shards over ``model_axis`` (None for
    a leaf replicated across the model columns)."""
    out = {}
    for n, spec in specs.items():
        dims = [i for i in range(len(spec)) if model_axis in spec.names(i)]
        if len(dims) > 1:
            raise ValueError(f"{n}: {spec!r} shards two dims over "
                             f"{model_axis!r}")
        out[n] = dims[0] if dims else None
    return out


def cuts_data(spec: PartitionSpec) -> bool:
    """Whether ``spec`` cuts a dim over an axis other than ``"model"``
    (``"data"`` or ``"pod"``): a leaf whose blocks differ across a
    mesh's rows."""
    return any(a != "model" for i in range(len(spec)) for a in spec.names(i))


def pod_specs(specs):
    """Specs of a tree laid out on a ``("pod", "data", "model")`` mesh ->
    the specs one pod's cells hold it by (``ServeMesh.pod``): every
    ``"pod"`` dropped from the entries (a dim it cut alone replicated:
    the pod's own clients)."""
    def one(spec):
        out = []
        for i in range(len(spec)):
            names = tuple(a for a in spec.names(i) if a != "pod")
            out.append(None if not names else
                       names[0] if len(names) == 1 else names)
        return type(spec)(*out)
    if isinstance(specs, dict):
        return {n: one(s) for n, s in specs.items()}
    return one(specs)
