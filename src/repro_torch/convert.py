"""Parameters between the JAX package and the port, through numpy.

``params_from_numpy`` takes ``jax.tree.map(np.asarray, params)`` (dicts
and lists of arrays, nested) and returns a flat dict of tensors in
sorted-name order — the ``jax.tree.flatten`` order the wire layout
depends on — keeping shapes and dtypes. A nested leaf's name joins its
keys with ``/`` (``{"l1": {"wx": a}}`` -> ``"l1/wx"``): ``/`` sorts below
every character of the models' keys, so the sorted flat names keep the
nested tree's flatten order. A list entry's key is its index, zero-padded
to the width of the list's last index (``stages/03/...`` in a list of
ten or more), so sorted names keep list order too (``stages/10`` after
``stages/09``, never before ``stages/2``). Empty dicts and lists hold no
leaf and leave no name.

``params_to_numpy`` nests the names back: a node whose keys are all
digit strings of one width becomes a list. ``like`` (the original tree)
restores the empty nodes as well. Tests and ``chip_smoke.py`` use them so
that both packages start from the same parameters; the port's models
(``models.model``) keep their parameters in this flat form.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

Params = dict[str, torch.Tensor]


def index_key(i: int, n: int) -> str:
    """The flat-name key of entry ``i`` of a list of ``n``."""
    return f"{i:0{len(str(max(n - 1, 0)))}d}"


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts and lists -> flat dict whose names join the keys (a
    list entry's key its zero-padded index) with ``/``."""
    if isinstance(tree, dict):
        items = tree.items()
    else:
        items = ((index_key(i, len(tree)), a) for i, a in enumerate(tree))
    out = {}
    for name, a in items:
        if "/" in name:
            raise ValueError(f"key {name!r} holds the separator '/'")
        if isinstance(a, (dict, list, tuple)):
            out.update(_flatten(a, f"{prefix}{name}/"))
        else:
            out[prefix + name] = a
    return out


def flat_names(tree) -> list[str]:
    """The flat names of a nested tree's leaves, in sorted order."""
    return sorted(_flatten(tree))


def params_from_numpy(tree, *, stack: int | None = None,
                      device=None) -> Params:
    """numpy tree (nested dicts and lists) -> flat tensor dict on
    ``device`` (CUDA unless ``"cpu"``), in sorted-name order; ``stack=m``
    broadcasts every leaf to m stacked client copies."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    out = {}
    for name in sorted(flat):
        a = np.array(flat[name], copy=True)
        if a.dtype.name == "bfloat16":       # ml_dtypes' type: its bits
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if stack is not None:
            t = t.unsqueeze(0).expand((stack,) + tuple(t.shape)).contiguous()
        out[name] = t.to(dev)
    return out


def _listed(node):
    """Dicts whose keys are exactly a list's zero-padded indices (0 to
    n - 1) -> lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listed(v) for k, v in node.items()}
    keys = [index_key(i, len(node)) for i in range(len(node))]
    if node and sorted(node) == keys:
        return [node[k] for k in keys]
    return node


def _like(node, like):
    """``node`` in the structure of ``like``: its empty dicts and lists
    put back (they hold no leaf, so the flat names lost them)."""
    if isinstance(like, dict):
        node = node if isinstance(node, dict) else {}
        return {k: _like(node.get(k, {}), v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        n = len(like)
        if isinstance(node, list):
            node = {index_key(i, n): v for i, v in enumerate(node)}
        node = node if isinstance(node, dict) else {}
        return [_like(node.get(index_key(i, n), {}), v)
                for i, v in enumerate(like)]
    return node


def params_to_numpy(params: Params, like=None):
    """Flat tensor dict -> numpy tree copied to the host: the ``/`` names
    nested back into dicts (sorted keys) and lists; with ``like`` (a tree
    of the original structure) every empty dict and list comes back too."""
    out: dict = {}
    for name in sorted(params):
        *path, leaf = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        t = params[name].detach().cpu()
        if t.dtype is torch.bfloat16:
            # numpy has no bfloat16: its bits, viewed as ml_dtypes' type
            # when that is importable, else widened to f32.
            node[leaf] = _bf16_numpy(t)
        else:
            node[leaf] = t.numpy()
    out = _listed(out)
    return out if like is None else _like(out, like)


def _bf16_numpy(t: torch.Tensor) -> np.ndarray:
    try:
        import ml_dtypes
    except ImportError:
        return t.to(torch.float32).numpy()
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
