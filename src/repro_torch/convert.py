"""Parameters between the JAX package and the port, through numpy.

``params_from_numpy`` takes ``jax.tree.map(np.asarray, params)`` (a dict
of arrays, nested dicts allowed) and returns a flat dict of tensors in
sorted-key order — the ``jax.tree.flatten`` order the wire layout depends
on — keeping shapes and dtypes. A nested leaf's name joins its keys with
``/`` (``{"l1": {"wx": a}}`` -> ``"l1/wx"``): ``/`` sorts below every
character of the models' keys, so the sorted flat names keep the nested
tree's flatten order. ``params_to_numpy`` nests the names back. Tests and
``chip_smoke.py`` use them so that both packages start from the same
parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

Params = dict[str, torch.Tensor]


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> flat dict whose names join the keys with ``/``."""
    out = {}
    for name, a in tree.items():
        if "/" in name:
            raise ValueError(f"key {name!r} holds the separator '/'")
        if isinstance(a, dict):
            out.update(_flatten(a, f"{prefix}{name}/"))
        else:
            out[prefix + name] = a
    return out


def params_from_numpy(tree: dict, *, stack: int | None = None,
                      device=None) -> Params:
    """numpy dict (nested dicts allowed) -> flat tensor dict on ``device``
    (CUDA unless ``"cpu"``), in sorted-name order; ``stack=m`` broadcasts
    every leaf to m stacked client copies."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    out = {}
    for name in sorted(flat):
        t = torch.from_numpy(np.array(flat[name], copy=True))
        if stack is not None:
            t = t.unsqueeze(0).expand((stack,) + tuple(t.shape)).contiguous()
        out[name] = t.to(dev)
    return out


def params_to_numpy(params: Params) -> dict:
    """Flat tensor dict -> numpy dict copied to the host, its ``/`` names
    nested back into dicts (sorted keys)."""
    out: dict = {}
    for name in sorted(params):
        *path, leaf = name.split("/")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = params[name].detach().cpu().numpy()
    return out
