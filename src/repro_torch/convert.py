"""Parameters between the JAX package and the port, through numpy.

``params_from_numpy`` takes ``jax.tree.map(np.asarray, params)`` (a flat
dict of arrays) and returns a dict of tensors in sorted-key order — the
``jax.tree.flatten`` order the wire layout depends on — keeping names,
shapes and dtypes. Tests and ``chip_smoke.py`` use it so that both
packages start from the same parameters.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

Params = dict[str, torch.Tensor]


def params_from_numpy(tree: dict, *, stack: int | None = None,
                      device=None) -> Params:
    """numpy dict -> tensor dict on ``device`` (CUDA unless ``"cpu"``);
    ``stack=m`` broadcasts every leaf to m stacked client copies."""
    dev = resolve_device(device)
    out = {}
    for name in sorted(tree):
        a = tree[name]
        if isinstance(a, dict):
            raise TypeError(f"leaf {name!r} is a nested dict; only flat "
                            "parameter dicts are supported")
        t = torch.from_numpy(np.array(a, copy=True))
        if stack is not None:
            t = t.unsqueeze(0).expand((stack,) + tuple(t.shape)).contiguous()
        out[name] = t.to(dev)
    return out


def params_to_numpy(params: Params) -> dict[str, np.ndarray]:
    """Tensor dict -> numpy dict (sorted keys), copied to the host."""
    return {n: params[n].detach().cpu().numpy() for n in sorted(params)}
