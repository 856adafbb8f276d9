"""Public wrappers around the kernels, and their launch counters.

``momentum_update`` is the counterpart of the JAX package's
``kernels.ops.make_fused_momentum_update``: the heavy-ball step over a
dict of parameter leaves, one B3 launch per leaf on the card.
"""
from __future__ import annotations

import torch

from . import native
from .momentum_sgd import momentum_sgd

Params = dict[str, torch.Tensor]


def momentum_update(y: Params, v: Params, g: Params, eta: float,
                    theta: float) -> tuple[Params, Params]:
    """(y', v') with ``v' = theta*v - eta*g`` and ``y' = y + v'`` leaf by
    leaf, in ``y``'s key order."""
    ys, vs = {}, {}
    for name, yl in y.items():
        ys[name], vs[name] = momentum_sgd(yl, v[name], g[name], eta, theta)
    return ys, vs


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(native.LAUNCHES)


def reset_launch_counts() -> None:
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
