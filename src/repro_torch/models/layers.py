"""Initializers shared by the paper's models."""
from __future__ import annotations

import math

import torch

from .. import prng


def dense_init(key: torch.Tensor, shape, dtype=torch.float32,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from a port PRNG key, the JAX
    package's ``dense_init``: ``prng.normal(key, shape)`` (the bits of
    ``jax.random.normal``, within a few ulp) times ``1 / sqrt(max(fan_in,
    1))`` in double, applied to the f32 draw, then cast to ``dtype``."""
    fi = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fi, 1))
    return (prng.normal(key, tuple(shape)) * std).to(dtype)
