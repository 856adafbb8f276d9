"""Initializers shared by the paper's models."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights from an explicit generator — the same
    distribution as the JAX package's ``dense_init`` (not its bits)."""
    fi = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fi, 1))
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32)
    return (w * std).to(dtype)
