"""B3: fused heavy-ball update (paper eq. 4, velocity form).

Port of ``momentum_sgd_pallas`` (JAX package, ``kernels/momentum_sgd.py``)
as the CUDA kernel ``csrc/momentum_sgd.cu``: ``v' = theta*v - eta*g``,
``y' = y + v'`` with runtime f32 eta and theta, one read of (y, v, g) and
one write of (y', v'). The kernel is flat over any contiguous tensor, so
the Pallas wrapper's (8, 512) padding and slicing have no counterpart.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native
from .ref import momentum_sgd_ref

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_void_p]


def momentum_sgd(y: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                 eta: float, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One heavy-ball step on same-shape f32 tensors. Returns (y', v')."""
    if y.device.type == "cpu":
        return momentum_sgd_ref(y, v, g, eta, theta)
    native.require(y, "y", torch.float32)
    native.require(v, "v", torch.float32, y.shape, y.device)
    native.require(g, "g", torch.float32, y.shape, y.device)
    y_out = torch.empty_like(y)
    v_out = torch.empty_like(v)
    if y.numel() == 0:
        return y_out, v_out
    fn = native.function("momentum_sgd", "momentum_sgd", _ARGTYPES)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), v.data_ptr(), g.data_ptr(), y_out.data_ptr(),
                v_out.data_ptr(), y.numel(), float(np.float32(eta)),
                float(np.float32(theta)), native.stream_of(y))
    native.check_launch(rc, "momentum_sgd")
    return y_out, v_out
