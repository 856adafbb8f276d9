"""B3: fused heavy-ball update (paper eq. 4, velocity form).

Port of ``momentum_sgd_pallas`` (JAX package, ``kernels/momentum_sgd.py``)
as the CUDA kernel ``csrc/momentum_sgd.cu``: ``v' = theta*v - eta*g``,
``y' = y + v'`` with runtime f32 eta and theta, one read of (y, v, g) and
one write of (y', v'). One launch serves a whole list of leaves: the C
entry fills a leaf table passed by value (a further launch per 64 leaves),
cuts every leaf into chunks and maps each block to its (leaf, chunk). The
kernel is flat over any contiguous tensor, so the Pallas wrapper's (8,
512) padding and slicing have no counterpart.

eta is a host float (one value, a kernel parameter) or a device f32
tensor [m], one per client of leaves [m, ...] (the async engine's
staleness-decayed step): the lane entry ``momentum_sgd_lanes`` reads it at
launch, so a captured graph follows its changes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import native
from .ref import momentum_sgd_ref

ALIGN = 4          # f32 values in 16 bytes: outputs start on this grid

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float] + [ctypes.c_void_p] * 2
_LANE_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_int64, ctypes.c_float,
                                          ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=64)
def out_offsets(sizes: tuple) -> tuple[list[int], int, np.ndarray]:
    """Where each leaf's output starts in one f32 allocation, every offset
    rounded up to 16 bytes so the kernel's float4 path takes every leaf;
    the allocation's length (a multiple of ``ALIGN``); and the sizes as the
    int64 host array the C entry takes. Built once per tuple of sizes."""
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += -(-n // ALIGN) * ALIGN
    return offs, at, np.array(sizes, np.int64)


def momentum_sgd_lanes_ref(y: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, eta: torch.Tensor, theta: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lane entry's plain version: ``momentum_sgd_ref`` with client
    c's values (``y[c]``, leaves [m, ...]) stepping with ``eta[c]``."""
    return momentum_sgd_ref(
        y, v, g, eta.reshape((-1,) + (1,) * (y.dim() - 1)), theta)


def momentum_sgd_leaves(ys: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor],
                        gs: Sequence[torch.Tensor],
                        eta: float | torch.Tensor,
                        theta: float) -> tuple[list, list]:
    """One heavy-ball step over lists of same-shape leaves. Returns the
    lists (y', v').

    ``eta`` is a float, or an f32 tensor [m] on the leaves' device with
    every leaf [m, ...]: client c's values step with ``eta[c]`` (the lane
    entry). On CUDA every leaf must be f32 and contiguous; the whole step
    is one launch (one per 64 leaves). The outputs are views into one
    allocation, each starting on a 16-byte boundary: every y' and v' is
    contiguous in its leaf's shape, but they share storage."""
    lanes = isinstance(eta, torch.Tensor)
    if not ys or ys[0].device.type == "cpu":
        plain = momentum_sgd_lanes_ref if lanes else momentum_sgd_ref
        outs = [plain(y, v, g, eta, theta) for y, v, g in zip(ys, vs, gs)]
        return [o[0] for o in outs], [o[1] for o in outs]
    dev = ys[0].device
    if lanes:
        native.require(eta, "eta", torch.float32, device=dev)
        m = eta.shape[0] if eta.dim() == 1 else -1
        if m < 1 or any(y.dim() == 0 or y.shape[0] != m for y in ys):
            raise ValueError(f"a lane eta must be [m] for leaves [m, ...], "
                             f"got {tuple(eta.shape)}")
    for i, (y, v, g) in enumerate(zip(ys, vs, gs)):
        for t, name in ((y, "y"), (v, "v"), (g, "g")):
            # One cheap test per tensor; require() names the fault.
            if (t.dtype is not torch.float32 or t.shape != y.shape
                    or not t.is_contiguous() or t.device != dev):
                native.require(t, f"{name}[{i}]", torch.float32, y.shape,
                               dev)
    offs, total, sizes = out_offsets(tuple(y.numel() for y in ys))
    flat = torch.empty(2 * total, dtype=torch.float32, device=dev)
    # as_strided makes each view in one call (cheaper on the host than
    # slicing and reshaping); every leaf is contiguous.
    y_out = [flat.as_strided(y.shape, y.stride(), o)
             for y, o in zip(ys, offs)]
    v_out = [flat.as_strided(y.shape, y.stride(), total + o)
             for y, o in zip(ys, offs)]
    ptrs = np.array([[t.data_ptr() for t in row]
                     for row in zip(ys, vs, gs, y_out, v_out)],
                    dtype=np.uint64)
    launches = ctypes.c_int(0)
    theta32 = float(np.float32(theta))
    with torch.cuda.device(dev):
        if lanes:
            kernel = "momentum_sgd_lanes"
            rc = native.function("momentum_sgd", kernel, _LANE_ARGTYPES)(
                ptrs.ctypes.data, sizes.ctypes.data, len(ys),
                eta.data_ptr(), m, theta32, native.stream_of(ys[0]),
                ctypes.byref(launches))
        else:
            kernel = "momentum_sgd"
            rc = native.function("momentum_sgd", kernel, _ARGTYPES)(
                ptrs.ctypes.data, sizes.ctypes.data, len(ys),
                float(np.float32(eta)), theta32, native.stream_of(ys[0]),
                ctypes.byref(launches))
    native.check_launch(rc, kernel, launches.value)
    return y_out, v_out


def momentum_sgd(y: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                 eta: float, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One heavy-ball step on same-shape f32 tensors (a one-leaf table).
    Returns (y', v')."""
    (y_out,), (v_out,) = momentum_sgd_leaves([y], [v], [g], eta, theta)
    return y_out, v_out
