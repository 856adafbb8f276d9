"""B3: fused heavy-ball update (paper eq. 4, velocity form).

Port of ``momentum_sgd_pallas`` (JAX package, ``kernels/momentum_sgd.py``)
as the CUDA kernel ``csrc/momentum_sgd.cu``: ``v' = theta*v - eta*g``,
``y' = y + v'`` with runtime f32 eta and theta, one read of (y, v, g) and
one write of (y', v'). One launch serves a whole list of leaves: the C
entry fills a leaf table passed by value (a further launch per 64 leaves),
cuts every leaf into chunks and maps each block to its (leaf, chunk). The
kernel is flat over any contiguous tensor, so the Pallas wrapper's (8,
512) padding and slicing have no counterpart.
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


def momentum_sgd_leaves(ys: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor],
                        gs: Sequence[torch.Tensor], eta: float,
                        theta: float) -> tuple[list, list]:
    """One heavy-ball step over lists of same-shape leaves. Returns the
    lists (y', v').

    On CUDA every leaf must be f32 and contiguous; the whole step is one
    launch (one per 64 leaves). The outputs are views into one allocation,
    each starting on a 16-byte boundary: every y' and v' is contiguous in
    its leaf's shape, but they share storage."""
    if not ys or ys[0].device.type == "cpu":
        outs = [momentum_sgd_ref(y, v, g, eta, theta)
                for y, v, g in zip(ys, vs, gs)]
        return [o[0] for o in outs], [o[1] for o in outs]
    dev = ys[0].device
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
    fn = native.function("momentum_sgd", "momentum_sgd", _ARGTYPES)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = fn(ptrs.ctypes.data, sizes.ctypes.data, len(ys),
                float(np.float32(eta)), float(np.float32(theta)),
                native.stream_of(ys[0]), ctypes.byref(launches))
    native.check_launch(rc, "momentum_sgd", launches.value)
    return y_out, v_out


def momentum_sgd(y: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                 eta: float, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One heavy-ball step on same-shape f32 tensors (a one-leaf table).
    Returns (y', v')."""
    (y_out,), (v_out,) = momentum_sgd_leaves([y], [v], [g], eta, theta)
    return y_out, v_out
