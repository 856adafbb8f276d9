"""B3: fused heavy-ball update (paper eq. 4, velocity form).

Port of ``momentum_sgd_pallas`` (JAX package, ``kernels/momentum_sgd.py``)
as the CUDA kernel ``csrc/momentum_sgd.cu``: ``v' = theta*v - eta*g``,
``y' = y + v'`` with runtime f32 eta and theta, computed in f32 and
stored in the leaf's dtype (f32 or bf16), one read of (y, v, g) and one
write of (y', v'). One launch serves a whole list of leaves of one dtype
(a list mixing f32 and bf16 takes one a dtype): the C entry fills a leaf
table passed by value (a further launch per 64 leaves), cuts every leaf
into chunks and maps each block to its (leaf, chunk). The
kernel is flat over any contiguous tensor, so the Pallas wrapper's (8,
512) padding and slicing have no counterpart.

eta is a host float (one value, a kernel parameter) or a device f32
tensor [m], one per client of leaves [m, ...] (the async engine's
staleness-decayed step): the lane entry ``momentum_sgd_lanes`` reads it at
launch, so a captured graph follows its changes.

On CPU tensors the step runs its plain version, on ``meta`` tensors it
returns empty ``meta`` outputs; on all three each dtype group reports one
byte record (``native.report``: y, v, g, a lane eta, then y', v').
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
# The C entry of each leaf dtype B3 takes: its name's suffix.
_ENTRY_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float] + [ctypes.c_void_p] * 2
_LANE_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_int64, ctypes.c_float,
                                          ctypes.c_void_p, ctypes.c_void_p]


@functools.lru_cache(maxsize=64)
def out_offsets(sizes: tuple, align: int = ALIGN
                ) -> tuple[list[int], int, np.ndarray]:
    """Where each leaf's output starts in one allocation, every offset
    rounded up to ``align`` values (16 bytes: 4 in f32, 8 in bf16) so the
    kernel's four-value path takes every leaf; the allocation's length (a
    multiple of ``align``); and the sizes as the int64 host array the C
    entry takes. Built once per tuple of sizes."""
    offs, at = [], 0
    for n in sizes:
        offs.append(at)
        at += -(-n // align) * align
    return offs, at, np.array(sizes, np.int64)


def momentum_sgd_lanes_ref(y: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, eta: torch.Tensor, theta: float
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lane entry's plain version: ``momentum_sgd_ref`` with client
    c's values (``y[c]``, leaves [m, ...]) stepping with ``eta[c]``."""
    return momentum_sgd_ref(
        y, v, g, eta.reshape((-1,) + (1,) * (y.dim() - 1)), theta)


def _dtype_groups(ys) -> dict:
    """Leaf indices by the dtype of B3's entry that takes them, in order
    of first appearance."""
    groups: dict = {}
    for i, y in enumerate(ys):
        dtype = y.dtype if y.dtype in _ENTRY_SUFFIX else torch.float32
        groups.setdefault(dtype, []).append(i)
    return groups


def _report_groups(ys, vs, gs, y_out, v_out, eta) -> None:
    """The byte records of a CPU or meta step: one a dtype group, with
    the launches its C entry would make (one per 64 leaves of which one
    is not empty)."""
    if not native.RECORDERS:
        return
    kernel = ("momentum_sgd_lanes" if isinstance(eta, torch.Tensor)
              else "momentum_sgd")
    lane_eta = eta if isinstance(eta, torch.Tensor) else None
    for idx in _dtype_groups(ys).values():
        sizes = [ys[i].numel() for i in idx]
        launches = sum(any(sizes[j:j + 64]) for j in range(0, len(idx), 64))
        native.report(kernel, [t[i] for t in (ys, vs, gs) for i in idx]
                      + [lane_eta],
                      [t[i] for t in (y_out, v_out) for i in idx], launches)


@native.kernel_entry
def momentum_sgd_leaves(ys: Sequence[torch.Tensor],
                        vs: Sequence[torch.Tensor],
                        gs: Sequence[torch.Tensor],
                        eta: float | torch.Tensor,
                        theta: float) -> tuple[list, list]:
    """One heavy-ball step over lists of same-shape leaves. Returns the
    lists (y', v').

    ``eta`` is a float, or an f32 tensor [m] on the leaves' device with
    every leaf [m, ...]: client c's values step with ``eta[c]`` (the lane
    entry). On CUDA every leaf must be f32 or bf16 (its y, v and g of one
    dtype) and contiguous; the step is one launch a dtype among the
    leaves (one per 64 leaves of it), computing in f32 and storing in the
    leaf's dtype. The outputs are views into one allocation a dtype, each
    starting on a 16-byte boundary: every y' and v' is contiguous in its
    leaf's shape, but they share storage."""
    lanes = isinstance(eta, torch.Tensor)
    if not ys or ys[0].device.type in ("cpu", "meta"):
        if ys and native.is_meta(ys[0]):
            outs = [(torch.empty_like(y), torch.empty_like(v))
                    for y, v in zip(ys, vs)]
        else:
            plain = momentum_sgd_lanes_ref if lanes else momentum_sgd_ref
            outs = [plain(y, v, g, eta, theta)
                    for y, v, g in zip(ys, vs, gs)]
        y_out, v_out = [o[0] for o in outs], [o[1] for o in outs]
        _report_groups(ys, vs, gs, y_out, v_out, eta)
        return y_out, v_out
    dev = ys[0].device
    if lanes:
        native.require(eta, "eta", torch.float32, device=dev)
        m = eta.shape[0] if eta.dim() == 1 else -1
        if m < 1 or any(y.dim() == 0 or y.shape[0] != m for y in ys):
            raise ValueError(f"a lane eta must be [m] for leaves [m, ...], "
                             f"got {tuple(eta.shape)}")
    return _launch_groups(ys, vs, gs, eta, theta, dev)


def _launch_groups(ys, vs, gs, eta, theta: float, dev: torch.device
                   ) -> tuple[list, list]:
    """Check every leaf, group the leaves by dtype (in order of first
    appearance) and run B3 on each group: (y', v') in the leaves' order."""
    groups = _dtype_groups(ys)
    for dtype, idx in groups.items():
        for i in idx:
            y = ys[i]
            for t, name in ((y, "y"), (vs[i], "v"), (gs[i], "g")):
                # One cheap test per tensor; require() names the fault.
                if (t.dtype is not dtype or t.shape != y.shape
                        or not t.is_contiguous() or t.device != dev):
                    native.require(t, f"{name}[{i}]", dtype, y.shape, dev)
    y_out, v_out = [None] * len(ys), [None] * len(ys)
    for dtype, idx in groups.items():
        yo, vo = _step_group([ys[i] for i in idx], [vs[i] for i in idx],
                             [gs[i] for i in idx], eta, theta, dtype, dev)
        for j, i in enumerate(idx):
            y_out[i], v_out[i] = yo[j], vo[j]
    return y_out, v_out


def _step_group(ys, vs, gs, eta, theta: float, dtype: torch.dtype,
                dev: torch.device) -> tuple[list, list]:
    """B3 over leaves of one dtype (checked by the caller): its entry for
    that dtype, one launch per 64 leaves."""
    align = 16 // torch.empty((), dtype=dtype).element_size()
    offs, total, sizes = out_offsets(tuple(y.numel() for y in ys), align)
    flat = torch.empty(2 * total, dtype=dtype, device=dev)
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
    suffix = _ENTRY_SUFFIX[dtype]
    with torch.cuda.device(dev):
        if isinstance(eta, torch.Tensor):
            kernel = "momentum_sgd_lanes"
            rc = native.function("momentum_sgd", kernel + suffix,
                                 _LANE_ARGTYPES)(
                ptrs.ctypes.data, sizes.ctypes.data, len(ys),
                eta.data_ptr(), eta.shape[0], theta32,
                native.stream_of(ys[0]), ctypes.byref(launches))
        else:
            kernel = "momentum_sgd"
            rc = native.function("momentum_sgd", kernel + suffix,
                                 _ARGTYPES)(
                ptrs.ctypes.data, sizes.ctypes.data, len(ys),
                float(np.float32(eta)), theta32, native.stream_of(ys[0]),
                ctypes.byref(launches))
    native.check_launch(rc, kernel, launches.value)
    if native.RECORDERS:
        native.report(kernel, [*ys, *vs, *gs, eta if isinstance(
            eta, torch.Tensor) else None], [*y_out, *v_out], launches.value)
    return y_out, v_out


def momentum_sgd(y: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                 eta: float, theta: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One heavy-ball step on same-shape f32 or bf16 tensors (a one-leaf
    table).
    Returns (y', v')."""
    (y_out,), (v_out,) = momentum_sgd_leaves([y], [v], [g], eta, theta)
    return y_out, v_out
