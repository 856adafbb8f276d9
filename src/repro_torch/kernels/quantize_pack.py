"""The wire encoders, ports of the JAX package's ``kernels/quantize_pack.py``
as the CUDA kernels of ``csrc/quantize_pack.cu``:

B1 ``quantize_pack_buffer`` — whole-buffer quantize + planar bit-pack for
   all m clients with per-lane-block scales (``quantize_pack_buffer_pallas``),
   its stochastic-rounding noise given as a tensor or, keyed, drawn inside
   the kernel from the per-leaf keys and the layout's ``NoiseTable``;
B4 ``momentum_quantize_pack_buffer`` — the same encode fused with the
   round's penultimate heavy-ball step
   (``momentum_quantize_pack_buffer_pallas``);
B6 ``quantize_pack`` — one [per, W] buffer with one scale
   (``quantize_pack_pallas``): B1's kernel with a scale stride of 0.

On CPU tensors a wrapper runs its plain version (``ref``); on CUDA tensors
it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import native
from .ref import (LANE_BLOCK, NoiseTable, keyed_noise_ref,
                  momentum_quantize_pack_buffer_ref, quantize_pack_buffer_ref,
                  quantize_pack_ref)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES_KEYED = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
_ARGTYPES_ONE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGTYPES_MOMENTUM = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                      + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _check_planar(x: torch.Tensor, bits: int, name: str = "x") -> None:
    if bits not in (2, 4, 8, 16):
        raise ValueError(f"bits must be in (2, 4, 8, 16), got {bits}")
    if x.dim() != 3:
        raise ValueError(f"{name} must be [m, per, W], got {tuple(x.shape)}")
    m, per, w = x.shape
    if per != 32 // bits or w % LANE_BLOCK:
        raise ValueError(f"bad planar shape {tuple(x.shape)} for {bits} bits")
    if not 0 < m < 65536:
        raise ValueError(f"client count {m} out of range")


def quantize_pack_buffer(x: torch.Tensor, block_scales: torch.Tensor,
                         bits: int, noise: torch.Tensor | None = None, *,
                         keys: torch.Tensor | None = None,
                         table: NoiseTable | None = None) -> torch.Tensor:
    """x: [m, per, W] f32 planar buffers (per = 32 // bits, W % 512 == 0);
    block_scales: f32 [m, W // 512]. Stochastic rounding takes its noise
    either as ``noise`` (f32 like x) or keyed: ``keys`` int64 [n_leaves,
    m, 2] (the raw per-leaf keys) with the layout's ``table``, from which
    the kernel draws the same noise itself (``keyed_noise_ref``); neither
    = deterministic floor. On CUDA, x (and noise) must be 16-byte aligned.
    Returns int32 [m, W] (u32 bit patterns)."""
    if keys is not None and (noise is not None or table is None):
        raise ValueError("keyed encode takes keys and a table, not noise")
    if x.device.type == "cpu":
        if keys is not None:
            noise = keyed_noise_ref(keys, table, x.shape[1], x.shape[2])
        return quantize_pack_buffer_ref(x, block_scales, bits, noise)
    _check_planar(x, bits)
    m, _, w = x.shape
    native.require(x, "x", torch.float32)
    native.require(block_scales, "block_scales", torch.float32,
                   (m, w // LANE_BLOCK), x.device)
    _require_aligned(x, "x")
    if noise is not None:
        native.require(noise, "noise", torch.float32, x.shape, x.device)
        _require_aligned(noise, "noise")
    out = torch.empty((m, w), dtype=torch.int32, device=x.device)
    if keys is not None:
        _keyed_launches(x, block_scales, bits, keys, table, out)
        return out
    fn = native.function("quantize_pack", "quantize_pack_buffer", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if noise is None else noise.data_ptr(),
                block_scales.data_ptr(), out.data_ptr(), m, w, bits,
                int(noise is not None), native.stream_of(x))
    native.check_launch(rc, "quantize_pack_buffer")
    return out


def _require_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _keyed_launches(x, block_scales, bits, keys, table, out) -> None:
    """Keyed B1 over the whole table: the C entry makes one launch per 64
    leaves and refuses a table that does not cover x's columns."""
    m, _, w = x.shape
    offs, lw, sizes = _table_arrays(table)
    native.require(keys, "keys", torch.int64, (len(sizes), m, 2), x.device)
    fn = native.function("quantize_pack", "quantize_pack_buffer_keyed",
                         _ARGTYPES_KEYED)
    launches = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), keys.data_ptr(), block_scales.data_ptr(),
                out.data_ptr(), m, w, bits, offs.ctypes.data,
                lw.ctypes.data, sizes.ctypes.data, len(sizes),
                native.stream_of(x), ctypes.byref(launches))
    native.check_launch(rc, "quantize_pack_buffer", launches.value)


@functools.lru_cache(maxsize=64)
def _table_arrays(table: NoiseTable) -> tuple:
    """The table as the C entry takes it, built once per table: word
    offsets int32, leaf words int32, sizes int64."""
    return (np.asarray(table.word_offsets, np.int32),
            np.asarray(table.leaf_words, np.int32),
            np.asarray(table.sizes, np.int64))


def momentum_quantize_pack_buffer(y: torch.Tensor, v: torch.Tensor,
                                  g: torch.Tensor, x: torch.Tensor,
                                  block_scales: torch.Tensor, bits: int,
                                  et, noise: torch.Tensor | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Penultimate heavy-ball step + encode in one pass:
    ``v' = theta*v - eta*g``, ``y' = y + v'``, ``words = pack(Q(y' - x))``.

    y, v, g, x: f32 [m, per, W] planar buffers; block_scales: f32
    [m, W // 512] of the resulting delta; et = (eta, theta); noise: f32
    like y (stochastic) or None. Returns (y', v', words int32 [m, W]).
    """
    if y.device.type == "cpu":
        return momentum_quantize_pack_buffer_ref(y, v, g, x, block_scales,
                                                 bits, et, noise)
    _check_planar(y, bits, "y")
    m, _, w = y.shape
    native.require(y, "y", torch.float32)
    for t, name in ((v, "v"), (g, "g"), (x, "x")):
        native.require(t, name, torch.float32, y.shape, y.device)
    native.require(block_scales, "block_scales", torch.float32,
                   (m, w // LANE_BLOCK), y.device)
    if noise is not None:
        native.require(noise, "noise", torch.float32, y.shape, y.device)
    y_out = torch.empty_like(y)
    v_out = torch.empty_like(v)
    out = torch.empty((m, w), dtype=torch.int32, device=y.device)
    fn = native.function("quantize_pack", "momentum_quantize_pack_buffer",
                         _ARGTYPES_MOMENTUM)
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), v.data_ptr(), g.data_ptr(), x.data_ptr(),
                None if noise is None else noise.data_ptr(),
                block_scales.data_ptr(), y_out.data_ptr(), v_out.data_ptr(),
                out.data_ptr(), m, w, bits, float(np.float32(et[0])),
                float(np.float32(et[1])), int(noise is not None),
                native.stream_of(y))
    native.check_launch(rc, "momentum_quantize_pack_buffer")
    return y_out, v_out, out


def quantize_pack(x: torch.Tensor, s: torch.Tensor, bits: int,
                  noise: torch.Tensor | None = None) -> torch.Tensor:
    """x: f32 [per, W] (per = 32 // bits, W % 512 == 0); s: f32 scale
    (0-dim or [1]) on x's device; noise: f32 like x or None. Returns int32
    [W]."""
    if x.device.type == "cpu":
        return quantize_pack_ref(x, s, bits, noise)
    if x.dim() != 2:
        raise ValueError(f"x must be [per, W], got {tuple(x.shape)}")
    _check_planar(x[None], bits)
    w = x.shape[1]
    native.require(x, "x", torch.float32)
    native.require(s.reshape(1), "s", torch.float32, (1,), x.device)
    _require_aligned(x, "x")
    if noise is not None:
        native.require(noise, "noise", torch.float32, x.shape, x.device)
        _require_aligned(noise, "noise")
    out = torch.empty((w,), dtype=torch.int32, device=x.device)
    fn = native.function("quantize_pack", "quantize_pack", _ARGTYPES_ONE)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if noise is None else noise.data_ptr(),
                s.data_ptr(), out.data_ptr(), w, bits, int(noise is not None),
                native.stream_of(x))
    native.check_launch(rc, "quantize_pack")
    return out
