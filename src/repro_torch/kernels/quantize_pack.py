"""The wire encoders, ports of the JAX package's ``kernels/quantize_pack.py``
as the CUDA kernels of ``csrc/quantize_pack.cu``:

B1 ``quantize_pack_buffer`` — whole-buffer quantize + planar bit-pack for
   all m clients with per-lane-block scales (``quantize_pack_buffer_pallas``),
   its stochastic-rounding noise given as a tensor or, keyed, drawn inside
   the kernel from the per-leaf keys and the layout's ``NoiseTable``;
B4 ``momentum_quantize_pack_buffer`` — the same encode fused with the
   round's penultimate heavy-ball step
   (``momentum_quantize_pack_buffer_pallas``), its noise given as a
   tensor or, keyed, drawn inside the kernel as B1 draws it;
B6 ``quantize_pack`` — one [per, W] buffer with one scale
   (``quantize_pack_pallas``): B1's encode in a kernel of its own sized
   for one client, its noise given as a tensor or, keyed, drawn inside
   the kernel from one key as ``uniform(key, (per, W))``.

On CPU tensors a wrapper runs its plain version (``ref``); on CUDA tensors
it launches its kernel or raises; on ``meta`` tensors it returns empty
``meta`` outputs of the kernel's shapes. Each reports its byte record
(``native.report``) on all three.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import prng
from . import native
from .ref import (LANE_BLOCK, NoiseTable, keyed_noise_ref,
                  momentum_quantize_pack_buffer_ref, quantize_pack_buffer_ref,
                  quantize_pack_ref)

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES_KEYED = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
_ARGTYPES_ONE = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_ARGTYPES_ONE_KEYED = ([ctypes.c_void_p] * 2 + [ctypes.c_uint32] * 2
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
_ARGTYPES_MOMENTUM = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                      + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
_ARGTYPES_MOMENTUM_KEYED = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                            + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
                            + [ctypes.c_int] + [ctypes.c_void_p] * 2)


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


@native.kernel_entry
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
    _check_noise_source(noise, keys, table)
    operands = (x, noise if keys is None else keys, block_scales)
    launches = _keyed_launches(table) if keys is not None else 1
    if native.is_meta(x):
        _check_planar(x, bits)
        out = torch.empty((x.shape[0], x.shape[2]), dtype=torch.int32,
                          device=x.device)
        native.report("quantize_pack_buffer", operands, (out,), launches)
        return out
    if x.device.type == "cpu":
        if keys is not None:
            noise = keyed_noise_ref(keys, table, x.shape[1], x.shape[2])
        out = quantize_pack_buffer_ref(x, block_scales, bits, noise)
        native.report("quantize_pack_buffer", operands, (out,), launches)
        return out
    _check_planar(x, bits)
    m, _, w = x.shape
    native.require(x, "x", torch.float32)
    native.require(block_scales, "block_scales", torch.float32,
                   (m, w // LANE_BLOCK), x.device)
    native.require_aligned(x, "x")
    if noise is not None:
        native.require(noise, "noise", torch.float32, x.shape, x.device)
        native.require_aligned(noise, "noise")
    out = torch.empty((m, w), dtype=torch.int32, device=x.device)
    if keys is not None:
        _launch_keyed("quantize_pack_buffer_keyed", _ARGTYPES_KEYED,
                      "quantize_pack_buffer", keys, table, x,
                      x.data_ptr(), keys.data_ptr(), block_scales.data_ptr(),
                      out.data_ptr(), m, w, bits)
        native.report("quantize_pack_buffer", operands, (out,), launches)
        return out
    fn = native.function("quantize_pack", "quantize_pack_buffer", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if noise is None else noise.data_ptr(),
                block_scales.data_ptr(), out.data_ptr(), m, w, bits,
                int(noise is not None), native.stream_of(x))
    native.check_launch(rc, "quantize_pack_buffer")
    native.report("quantize_pack_buffer", operands, (out,))
    return out


def _check_noise_source(noise, keys, table) -> None:
    if keys is not None and (noise is not None or table is None):
        raise ValueError("keyed encode takes keys and a table, not noise")


def _keyed_launches(table: NoiseTable) -> int:
    """A keyed entry's launches: one per 64 leaves of its table."""
    return -(-len(table.sizes) // 64)


def _launch_keyed(symbol: str, argtypes: list, kernel: str,
                  keys: torch.Tensor, table: NoiseTable, like: torch.Tensor,
                  *args) -> None:
    """One call of a keyed C entry (B1 or B4) with the leading ``args``,
    then the whole leaf table, ``like``'s stream and the launch count: the
    entry makes one launch per 64 leaves and refuses a table that does not
    cover ``like``'s columns. Counted under ``kernel``."""
    offs, lw, sizes = _table_arrays(table)
    native.require(keys, "keys", torch.int64, (len(sizes), like.shape[0], 2),
                   like.device)
    fn = native.function("quantize_pack", symbol, argtypes)
    launches = ctypes.c_int(0)
    with torch.cuda.device(like.device):
        rc = fn(*args, offs.ctypes.data, lw.ctypes.data, sizes.ctypes.data,
                len(sizes), native.stream_of(like), ctypes.byref(launches))
    native.check_launch(rc, kernel, launches.value)


@functools.lru_cache(maxsize=64)
def _table_arrays(table: NoiseTable) -> tuple:
    """The table as the C entry takes it, built once per table: word
    offsets int32, leaf words int32, sizes int64."""
    return (np.asarray(table.word_offsets, np.int32),
            np.asarray(table.leaf_words, np.int32),
            np.asarray(table.sizes, np.int64))


@native.kernel_entry
def momentum_quantize_pack_buffer(y: torch.Tensor, v: torch.Tensor,
                                  g: torch.Tensor, x: torch.Tensor,
                                  block_scales: torch.Tensor, bits: int,
                                  et, noise: torch.Tensor | None = None, *,
                                  keys: torch.Tensor | None = None,
                                  table: NoiseTable | None = None
                                  ) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Penultimate heavy-ball step + encode in one pass:
    ``v' = theta*v - eta*g``, ``y' = y + v'``, ``words = pack(Q(y' - x))``.

    y, v, g, x: f32 [m, per, W] planar buffers; block_scales: f32
    [m, W // 512] of the resulting delta; et = (eta, theta). Stochastic
    rounding takes its noise as ``noise`` (f32 like y) or keyed, from
    ``keys`` int64 [n_leaves, m, 2] and the layout's ``table``, as
    :func:`quantize_pack_buffer` does; neither = deterministic floor. On
    CUDA, every input must be 16-byte aligned. Returns (y', v', words
    int32 [m, W]).
    """
    _check_noise_source(noise, keys, table)
    operands = (y, v, g, x, noise if keys is None else keys, block_scales)
    launches = _keyed_launches(table) if keys is not None else 1
    if native.is_meta(y):
        _check_planar(y, bits, "y")
        outs = (torch.empty_like(y), torch.empty_like(v),
                torch.empty((y.shape[0], y.shape[2]), dtype=torch.int32,
                            device=y.device))
        native.report("momentum_quantize_pack_buffer", operands, outs,
                      launches)
        return outs
    if y.device.type == "cpu":
        if keys is not None:
            noise = keyed_noise_ref(keys, table, y.shape[1], y.shape[2])
        outs = momentum_quantize_pack_buffer_ref(y, v, g, x, block_scales,
                                                 bits, et, noise)
        native.report("momentum_quantize_pack_buffer", operands, outs,
                      launches)
        return outs
    _check_planar(y, bits, "y")
    m, _, w = y.shape
    for t, name in ((y, "y"), (v, "v"), (g, "g"), (x, "x"), (noise, "noise")):
        if t is not None:
            native.require(t, name, torch.float32, y.shape, y.device)
            native.require_aligned(t, name)
    native.require(block_scales, "block_scales", torch.float32,
                   (m, w // LANE_BLOCK), y.device)
    y_out = torch.empty_like(y)
    v_out = torch.empty_like(v)
    out = torch.empty((m, w), dtype=torch.int32, device=y.device)
    eta, theta = float(np.float32(et[0])), float(np.float32(et[1]))
    lead = (y.data_ptr(), v.data_ptr(), g.data_ptr(), x.data_ptr())
    tail = (block_scales.data_ptr(), y_out.data_ptr(), v_out.data_ptr(),
            out.data_ptr(), m, w, bits, eta, theta)
    if keys is not None:
        _launch_keyed("momentum_quantize_pack_buffer_keyed",
                      _ARGTYPES_MOMENTUM_KEYED,
                      "momentum_quantize_pack_buffer", keys, table, y,
                      *lead, keys.data_ptr(), *tail)
        native.report("momentum_quantize_pack_buffer", operands,
                      (y_out, v_out, out), launches)
        return y_out, v_out, out
    fn = native.function("quantize_pack", "momentum_quantize_pack_buffer",
                         _ARGTYPES_MOMENTUM)
    with torch.cuda.device(y.device):
        rc = fn(*lead, None if noise is None else noise.data_ptr(), *tail,
                int(noise is not None), native.stream_of(y))
    native.check_launch(rc, "momentum_quantize_pack_buffer")
    native.report("momentum_quantize_pack_buffer", operands,
                  (y_out, v_out, out))
    return y_out, v_out, out


@native.kernel_entry
def quantize_pack(x: torch.Tensor, s: torch.Tensor, bits: int,
                  noise: torch.Tensor | None = None, *,
                  key: torch.Tensor | None = None) -> torch.Tensor:
    """x: f32 [per, W] (per = 32 // bits, W % 512 == 0); s: f32 scale
    (0-dim or [1]) on x's device. Stochastic rounding takes its noise
    either as ``noise`` (f32 like x) or keyed: ``key`` int64 [2] (a raw
    key, on the host or on x's device), from which the kernel draws
    ``prng.uniform(key, (per, W))`` itself; neither = deterministic floor.
    A host key reaches the kernel by value, without a copy to the device.
    Returns int32 [W]."""
    if key is not None and noise is not None:
        raise ValueError("keyed encode takes a key, not noise")
    # A key in x's device memory is an operand; a host key reaches the
    # kernel by value.
    operands = (x, s, noise if key is None
                else key if key.device == x.device else None)
    if native.is_meta(x):
        out = torch.empty((x.shape[1],), dtype=torch.int32, device=x.device)
        native.report("quantize_pack", operands, (out,))
        return out
    if x.device.type == "cpu":
        if key is not None:
            noise = prng.uniform(key.to(x.device), x.shape)
        out = quantize_pack_ref(x, s, bits, noise)
        native.report("quantize_pack", operands, (out,))
        return out
    if x.dim() != 2:
        raise ValueError(f"x must be [per, W], got {tuple(x.shape)}")
    _check_planar(x[None], bits)
    w = x.shape[1]
    native.require(x, "x", torch.float32)
    native.require(s.reshape(1), "s", torch.float32, (1,), x.device)
    if noise is not None:
        native.require(noise, "noise", torch.float32, x.shape, x.device)
    out = torch.empty((w,), dtype=torch.int32, device=x.device)
    if key is not None:
        _launch_one_keyed(x, s, bits, key, out)
        native.report("quantize_pack", operands, (out,))
        return out
    fn = native.function("quantize_pack", "quantize_pack", _ARGTYPES_ONE)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if noise is None else noise.data_ptr(),
                s.data_ptr(), out.data_ptr(), w, bits, int(noise is not None),
                native.stream_of(x))
    native.check_launch(rc, "quantize_pack")
    native.report("quantize_pack", operands, (out,))
    return out


def _launch_one_keyed(x: torch.Tensor, s: torch.Tensor, bits: int,
                      key: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of ``csrc/quantize_pack.cu:quantize_pack_keyed``: a host
    key goes as its two u32 words by value, a key on x's device by
    pointer. Counted under ``quantize_pack``."""
    if key.dtype != torch.int64 or tuple(key.shape) != (2,):
        raise ValueError(f"key must be int64 [2], got {key.dtype} "
                         f"{tuple(key.shape)}")
    if key.device.type == "cpu":
        k1, k2 = (v & 0xFFFFFFFF for v in key.tolist())
        key_ptr = None
    else:
        native.require(key, "key", torch.int64, (2,), x.device)
        k1 = k2 = 0
        key_ptr = key.data_ptr()
    fn = native.function("quantize_pack", "quantize_pack_keyed",
                         _ARGTYPES_ONE_KEYED)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), key_ptr, k1, k2, s.data_ptr(), out.data_ptr(),
                x.shape[1], bits, native.stream_of(x))
    native.check_launch(rc, "quantize_pack")
