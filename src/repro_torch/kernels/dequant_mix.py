"""The wire decoders, ports of the JAX package's ``kernels/dequant_mix.py``
as the CUDA kernels of ``csrc/dequant_mix.cu``:

B2 ``dequant_mix_buffer`` — whole-buffer fused unpack + dequantize +
   weighted gossip apply for all m clients (``dequant_mix_buffer_pallas``);
B5 ``dequant_mix_momentum_buffer`` — the same decode fused with the
   round's deferred last heavy-ball step
   (``dequant_mix_momentum_buffer_pallas``);
B7 ``dequant_mix_plan`` — one [per, W] buffer, one scale and weight per
   stream of a [k, W] stack (``dequant_mix_plan_pallas``);
B8 ``dequant_mix`` — the ring form (``dequant_mix_pallas``): one launch
   of a kernel of its own over the three stream pointers (own, left,
   right) with the weights (w_self, w_nb, w_nb) by value.

B7 and B8 also take the flat [n] vector the per-tensor entry points hold
(``dequant_mix_plan_flat``, ``dequant_mix_flat``): their kernels read x
[n] as its zero-padded planar view and write only [:n], so a call is one
launch with no pad and no slice; the Pallas-shaped wrappers call the
same C entries with n = per * W.

Unlike the Pallas kernels, which take an already gathered ``[k, W]``
stream stack per client, B2 and B5 take a table of R >= m rows of words
and scales plus the plan's ``src`` table [K, m] into it, and gather each
client's streams themselves: on one device the table is every client's
own words (R = m) and the gather stands in for the ``ppermute``; on a
shard of a client mesh it is the shard's own rows followed by the
boundary rows it received, so no combine scatter is needed. An entry of
``src`` outside [0, R) is refused on the host where the table is built
(and by the plain versions); the kernel never reads it and writes NaN for
that client instead. On CPU tensors a wrapper runs its plain version; on
CUDA tensors it launches its kernel or raises; on ``meta`` tensors it
returns an empty ``meta`` output of the kernel's shape. Each reports its
byte record (``native.report``) on all three.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native
from .ref import (LANE_BLOCK, dequant_mix_buffer_ref,
                  dequant_mix_momentum_buffer_ref, dequant_mix_plan_ref,
                  dequant_mix_ref, pad_planar, planar_pad_len)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ARGTYPES_MOMENTUM = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_ARGTYPES_PLAN = ([ctypes.c_void_p] * 5 + [ctypes.c_int64]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_ARGTYPES_RING = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2
                  + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 2
                  + [ctypes.c_void_p])


def check_rows(src: torch.Tensor, rows: int, m: int) -> None:
    """Refuse a table of fewer than m rows, or a ``src`` [K, m] entry
    outside [0, rows) — read on the host, so only for a CPU tensor (the
    mixers check their numpy tables once, where they build them)."""
    if rows < m:
        raise ValueError(f"words and scales need R >= m rows: R={rows}, "
                         f"m={m}")
    if src.device.type == "cpu" and src.numel() and (
            int(src.min()) < 0 or int(src.max()) >= rows):
        raise ValueError(f"src entries must lie in [0, {rows}), got "
                         f"[{int(src.min())}, {int(src.max())}]")


def dequant_mix_buffer_plain(base: torch.Tensor, words: torch.Tensor,
                             block_scales: torch.Tensor,
                             weights: torch.Tensor, src: torch.Tensor,
                             bits: int) -> torch.Tensor:
    """Plain version of :func:`dequant_mix_buffer`: gather the streams
    through ``src`` from the R-row table, then
    ``ref.dequant_mix_buffer_ref``."""
    check_rows(src, words.shape[0], base.shape[0])
    idx = src.to(torch.int64).t()                      # [m, K]
    return dequant_mix_buffer_ref(base, words[idx], block_scales[idx],
                                  weights, bits)


def _plain(kernel: str, fn, x: torch.Tensor, operands) -> torch.Tensor:
    """A wrapper's CPU or meta path: the plain version ``fn()`` (an empty
    ``meta`` output like x on meta), reported as one call of
    ``kernel``."""
    out = torch.empty_like(x) if native.is_meta(x) else fn()
    native.report(kernel, (x, *operands), (out,))
    return out


def _check_operands(base, words, block_scales, weights, src, bits) -> None:
    if bits not in (2, 4, 8, 16):
        raise ValueError(f"bits must be in (2, 4, 8, 16), got {bits}")
    if base.dim() != 3:
        raise ValueError(f"base must be [m, per, W], got {tuple(base.shape)}")
    m, per, w = base.shape
    if per != 32 // bits or w % LANE_BLOCK:
        raise ValueError(f"bad planar shape {tuple(base.shape)} for "
                         f"{bits} bits")
    if not 0 < m < 65536:
        raise ValueError(f"client count {m} out of range")
    k = src.shape[0]
    rows = words.shape[0] if words.dim() == 2 else -1
    if not m <= rows < 2 ** 31:
        raise ValueError(f"words need R >= m = {m} rows, got "
                         f"{tuple(words.shape)}")
    dev = base.device
    native.require(base, "base", torch.float32)
    native.require(words, "words", torch.int32, (rows, w), dev)
    native.require(block_scales, "block_scales", torch.float32,
                   (rows, w // LANE_BLOCK), dev)
    native.require(weights, "weights", torch.float32, (m, k), dev)
    native.require(src, "src", torch.int32, (k, m), dev)
    native.require_aligned(base, "base")
    native.require_aligned(words, "words")


@native.kernel_entry
def dequant_mix_buffer(base: torch.Tensor, words: torch.Tensor,
                       block_scales: torch.Tensor, weights: torch.Tensor,
                       src: torch.Tensor, bits: int) -> torch.Tensor:
    """out[c] = base[c] + sum_k weights[c, k] * deq(words[src[k, c]],
    block_scales[src[k, c]]), accumulated in f32 in k order.

    base: f32 [m, per, W]; words: int32 [R, W], R >= m (every client's
    own packed stream, then on a mesh shard the received boundary rows);
    block_scales: f32 [R, W // 512]; weights: f32 [m, K]; src: int32
    [K, m] into the R rows — row 0 the client's own stream, row k the
    stream of plan step k. On CUDA, base and words must be 16-byte
    aligned. Returns f32 [m, per, W].
    """
    if base.device.type in ("cpu", "meta"):
        return _plain("dequant_mix_buffer", lambda: dequant_mix_buffer_plain(
            base, words, block_scales, weights, src, bits), base,
            (words, block_scales, weights, src))
    _check_operands(base, words, block_scales, weights, src, bits)
    m, _, w = base.shape
    k = src.shape[0]
    out = torch.empty_like(base)
    fn = native.function("dequant_mix", "dequant_mix_buffer", _ARGTYPES)
    with torch.cuda.device(base.device):
        rc = fn(base.data_ptr(), words.data_ptr(), block_scales.data_ptr(),
                weights.data_ptr(), src.data_ptr(), out.data_ptr(), m,
                words.shape[0], k, w, bits, native.stream_of(base))
    native.check_launch(rc, "dequant_mix_buffer")
    native.report("dequant_mix_buffer",
                  (base, words, block_scales, weights, src), (out,))
    return out


def dequant_mix_momentum_buffer_plain(base: torch.Tensor, words: torch.Tensor,
                                      block_scales: torch.Tensor,
                                      weights: torch.Tensor, src: torch.Tensor,
                                      v: torch.Tensor, g: torch.Tensor, et,
                                      bits: int) -> torch.Tensor:
    """Plain version of :func:`dequant_mix_momentum_buffer`: gather the
    streams through ``src`` from the R-row table, then
    ``ref.dequant_mix_momentum_buffer_ref``."""
    check_rows(src, words.shape[0], base.shape[0])
    idx = src.to(torch.int64).t()                      # [m, K]
    return dequant_mix_momentum_buffer_ref(base, words[idx], block_scales[idx],
                                           weights, v, g, et, bits)


@native.kernel_entry
def dequant_mix_momentum_buffer(base: torch.Tensor, words: torch.Tensor,
                                block_scales: torch.Tensor,
                                weights: torch.Tensor, src: torch.Tensor,
                                v: torch.Tensor, g: torch.Tensor, et,
                                bits: int) -> torch.Tensor:
    """:func:`dequant_mix_buffer` plus the deferred heavy-ball step:
    ``out[c] = [base[c] + sum_k weights[c, k] * deq(words[src[k, c]])]
    + (theta*v[c] - eta*g[c])``, the momentum term added last to the f32
    accumulator. words and block_scales hold R >= m rows, as for B2. v,
    g: f32 [m, per, W]; et = (eta, theta)."""
    operands = (words, block_scales, weights, src, v, g)
    if base.device.type in ("cpu", "meta"):
        return _plain("dequant_mix_momentum_buffer",
                      lambda: dequant_mix_momentum_buffer_plain(
                          base, words, block_scales, weights, src, v, g, et,
                          bits), base, operands)
    _check_operands(base, words, block_scales, weights, src, bits)
    for t, name in ((v, "v"), (g, "g")):
        native.require(t, name, torch.float32, base.shape, base.device)
        native.require_aligned(t, name)
    m, _, w = base.shape
    k = src.shape[0]
    out = torch.empty_like(base)
    fn = native.function("dequant_mix", "dequant_mix_momentum_buffer",
                         _ARGTYPES_MOMENTUM)
    with torch.cuda.device(base.device):
        rc = fn(base.data_ptr(), words.data_ptr(), block_scales.data_ptr(),
                weights.data_ptr(), src.data_ptr(), v.data_ptr(),
                g.data_ptr(), out.data_ptr(), m, words.shape[0], k, w, bits,
                float(np.float32(et[0])), float(np.float32(et[1])),
                native.stream_of(base))
    native.check_launch(rc, "dequant_mix_momentum_buffer")
    native.report("dequant_mix_momentum_buffer", (base, *operands), (out,))
    return out


def _check_bits(bits: int) -> None:
    if bits not in (2, 4, 8, 16):
        raise ValueError(f"bits must be in (2, 4, 8, 16), got {bits}")


def _check_one(x: torch.Tensor, bits: int) -> None:
    _check_bits(bits)
    if x.dim() != 2 or x.shape[0] != 32 // bits or x.shape[1] % LANE_BLOCK:
        raise ValueError(f"bad planar shape {tuple(x.shape)} for {bits} bits")
    native.require(x, "x", torch.float32)


def _check_flat(x: torch.Tensor, bits: int) -> int:
    """Validate a flat f32 x [n]; return the planar width W of n values."""
    _check_bits(bits)
    native.require(x, "x", torch.float32)
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"x must be a non-empty flat [n], got "
                         f"{tuple(x.shape)}")
    return planar_pad_len(x.shape[0], bits)[1]


def _on_planar(fn, x: torch.Tensor, bits: int) -> torch.Tensor:
    """A planar plain version on a flat x [n]: pad, apply, keep [:n]."""
    return fn(pad_planar(x, bits)).reshape(-1)[:x.shape[0]]


def _launch_plan(x: torch.Tensor, streams: torch.Tensor, scales: torch.Tensor,
                 weights: torch.Tensor, bits: int) -> torch.Tensor:
    """One launch of ``csrc/dequant_mix.cu:dequant_mix_plan`` on a flat
    x [n]; returns f32 [n]."""
    w = _check_flat(x, bits)
    k = streams.shape[0]
    native.require(streams, "streams", torch.int32, (k, w), x.device)
    native.require_aligned(streams, "streams")
    native.require(scales, "scales", torch.float32, (k,), x.device)
    native.require(weights, "weights", torch.float32, (k,), x.device)
    out = torch.empty_like(x)
    fn = native.function("dequant_mix", "dequant_mix_plan", _ARGTYPES_PLAN)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), streams.data_ptr(), scales.data_ptr(),
                weights.data_ptr(), out.data_ptr(), x.shape[0], k, w, bits,
                native.stream_of(x))
    native.check_launch(rc, "dequant_mix_plan")
    native.report("dequant_mix_plan", (x, streams, scales, weights), (out,))
    return out


@native.kernel_entry
def dequant_mix_plan(x: torch.Tensor, streams: torch.Tensor,
                     scales: torch.Tensor, weights: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """``x + sum_k weights[k] * deq(streams[k], scales[k])`` in stream
    order: x f32 [per, W]; streams int32 [k, W]; scales, weights f32 [k]
    (runtime). Returns f32 [per, W]. On CUDA, streams must be 16-byte
    aligned."""
    if x.device.type in ("cpu", "meta"):
        return _plain("dequant_mix_plan", lambda: dequant_mix_plan_ref(
            x, streams, scales, weights, bits), x,
            (streams, scales, weights))
    _check_one(x, bits)
    return _launch_plan(x.reshape(-1), streams, scales, weights,
                        bits).view(x.shape)


@native.kernel_entry
def dequant_mix_plan_flat(x: torch.Tensor, streams: torch.Tensor,
                          scales: torch.Tensor, weights: torch.Tensor,
                          bits: int) -> torch.Tensor:
    """:func:`dequant_mix_plan` on a flat f32 x [n], read as its
    zero-padded planar view; streams int32 [k, W] with W =
    ``planar_pad_len(n, bits)[1]``. Returns f32 [n]. On CUDA the call is
    one launch and allocates only its output; x may start at any 4-byte
    boundary, streams on a 16-byte one."""
    if x.device.type in ("cpu", "meta"):
        return _plain("dequant_mix_plan", lambda: _on_planar(
            lambda x2d: dequant_mix_plan_ref(x2d, streams, scales, weights,
                                             bits), x, bits), x,
            (streams, scales, weights))
    return _launch_plan(x, streams, scales, weights, bits)


def _launch_ring(x: torch.Tensor, q_own: torch.Tensor, q_left: torch.Tensor,
                 q_right: torch.Tensor, scales: torch.Tensor, bits: int,
                 w_self: float, w_nb: float) -> torch.Tensor:
    """One launch of ``csrc/dequant_mix.cu:dequant_mix_ring`` on a flat
    x [n]; returns f32 [n]."""
    w = _check_flat(x, bits)
    for q, name in ((q_own, "q_own"), (q_left, "q_left"),
                    (q_right, "q_right")):
        native.require(q, name, torch.int32, (w,), x.device)
        native.require_aligned(q, name)
    native.require(scales, "scales", torch.float32, (3,), x.device)
    out = torch.empty_like(x)
    fn = native.function("dequant_mix", "dequant_mix_ring", _ARGTYPES_RING)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), q_own.data_ptr(), q_left.data_ptr(),
                q_right.data_ptr(), scales.data_ptr(),
                float(np.float32(w_self)), float(np.float32(w_nb)),
                out.data_ptr(), x.shape[0], w, bits, native.stream_of(x))
    native.check_launch(rc, "dequant_mix")
    native.report("dequant_mix", (x, q_own, q_left, q_right, scales), (out,))
    return out


@native.kernel_entry
def dequant_mix(x: torch.Tensor, q_own: torch.Tensor, q_left: torch.Tensor,
                q_right: torch.Tensor, scales: torch.Tensor, bits: int,
                w_self: float, w_nb: float) -> torch.Tensor:
    """Ring form of eq. 7: ``x + w_self*deq(q_own) + w_nb*deq(q_left) +
    w_nb*deq(q_right)``; x f32 [per, W]; q_* int32 [W]; scales f32 [3]
    (own, left, right); the static weights are rounded to f32. On CUDA,
    the three streams must be 16-byte aligned; the call is one launch of
    ``csrc/dequant_mix.cu:dequant_mix_ring`` and allocates only its
    output."""
    if x.device.type in ("cpu", "meta"):
        return _plain("dequant_mix", lambda: dequant_mix_ref(
            x, q_own, q_left, q_right, scales, bits, w_self, w_nb), x,
            (q_own, q_left, q_right, scales))
    _check_one(x, bits)
    return _launch_ring(x.reshape(-1), q_own, q_left, q_right, scales, bits,
                        w_self, w_nb).view(x.shape)


@native.kernel_entry
def dequant_mix_flat(x: torch.Tensor, q_own: torch.Tensor,
                     q_left: torch.Tensor, q_right: torch.Tensor,
                     scales: torch.Tensor, bits: int, w_self: float,
                     w_nb: float) -> torch.Tensor:
    """:func:`dequant_mix` on a flat f32 x [n], read as its zero-padded
    planar view; q_* int32 [W] with W = ``planar_pad_len(n, bits)[1]``.
    Returns f32 [n]. On CUDA the call is one launch and allocates only its
    output; x may start at any 4-byte boundary."""
    if x.device.type in ("cpu", "meta"):
        return _plain("dequant_mix", lambda: _on_planar(
            lambda x2d: dequant_mix_ref(x2d, q_own, q_left, q_right, scales,
                                        bits, w_self, w_nb), x, bits), x,
            (q_own, q_left, q_right, scales))
    return _launch_ring(x, q_own, q_left, q_right, scales, bits, w_self,
                        w_nb)
