"""The wire decoders, ports of the JAX package's ``kernels/dequant_mix.py``
as the CUDA kernels of ``csrc/dequant_mix.cu``:

B2 ``dequant_mix_buffer`` — whole-buffer fused unpack + dequantize +
   weighted gossip apply for all m clients (``dequant_mix_buffer_pallas``);
B5 ``dequant_mix_momentum_buffer`` — the same decode fused with the
   round's deferred last heavy-ball step
   (``dequant_mix_momentum_buffer_pallas``);
B7 ``dequant_mix_plan`` — one [per, W] buffer, one scale and weight per
   stream of a [k, W] stack (``dequant_mix_plan_pallas``);
B8 ``dequant_mix`` — the ring form (``dequant_mix_pallas``): B7's kernel
   at k = 3 with the weights (w_self, w_nb, w_nb).

Unlike the Pallas kernels, which take an already gathered ``[k, W]``
stream stack per client, B2 and B5 take every client's own words once plus
the plan's ``src`` table and gather neighbours' words and scales
themselves — the index gather that stands in for the ``ppermute`` on one
device. On CPU tensors a wrapper runs its plain version; on CUDA tensors
it launches its kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import native
from .ref import (LANE_BLOCK, dequant_mix_buffer_ref,
                  dequant_mix_momentum_buffer_ref, dequant_mix_plan_ref,
                  dequant_mix_ref, ring_weights)

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_ARGTYPES_MOMENTUM = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
_ARGTYPES_PLAN = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def dequant_mix_buffer_plain(base: torch.Tensor, words: torch.Tensor,
                             block_scales: torch.Tensor,
                             weights: torch.Tensor, src: torch.Tensor,
                             bits: int) -> torch.Tensor:
    """Plain version of :func:`dequant_mix_buffer`: gather the streams
    through ``src``, then ``ref.dequant_mix_buffer_ref``."""
    idx = src.to(torch.int64).t()                      # [m, K]
    return dequant_mix_buffer_ref(base, words[idx], block_scales[idx],
                                  weights, bits)


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
    dev = base.device
    native.require(base, "base", torch.float32)
    native.require(words, "words", torch.int32, (m, w), dev)
    native.require(block_scales, "block_scales", torch.float32,
                   (m, w // LANE_BLOCK), dev)
    native.require(weights, "weights", torch.float32, (m, k), dev)
    native.require(src, "src", torch.int32, (k, m), dev)
    native.require_aligned(base, "base")
    native.require_aligned(words, "words")


def dequant_mix_buffer(base: torch.Tensor, words: torch.Tensor,
                       block_scales: torch.Tensor, weights: torch.Tensor,
                       src: torch.Tensor, bits: int) -> torch.Tensor:
    """out[c] = base[c] + sum_k weights[c, k] * deq(words[src[k, c]],
    block_scales[src[k, c]]), accumulated in f32 in k order.

    base: f32 [m, per, W]; words: int32 [m, W] (every client's own
    packed stream); block_scales: f32 [m, W // 512]; weights: f32 [m, K];
    src: int32 [K, m] — row 0 is the identity (own stream first), row k
    the plan step client c receives from. On CUDA, base and words must be
    16-byte aligned. Returns f32 [m, per, W].
    """
    if base.device.type == "cpu":
        return dequant_mix_buffer_plain(base, words, block_scales, weights,
                                        src, bits)
    _check_operands(base, words, block_scales, weights, src, bits)
    m, _, w = base.shape
    k = src.shape[0]
    out = torch.empty_like(base)
    fn = native.function("dequant_mix", "dequant_mix_buffer", _ARGTYPES)
    with torch.cuda.device(base.device):
        rc = fn(base.data_ptr(), words.data_ptr(), block_scales.data_ptr(),
                weights.data_ptr(), src.data_ptr(), out.data_ptr(), m, k, w,
                bits, native.stream_of(base))
    native.check_launch(rc, "dequant_mix_buffer")
    return out


def dequant_mix_momentum_buffer_plain(base: torch.Tensor, words: torch.Tensor,
                                      block_scales: torch.Tensor,
                                      weights: torch.Tensor, src: torch.Tensor,
                                      v: torch.Tensor, g: torch.Tensor, et,
                                      bits: int) -> torch.Tensor:
    """Plain version of :func:`dequant_mix_momentum_buffer`: gather the
    streams through ``src``, then ``ref.dequant_mix_momentum_buffer_ref``."""
    idx = src.to(torch.int64).t()                      # [m, K]
    return dequant_mix_momentum_buffer_ref(base, words[idx], block_scales[idx],
                                           weights, v, g, et, bits)


def dequant_mix_momentum_buffer(base: torch.Tensor, words: torch.Tensor,
                                block_scales: torch.Tensor,
                                weights: torch.Tensor, src: torch.Tensor,
                                v: torch.Tensor, g: torch.Tensor, et,
                                bits: int) -> torch.Tensor:
    """:func:`dequant_mix_buffer` plus the deferred heavy-ball step:
    ``out[c] = [base[c] + sum_k weights[c, k] * deq(words[src[k, c]])]
    + (theta*v[c] - eta*g[c])``, the momentum term added last to the f32
    accumulator. v, g: f32 [m, per, W]; et = (eta, theta)."""
    if base.device.type == "cpu":
        return dequant_mix_momentum_buffer_plain(base, words, block_scales,
                                                 weights, src, v, g, et, bits)
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
                g.data_ptr(), out.data_ptr(), m, k, w, bits,
                float(np.float32(et[0])), float(np.float32(et[1])),
                native.stream_of(base))
    native.check_launch(rc, "dequant_mix_momentum_buffer")
    return out


def _launch_plan(x: torch.Tensor, streams: torch.Tensor, scales: torch.Tensor,
                 weights: torch.Tensor, bits: int, kernel: str
                 ) -> torch.Tensor:
    """One launch of ``csrc/dequant_mix.cu:dequant_mix_plan``, counted
    under ``kernel``."""
    if bits not in (2, 4, 8, 16):
        raise ValueError(f"bits must be in (2, 4, 8, 16), got {bits}")
    if x.dim() != 2 or x.shape[0] != 32 // bits or x.shape[1] % LANE_BLOCK:
        raise ValueError(f"bad planar shape {tuple(x.shape)} for {bits} bits")
    k, w = streams.shape[0], x.shape[1]
    native.require(x, "x", torch.float32)
    native.require(streams, "streams", torch.int32, (k, w), x.device)
    native.require(scales, "scales", torch.float32, (k,), x.device)
    native.require(weights, "weights", torch.float32, (k,), x.device)
    out = torch.empty_like(x)
    fn = native.function("dequant_mix", "dequant_mix_plan", _ARGTYPES_PLAN)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), streams.data_ptr(), scales.data_ptr(),
                weights.data_ptr(), out.data_ptr(), k, w, bits,
                native.stream_of(x))
    native.check_launch(rc, kernel)
    return out


def dequant_mix_plan(x: torch.Tensor, streams: torch.Tensor,
                     scales: torch.Tensor, weights: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """``x + sum_k weights[k] * deq(streams[k], scales[k])`` in stream
    order: x f32 [per, W]; streams int32 [k, W]; scales, weights f32 [k]
    (runtime). Returns f32 [per, W]."""
    if x.device.type == "cpu":
        return dequant_mix_plan_ref(x, streams, scales, weights, bits)
    return _launch_plan(x, streams, scales, weights, bits, "dequant_mix_plan")


def dequant_mix(x: torch.Tensor, q_own: torch.Tensor, q_left: torch.Tensor,
                q_right: torch.Tensor, scales: torch.Tensor, bits: int,
                w_self: float, w_nb: float) -> torch.Tensor:
    """Ring form of eq. 7: ``x + w_self*deq(q_own) + w_nb*deq(q_left) +
    w_nb*deq(q_right)``; x f32 [per, W]; q_* int32 [W]; scales f32 [3]
    (own, left, right); the static weights are rounded to f32."""
    if x.device.type == "cpu":
        return dequant_mix_ref(x, q_own, q_left, q_right, scales, bits,
                               w_self, w_nb)
    return _launch_plan(x, torch.stack([q_own, q_left, q_right]), scales,
                        ring_weights(w_self, w_nb, x.device), bits,
                        "dequant_mix")
