"""B2: whole-buffer fused unpack + dequantize + weighted gossip apply.

Port of ``dequant_mix_buffer_pallas`` (JAX package,
``kernels/dequant_mix.py``) as the CUDA kernel ``csrc/dequant_mix.cu``.
One launch decodes and applies every stream for all m clients. Unlike the
Pallas kernel, which takes an already gathered ``[k, W]`` stream stack per
client, this one takes every client's own words once plus the plan's
``src`` table and gathers neighbours' words and scales itself — the index
gather that stands in for the ``ppermute`` on one device.
"""
from __future__ import annotations

import ctypes

import torch

from . import native
from .ref import LANE_BLOCK, dequant_mix_buffer_ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def dequant_mix_buffer_plain(base: torch.Tensor, words: torch.Tensor,
                             block_scales: torch.Tensor,
                             weights: torch.Tensor, src: torch.Tensor,
                             bits: int) -> torch.Tensor:
    """Plain version of :func:`dequant_mix_buffer`: gather the streams
    through ``src``, then ``ref.dequant_mix_buffer_ref``."""
    idx = src.to(torch.int64).t()                      # [m, K]
    return dequant_mix_buffer_ref(base, words[idx], block_scales[idx],
                                  weights, bits)


def dequant_mix_buffer(base: torch.Tensor, words: torch.Tensor,
                       block_scales: torch.Tensor, weights: torch.Tensor,
                       src: torch.Tensor, bits: int) -> torch.Tensor:
    """out[c] = base[c] + sum_k weights[c, k] * deq(words[src[k, c]],
    block_scales[src[k, c]]), accumulated in f32 in k order.

    base: f32 [m, per, W]; words: int32 [m, W] (every client's own
    packed stream); block_scales: f32 [m, W // 512]; weights: f32 [m, K];
    src: int32 [K, m] — row 0 is the identity (own stream first), row k
    the plan step client c receives from. Returns f32 [m, per, W].
    """
    if base.device.type == "cpu":
        return dequant_mix_buffer_plain(base, words, block_scales, weights,
                                        src, bits)
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
    out = torch.empty_like(base)
    fn = native.function("dequant_mix", "dequant_mix_buffer", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = fn(base.data_ptr(), words.data_ptr(), block_scales.data_ptr(),
                weights.data_ptr(), src.data_ptr(), out.data_ptr(), m, k, w,
                bits, native.stream_of(base))
    native.check_launch(rc, "dequant_mix_buffer")
    return out
