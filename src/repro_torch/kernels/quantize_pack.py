"""B1: whole-buffer quantize + planar bit-pack (the wire encoder).

Port of ``quantize_pack_buffer_pallas`` (JAX package,
``kernels/quantize_pack.py``) as the CUDA kernel ``csrc/quantize_pack.cu``.
One launch encodes all m clients' planar buffers with per-lane-block
scales. On CPU tensors the wrapper runs the plain version
(``ref.quantize_pack_buffer_ref``); on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import native
from .ref import LANE_BLOCK, quantize_pack_buffer_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def quantize_pack_buffer(x: torch.Tensor, block_scales: torch.Tensor,
                         bits: int, noise: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """x: [m, per, W] f32 planar buffers (per = 32 // bits, W % 512 == 0);
    block_scales: f32 [m, W // 512]; noise: f32 like x for stochastic
    rounding, None = deterministic floor. Returns int32 [m, W] (u32 bit
    patterns)."""
    if x.device.type == "cpu":
        return quantize_pack_buffer_ref(x, block_scales, bits, noise)
    if bits not in (2, 4, 8, 16):
        raise ValueError(f"bits must be in (2, 4, 8, 16), got {bits}")
    if x.dim() != 3:
        raise ValueError(f"x must be [m, per, W], got {tuple(x.shape)}")
    m, per, w = x.shape
    if per != 32 // bits or w % LANE_BLOCK:
        raise ValueError(f"bad planar shape {tuple(x.shape)} for {bits} bits")
    if not 0 < m < 65536:
        raise ValueError(f"client count {m} out of range")
    native.require(x, "x", torch.float32)
    native.require(block_scales, "block_scales", torch.float32,
                   (m, w // LANE_BLOCK), x.device)
    if noise is not None:
        native.require(noise, "noise", torch.float32, x.shape, x.device)
    out = torch.empty((m, w), dtype=torch.int32, device=x.device)
    fn = native.function("quantize_pack", "quantize_pack_buffer", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), None if noise is None else noise.data_ptr(),
                block_scales.data_ptr(), out.data_ptr(), m, w, bits,
                int(noise is not None), native.stream_of(x))
    native.check_launch(rc, "quantize_pack_buffer")
    return out
