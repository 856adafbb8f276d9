"""Plain PyTorch versions of the hand-written kernels (B1-B8).

Each function here computes exactly what its CUDA kernel computes, in the
same operation order, with one torch op per rounding step. On CPU tensors
the kernel wrappers call these; on the card ``chip_smoke.py`` holds every
kernel against them.

Wire format (the JAX package's ``kernels/ref.py``): a flat tensor of n
values is padded to ``per * W`` (``per = 32 // bits``) and viewed as
``[per, W]``; word ``w`` packs the offset-encoded fields of column ``w``:

    word[w] = sum_i (offset_encode(x[i, w]) << (bits * i))

Packed u32 words are carried as ``int32`` bit patterns (computed in
``int64``, then narrowed), since the shift into bit 31 needs an unsigned
or 64-bit carrier and torch's uint32 op coverage is thin.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import prng

LANE_BLOCK = 512  # lane-dim block of the planar layout (multiple of 128)
MASK32 = 0xFFFFFFFF


def planar_pad_len(n: int, bits: int) -> tuple[int, int]:
    """Return (per, W) with per*W >= n, W a multiple of LANE_BLOCK."""
    per = 32 // bits
    w = -(-n // per)
    w = -(-w // LANE_BLOCK) * LANE_BLOCK
    return per, w


def pad_planar(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Flat [n] -> its zero-padded f32 planar view [per, W]."""
    per, w = planar_pad_len(x.shape[0], bits)
    return torch.nn.functional.pad(x.to(torch.float32),
                                   (0, per * w - x.shape[0])).reshape(per, w)


def u32_to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same bit patterns as int32."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def i32_to_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values in int64."""
    return words.to(torch.int64) & MASK32


def _shifts(bits: int, device) -> torch.Tensor:
    per = 32 // bits
    return (torch.arange(per, dtype=torch.int64, device=device)
            * bits)[:, None]


def quantize_pack_buffer_ref(x: torch.Tensor, block_scales: torch.Tensor,
                             bits: int, noise: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Whole-buffer quantize + planar pack with per-lane-block scales.

    x: [..., per, W] f32 (W % LANE_BLOCK == 0); block_scales:
    [..., W // LANE_BLOCK] f32; noise: uniform [0, 1) like x for
    stochastic rounding, None = deterministic floor. Returns int32
    [..., W] (u32 bit patterns).
    """
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    s = block_scales.to(torch.float32).repeat_interleave(LANE_BLOCK, dim=-1)
    a = x.to(torch.float32) / s.unsqueeze(-2)
    k = torch.floor(a)
    if noise is not None:
        k = k + (noise < (a - k)).to(torch.float32)
    k = k.clamp(qmin, qmax).to(torch.int64)
    fields = k + (1 << (bits - 1))
    words = (fields << _shifts(bits, x.device)).sum(dim=-2)
    return u32_to_i32(words)


class NoiseTable(NamedTuple):
    """A wire layout's leaves as keyed B1 and B4 take them: leaf ``l`` owns
    the columns ``[word_offsets[l], word_offsets[l] + leaf_words[l])`` (in
    order, contiguous, each a multiple of ``LANE_BLOCK``) and the first
    ``sizes[l]`` positions of its planar ``[per, leaf_words[l]]`` segment
    in row-major order are real values; the rest is padding."""
    word_offsets: tuple
    leaf_words: tuple
    sizes: tuple


def keyed_noise_ref(keys: torch.Tensor, table: NoiseTable, per: int,
                    W: int) -> torch.Tensor:
    """The stochastic-rounding noise keyed B1 and B4 draw in their kernel,
    in plain torch from the same table: keys int64 [n_leaves, m, 2] -> f32
    [m, per, W]. Position (c, i, w), with ``l`` the leaf whose columns hold
    ``w``, is ``uniform_at(keys[l, c], i * leaf_words[l] + w -
    word_offsets[l])`` where that index is below ``sizes[l]``, else 0."""
    dev = keys.device
    offs = torch.tensor(table.word_offsets, dtype=torch.int64, device=dev)
    col = torch.arange(W, dtype=torch.int64, device=dev)
    leaf = torch.searchsorted(offs, col, right=True) - 1
    lw = torch.tensor(table.leaf_words, dtype=torch.int64, device=dev)[leaf]
    size = torch.tensor(table.sizes, dtype=torch.int64, device=dev)[leaf]
    rows = torch.arange(per, dtype=torch.int64, device=dev)[:, None]
    idx = rows * lw + (col - offs[leaf])                       # [per, W]
    k = (keys & MASK32).permute(1, 0, 2)[:, leaf]              # [m, W, 2]
    u = prng.uniform_at(k[:, None, :, 0], k[:, None, :, 1], idx)
    return torch.where(idx < size, u, torch.zeros((), dtype=u.dtype,
                                                  device=dev))


def _dequant_accumulate(base: torch.Tensor, streams: torch.Tensor,
                        block_scales: torch.Tensor, weights: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """f32 ``base + sum_k weights[..., k] * deq(streams[..., k, :])``,
    own stream first, one rounding per multiply and per add."""
    mask = (1 << bits) - 1
    offset = 1 << (bits - 1)
    shifts = _shifts(bits, base.device)
    scol = block_scales.to(torch.float32).repeat_interleave(LANE_BLOCK,
                                                            dim=-1)
    u = i32_to_u32(streams)
    acc = base.to(torch.float32)
    for k in range(streams.shape[-2]):
        fields = (u[..., k, None, :] >> shifts) & mask
        deq = (fields - offset).to(torch.float32) * scol[..., k, None, :]
        acc = acc + weights[..., k, None, None].to(torch.float32) * deq
    return acc


def dequant_mix_buffer_ref(base: torch.Tensor, streams: torch.Tensor,
                           block_scales: torch.Tensor, weights: torch.Tensor,
                           bits: int) -> torch.Tensor:
    """Whole-buffer fused unpack + dequantize + weighted apply:

        out = base + sum_k weights[..., k] * deq(streams[..., k, :])

    base: [..., per, W]; streams: int32 [..., K, W]; block_scales:
    [..., K, W // LANE_BLOCK]; weights: [..., K]. The accumulation is
    f32, starts at ``base`` and takes the streams in order (own stream
    first, then plan steps), one rounding per multiply and per add.
    """
    return _dequant_accumulate(base, streams, block_scales, weights,
                               bits).to(base.dtype)


def momentum_quantize_pack_buffer_ref(y: torch.Tensor, v: torch.Tensor,
                                      g: torch.Tensor, x: torch.Tensor,
                                      block_scales: torch.Tensor, bits: int,
                                      et, noise: torch.Tensor | None = None
                                      ) -> tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """Fused penultimate heavy-ball step + whole-buffer encode (B4):

        v' = theta*v - eta*g ;  y' = y + v' ;  words = pack(Q(y' - x))

    y/v/g/x: [..., per, W] f32 planar buffers; block_scales:
    [..., W // LANE_BLOCK] — scales of the RESULTING delta, which the
    caller computes from the same expression order; et = (eta, theta).
    Returns (y', v', words int32 [..., W]).
    """
    eta, theta = _f32(et[0]), _f32(et[1])
    v_next = theta * v.to(torch.float32) - eta * g.to(torch.float32)
    y_next = y.to(torch.float32) + v_next
    delta = y_next - x.to(torch.float32)
    words = quantize_pack_buffer_ref(delta, block_scales, bits, noise)
    return y_next.to(y.dtype), v_next.to(v.dtype), words


def dequant_mix_momentum_buffer_ref(base: torch.Tensor,
                                    streams: torch.Tensor,
                                    block_scales: torch.Tensor,
                                    weights: torch.Tensor, v: torch.Tensor,
                                    g: torch.Tensor, et,
                                    bits: int) -> torch.Tensor:
    """Fused mix + deferred heavy-ball step (B5):

        out = [base + sum_k weights[..., k] * deq(streams[..., k, :])]
              + (theta*v - eta*g)

    Shapes as in :func:`dequant_mix_buffer_ref` plus v/g [..., per, W];
    et = (eta, theta). The momentum term is added to the f32 accumulator
    before the cast, as in the JAX kernel.
    """
    eta, theta = _f32(et[0]), _f32(et[1])
    acc = _dequant_accumulate(base, streams, block_scales, weights, bits)
    v_next = theta * v.to(torch.float32) - eta * g.to(torch.float32)
    return (acc + v_next).to(base.dtype)


def quantize_pack_ref(x: torch.Tensor, s: torch.Tensor, bits: int,
                      noise: torch.Tensor | None = None) -> torch.Tensor:
    """B6: quantize + planar pack of one [per, W] buffer with ONE scale
    ``s`` (0-dim f32). Returns int32 [W]."""
    n_blocks = x.shape[-1] // LANE_BLOCK
    return quantize_pack_buffer_ref(x, s.reshape(1).expand(n_blocks), bits,
                                    noise)


def dequant_mix_plan_ref(x: torch.Tensor, streams: torch.Tensor,
                         scales: torch.Tensor, weights: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """B7: ``x + sum_k weights[k] * deq(streams[k], scales[k])`` over one
    [per, W] buffer; streams int32 [k, W], scales/weights f32 [k]."""
    n_blocks = x.shape[-1] // LANE_BLOCK
    sblk = scales.to(torch.float32)[:, None].expand(-1, n_blocks)
    return dequant_mix_buffer_ref(x, streams, sblk, weights, bits)


def ring_weights(w_self: float, w_nb: float, device=None) -> torch.Tensor:
    """The ring decode's static weights (w_self, w_nb, w_nb) as f32,
    written by two fills on the device. A host-to-device copy (or an
    item assignment, which makes one) would wait for the stream."""
    w = torch.full((3,), _f32(w_nb), dtype=torch.float32, device=device)
    w[:1].fill_(_f32(w_self))
    return w


def dequant_mix_ref(x: torch.Tensor, q_own: torch.Tensor,
                    q_left: torch.Tensor, q_right: torch.Tensor,
                    scales: torch.Tensor, bits: int, w_self: float,
                    w_nb: float) -> torch.Tensor:
    """B8: the ring form of eq. 7 over one [per, W] buffer,

        x + w_self*deq(q_own) + w_nb*deq(q_left) + w_nb*deq(q_right)

    q_*: int32 [W]; scales f32 [3] (own, left, right)."""
    return dequant_mix_plan_ref(x, torch.stack([q_own, q_left, q_right]),
                                scales, ring_weights(w_self, w_nb, x.device),
                                bits)


def _f32(v) -> float | torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return float(np.float32(v))


def momentum_sgd_ref(y: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                     eta, theta) -> tuple[torch.Tensor, torch.Tensor]:
    """Heavy-ball (paper eq. 4, velocity form) with f32 eta/theta:

        v' = theta*v - eta*g ;  y' = y + v'
    """
    eta, theta = _f32(eta), _f32(theta)
    v_next = theta * v.to(torch.float32) - eta * g.to(torch.float32)
    y_next = y.to(torch.float32) + v_next
    return y_next.to(y.dtype), v_next.to(v.dtype)
