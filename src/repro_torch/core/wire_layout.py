"""Flat wire-buffer layout — the planar half of the JAX package's
``core/wire_layout.py``.

A client's parameter dict is flattened once per round into a single
planar ``[per, W]`` buffer (``per = 32 // bits``, ``W`` a multiple of
``LANE_BLOCK``), each leaf in a block-aligned column segment, so the
encode (B1, or B4 in the fused round) and the fused decode-apply (B2, or
B5) each run once per round over one contiguous array for all m clients.
The fp32 wire is a plain concatenation (``flatten_f32``).

Invariants (as in the JAX package):

  * LEAF ORDER is ``jax.tree.flatten`` order, i.e. sorted dict keys (the
    2NN flattens as b1, b2, b3, w1, w2, w3). The leaf index selects the
    row of per-leaf noise keys, so any other order changes every
    stochastic-rounding bit.
  * LANE-ALIGNED SEGMENTS: every leaf starts on a ``LANE_BLOCK``
    boundary; ``to_planar``/``from_planar`` round-trip exactly.
  * PER-LEAF SCALES: one scale per (client, leaf), the same
    ``max|x| * (1/qmax)`` (0 -> 1.0) as the dense path.
  * Padding is zero, its noise is zero, and it encodes to the zero
    level's field: it never rounds up.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import prng
from ..kernels.dequant_mix import (dequant_mix_buffer,
                                   dequant_mix_momentum_buffer)
from ..kernels.quantize_pack import (momentum_quantize_pack_buffer,
                                     quantize_pack_buffer)
from ..kernels.ref import LANE_BLOCK, NoiseTable
from .quantize import scale_from_amax

Params = dict[str, torch.Tensor]

__all__ = ["WireLayout", "LANE_BLOCK"]


@dataclasses.dataclass(frozen=True)
class WireLayout:
    """Planar layout of one client's parameter dict on the wire.

    Leaf ``i`` (key ``names[i]``, flat size ``sizes[i]``) occupies
    columns ``[word_offsets[i], word_offsets[i] + leaf_words[i])`` of the
    ``[per, total_words]`` buffer; its planar view is the zero-padded flat
    vector reshaped to ``[per, leaf_words[i]]``. ``block_leaf`` maps each
    lane block to its leaf, which is how per-leaf scales become the
    kernels' per-block scales.
    """

    names: tuple
    shapes: tuple
    dtypes: tuple
    bits: int
    sizes: tuple
    per: int
    leaf_words: tuple
    word_offsets: tuple
    total_words: int
    block_leaf: np.ndarray      # [total_words // LANE_BLOCK] int32
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def for_tree(tree: Params, bits: int, stacked: bool = False
                 ) -> "WireLayout":
        """Build the layout from a client-local dict (``stacked``: leaves
        carry a leading client axis, which is dropped). Only shapes and
        dtypes are read."""
        names = tuple(sorted(tree))
        shapes = tuple(tuple(tree[n].shape[1:] if stacked else tree[n].shape)
                       for n in names)
        dtypes = tuple(tree[n].dtype for n in names)
        sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
        per = 32 // bits

        def aligned_words(n: int) -> int:
            w = -(-n // per)
            return -(-w // LANE_BLOCK) * LANE_BLOCK

        lw = tuple(aligned_words(n) for n in sizes)
        offs = tuple(np.cumsum((0,) + lw[:-1]).tolist())
        block_leaf = np.repeat(np.arange(len(sizes), dtype=np.int32),
                               [w // LANE_BLOCK for w in lw])
        return WireLayout(names=names, shapes=shapes, dtypes=dtypes,
                          bits=bits, sizes=sizes, per=per, leaf_words=lw,
                          word_offsets=offs, total_words=int(sum(lw)),
                          block_leaf=block_leaf)

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    @property
    def n_blocks(self) -> int:
        return self.total_words // LANE_BLOCK

    def _segments(self):
        return zip(self.names, self.shapes, self.dtypes, self.sizes,
                   self.leaf_words, self.word_offsets)

    # -- fp32 wire: plain flatten/unflatten ---------------------------------

    def flatten_f32(self, tree: Params) -> torch.Tensor:
        """Stacked dict (leaves [m, ...]) -> [m, sum(sizes)] f32: row c is
        the JAX package's ``flatten_f32`` of client c's dict."""
        return torch.cat([tree[n].reshape(tree[n].shape[0], -1)
                          .to(torch.float32) for n in self.names], dim=1)

    def unflatten(self, flat: torch.Tensor) -> Params:
        """Inverse of :meth:`flatten_f32`: [m, sum(sizes)] -> stacked
        dict in the leaves' shapes and dtypes."""
        out, off = {}, 0
        for name, shape, dtype, n, _, _ in self._segments():
            out[name] = flat[:, off:off + n].reshape(
                (flat.shape[0],) + shape).to(dtype)
            off += n
        return out

    # -- planar buffers -----------------------------------------------------

    def to_planar(self, tree: Params) -> torch.Tensor:
        """Client-local dict -> [per, total_words] f32, zero-padded."""
        return self.to_planar_stacked(
            {n: t.unsqueeze(0) for n, t in tree.items()})[0]

    def from_planar(self, buf2d: torch.Tensor) -> Params:
        return {n: t[0] for n, t in
                self.from_planar_stacked(buf2d.unsqueeze(0)).items()}

    def to_planar_stacked(self, tree: Params) -> torch.Tensor:
        """Stacked dict (leaves [m, ...]) -> [m, per, total_words] f32;
        row c equals ``to_planar`` of client c's dict."""
        segs = []
        for name, _, _, n, lw, _ in self._segments():
            leaf = tree[name]
            flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
            segs.append(F.pad(flat, (0, self.per * lw - n))
                        .reshape(-1, self.per, lw))
        return torch.cat(segs, dim=2)

    def from_planar_stacked(self, buf: torch.Tensor) -> Params:
        m = buf.shape[0]
        out = {}
        for name, shape, dtype, n, lw, off in self._segments():
            seg = buf[:, :, off:off + lw].reshape(m, -1)[:, :n]
            out[name] = seg.reshape((m,) + shape).to(dtype).contiguous()
        return out

    # -- per-leaf scales and stochastic-rounding noise ----------------------

    def leaf_amax(self, delta: torch.Tensor) -> torch.Tensor:
        """Per-leaf ``max|x|`` of a planar buffer: [..., n_leaves]."""
        return torch.stack(
            [delta[..., :, off:off + lw].abs().amax(dim=(-2, -1))
             for lw, off in zip(self.leaf_words, self.word_offsets)], dim=-1)

    def scales_from_amax(self, amax: torch.Tensor, quant) -> torch.Tensor:
        """Per-leaf amaxes -> quantizer steps (0 -> 1.0)."""
        if quant.scale_mode == "fixed":
            return torch.full(amax.shape, quant.s, dtype=torch.float32,
                              device=amax.device)
        s = scale_from_amax(amax, quant.qmax)
        return torch.where(s > 0, s, torch.ones_like(s))

    def leaf_scales(self, delta: torch.Tensor, quant) -> torch.Tensor:
        """Per-leaf quantizer steps of a planar delta buffer (leading batch
        dims allowed): [..., n_leaves]."""
        return self.scales_from_amax(self.leaf_amax(delta), quant)

    def _noise_index(self, device) -> tuple[torch.Tensor, ...]:
        """Static gather tables for drawing a whole buffer's noise in one
        pass: the leaf of every column [W], the flat index inside its leaf
        of every planar position [per, W], and whether it is a real
        element (not padding)."""
        key = ("noise", str(device))
        if key not in self._cache:
            col_leaf = np.repeat(np.arange(self.n_leaves), self.leaf_words)
            col = np.arange(self.total_words)
            rows = np.arange(self.per)[:, None]
            lw = np.asarray(self.leaf_words)[col_leaf]
            idx = rows * lw + (col - np.asarray(self.word_offsets)[col_leaf])
            valid = idx < np.asarray(self.sizes)[col_leaf]
            self._cache[key] = (
                torch.as_tensor(col_leaf, dtype=torch.int64, device=device),
                torch.as_tensor(idx, dtype=torch.int64, device=device),
                torch.as_tensor(valid, device=device))
        return self._cache[key]

    def noise_stacked(self, keys: torch.Tensor) -> torch.Tensor:
        """Stochastic-rounding noise for m clients: ``keys`` [n_leaves, m,
        2] (the raw ``_quant_leaf_keys`` output) -> [m, per, W] f32. Leaf
        segment li of client c holds ``uniform(keys[li, c], (n_li,))`` in
        planar order; padding is zero."""
        col_leaf, idx, valid = self._noise_index(keys.device)
        k = keys.permute(1, 0, 2)[:, col_leaf]             # [m, W, 2]
        u = prng.uniform_at(k[:, None, :, 0], k[:, None, :, 1], idx)
        return torch.where(valid, u, torch.zeros((), dtype=u.dtype,
                                                 device=u.device))

    @property
    def noise_table(self) -> NoiseTable:
        """The leaf table keyed B1 and B4 draw their noise from: the same
        noise as :meth:`noise_stacked`, computed inside the kernel."""
        return NoiseTable(self.word_offsets, self.leaf_words, self.sizes)

    def noise(self, leaf_keys: torch.Tensor) -> torch.Tensor:
        """One client's noise: ``leaf_keys`` [n_leaves, 2] -> [per, W]."""
        return self.noise_stacked(leaf_keys[:, None])[0]

    def block_scales(self, scales: torch.Tensor) -> torch.Tensor:
        """Per-leaf scales [..., n_leaves] -> per-lane-block scales
        [..., n_blocks] (what the buffer kernels consume)."""
        idx = self._cache.get(("blocks", str(scales.device)))
        if idx is None:
            idx = torch.as_tensor(self.block_leaf, dtype=torch.int64,
                                  device=scales.device)
            self._cache[("blocks", str(scales.device))] = idx
        return scales[..., idx].contiguous()

    # -- codec --------------------------------------------------------------

    def encode(self, delta: torch.Tensor, scales: torch.Tensor, quant,
               keys: torch.Tensor | None = None) -> torch.Tensor:
        """Quantize + planar-pack every client's buffer in one pass (B1):
        delta [m, per, W] f32, scales [m, n_leaves]. Stochastic rounding
        takes ``keys`` [n_leaves, m, 2] (the raw ``_quant_leaf_keys``
        output): B1 draws :meth:`noise_stacked`'s noise itself, so it is
        never written out. Returns int32 words [m, W]."""
        sblk = self.block_scales(scales)
        if not quant.stochastic:
            return quantize_pack_buffer(delta.contiguous(), sblk, quant.bits)
        if keys is None:
            raise ValueError("stochastic encode needs keys")
        return quantize_pack_buffer(delta.contiguous(), sblk, quant.bits,
                                    keys=keys.contiguous(),
                                    table=self.noise_table)

    def decode_apply(self, base: torch.Tensor, words: torch.Tensor,
                     scales: torch.Tensor, weights: torch.Tensor,
                     src: torch.Tensor, quant) -> torch.Tensor:
        """Fused ``base[c] + sum_k weights[c, k] * deq(words[src[k, c]])``
        over the whole buffer (B2): base [m, per, W] f32; words [m, W];
        scales [m, n_leaves] (each client's own); weights [m, K]; src
        [K, m] int32 with row 0 the identity."""
        return dequant_mix_buffer(base.contiguous(), words,
                                  self.block_scales(scales), weights, src,
                                  quant.bits)

    def encode_momentum(self, y2d: torch.Tensor, v2d: torch.Tensor,
                        g2d: torch.Tensor, x2d: torch.Tensor,
                        scales: torch.Tensor, et, quant,
                        keys: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Fused-round send side (B4): apply the penultimate heavy-ball
        step and emit the wire words as a side output of the same pass,

            v' = theta*v - eta*g ;  y' = y + v' ;  words = pack(Q(y' - x))

        y2d/v2d/g2d/x2d [m, per, W] f32; scales [m, n_leaves] of the
        RESULTING delta (the caller computes them from the same expression
        order); et = (eta, theta). Stochastic rounding takes ``keys``
        [n_leaves, m, 2] as :meth:`encode` does: B4 draws
        :meth:`noise_stacked`'s noise itself. Returns (y', v', words int32
        [m, W])."""
        operands = (y2d.contiguous(), v2d.contiguous(), g2d.contiguous(),
                    x2d.contiguous(), self.block_scales(scales), quant.bits,
                    et)
        if not quant.stochastic:
            return momentum_quantize_pack_buffer(*operands)
        if keys is None:
            raise ValueError("stochastic encode needs keys")
        return momentum_quantize_pack_buffer(*operands,
                                             keys=keys.contiguous(),
                                             table=self.noise_table)

    def decode_apply_momentum(self, base: torch.Tensor, words: torch.Tensor,
                              scales: torch.Tensor, weights: torch.Tensor,
                              src: torch.Tensor, v2d: torch.Tensor,
                              g2d: torch.Tensor, et, quant) -> torch.Tensor:
        """Fused-round receive side (B5): the decode-apply of
        :meth:`decode_apply` and the deferred last heavy-ball step in one
        pass, ``[base + sum_k w_k*deq(words[src_k])] + (theta*v - eta*g)``.
        v2d/g2d [m, per, W]; et = (eta, theta). No v output: momentum
        restarts every round."""
        return dequant_mix_momentum_buffer(
            base.contiguous(), words, self.block_scales(scales), weights,
            src, v2d.contiguous(), g2d.contiguous(), et, quant.bits)
