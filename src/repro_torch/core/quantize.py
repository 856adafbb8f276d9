"""b-bit quantizers (paper §3.2, Assumption 4), PyTorch port of the JAX
package's ``core/quantize.py``: the quantizer, the sequential bit packing
of a 1-D code vector and the per-leaf pytree helpers. Packed u32 words
travel as int32 bit patterns, as everywhere in the port.

The grid is ``{-2^{b-1} s, ..., (2^{b-1}-1) s}``:

  deterministic: q(a) = floor(a/s) * s
  stochastic:    q(a) = ks   w.p. 1 - (a-ks)/s,   (k+1)s  w.p. (a-ks)/s

A transmitted message is ``(s, packed)``: ``32 + d*b`` bits per edge.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import prng

__all__ = ["QuantConfig", "scale_from_amax", "quantize_int", "quantize_levels",
           "dequantize_int", "quantize", "packed_len", "pack_bits",
           "unpack_bits", "quantize_pytree", "dequantize_pytree",
           "message_bits"]

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization hyper-parameters (paper parameters ``s`` and ``b``).

    bits:       field width b (2, 4, 8 or 16; 32 disables quantization)
    stochastic: unbiased stochastic rounding vs deterministic floor
    scale_mode: "per_tensor" (s from max-abs, nothing overflows) or
                "fixed" (the paper's constant s)
    s:          the fixed step (scale_mode="fixed" only)
    delta_mode: "lemma5" — x' = W (x + Q(z - x)), the recursion the
                paper's proofs analyze (default); "eq7" — Algorithm 2
                verbatim, x' = x + W Q(z - x) (needs a PSD W)
    """

    bits: int = 8
    stochastic: bool = True
    scale_mode: str = "per_tensor"
    s: float = 1e-3
    delta_mode: str = "lemma5"

    def __post_init__(self):
        if self.bits not in (2, 4, 8, 16, 32):
            raise ValueError(f"bits must be in (2,4,8,16,32), got {self.bits}")
        if self.scale_mode not in ("per_tensor", "fixed"):
            raise ValueError(f"bad scale_mode {self.scale_mode!r}")
        if self.delta_mode not in ("eq7", "lemma5"):
            raise ValueError(f"bad delta_mode {self.delta_mode!r}")

    @property
    def enabled(self) -> bool:
        return self.bits < 32

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1


def scale_from_amax(amax: torch.Tensor, qmax: int) -> torch.Tensor:
    """THE per-tensor quantizer step ``s = amax / qmax``, computed as a
    multiply by the f32 reciprocal exactly as the JAX package does: a
    multiply is correctly rounded on every backend, and a 1-ulp scale
    difference would flip quantization decisions at grid boundaries."""
    return amax * float(np.float32(1.0 / np.float32(qmax)))


def _scale_for(x: torch.Tensor, cfg: QuantConfig, dim=None) -> torch.Tensor:
    """Quantizer step of ``x`` (over ``dim``, all dims when None): fixed
    ``s``, or ``max|x| / qmax`` with an all-zero tensor mapped to 1.0."""
    if cfg.scale_mode == "fixed":
        shape = () if dim is None else x.amax(dim=dim).shape
        return torch.full(shape, cfg.s, dtype=torch.float32, device=x.device)
    ax = x.to(torch.float32).abs()
    amax = ax.amax() if dim is None else ax.amax(dim=dim)
    s = scale_from_amax(amax, cfg.qmax)
    return torch.where(s > 0, s, torch.ones_like(s))


def quantize_int(x: torch.Tensor, cfg: QuantConfig,
                 key: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched over leading dims: x [..., n] -> (k int32 [..., n] in
    [qmin, qmax], s [...]). ``key`` [..., 2] draws the stochastic bits of
    each row, like ``jax.random.uniform(key, (n,))``."""
    x = x.to(torch.float32)
    s = _scale_for(x, cfg, dim=-1)
    u = None
    if cfg.stochastic:
        if key is None:
            raise ValueError("stochastic quantization needs a PRNG key")
        u = prng.uniform(key.to(x.device), (x.shape[-1],))
    return quantize_levels(x, s[..., None], cfg, u).to(torch.int32), s


def quantize_levels(x: torch.Tensor, s: torch.Tensor, cfg: QuantConfig,
                    u: torch.Tensor | None = None) -> torch.Tensor:
    """The levels of ``x`` (f32) on the grid of step ``s`` (broadcast
    against x), as f32 in [qmin, qmax]: ``floor(x / s)``, plus one where
    the uniform ``u`` (same shape as x; stochastic rounding only) falls
    below the remainder. Elementwise, so a block of x with its block of
    the noise gives the whole tensor's levels there."""
    a = x / s
    k = torch.floor(a)
    if cfg.stochastic:
        if u is None:
            raise ValueError("stochastic quantization needs its noise")
        k = k + (u < (a - k)).to(torch.float32)
    return k.clamp(cfg.qmin, cfg.qmax)


def dequantize_int(k: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int`: levels k [..., n], s [...]."""
    return k.to(torch.float32) * s[..., None]


def quantize(x: torch.Tensor, cfg: QuantConfig,
             key: torch.Tensor | None = None) -> torch.Tensor:
    """Round-trip quantize: Q(x) as f32 (paper's Q operator, eq. 6), one
    per-tensor scale over all of ``x``; stochastic rounding draws
    ``uniform(key, x.shape)`` (flat, as the reference's partitionable
    threefry orders it)."""
    if not cfg.enabled:
        return x.to(torch.float32)
    k, s = quantize_int(x.reshape(-1), cfg, key)
    return dequantize_int(k, s).reshape(x.shape)


# ---------------------------------------------------------------------------
# Bit packing: int32 in [qmin, qmax] -> offset b-bit fields in u32 words
# ---------------------------------------------------------------------------

def packed_len(n: int, bits: int) -> int:
    """u32 words needed to pack n ``bits``-wide fields (ceil division)."""
    per = 32 // bits
    return -(-n // per)  # ceil


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(32 // bits, dtype=torch.int64, device=device) * bits


def pack_bits(k: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed ints (1-D, any length) into a u32 word array (int32
    bit patterns): ``k + 2^{b-1}`` offset-encoded, 32/b fields a word,
    field i of a word shifted by ``b * i``. 32 bits is a bit-cast."""
    if bits == 32:
        return k.to(torch.int32)
    per = 32 // bits
    n = k.shape[0]
    off = k.to(torch.int64) + (1 << (bits - 1))
    off = torch.nn.functional.pad(off, (0, packed_len(n, bits) * per - n))
    words = (off.reshape(-1, per) << _shifts(bits, k.device)).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> int32 of length n."""
    if bits == 32:
        return words.to(torch.int32)[:n]
    u = words.to(torch.int64) & 0xFFFFFFFF
    fields = (u[:, None] >> _shifts(bits, words.device)) & ((1 << bits) - 1)
    return (fields.reshape(-1) - (1 << (bits - 1))).to(torch.int32)[:n]


# ---------------------------------------------------------------------------
# Pytree helpers — quantize every leaf of a model delta
# ---------------------------------------------------------------------------

def quantize_pytree(tree: Params, cfg: QuantConfig,
                    key: torch.Tensor | None = None,
                    pack: bool = True) -> tuple[Params, Params]:
    """Quantize every leaf of a flat dict, in ``jax.tree.flatten`` order
    (sorted names): one key a leaf from ``split(key, n_leaves)``, each
    leaf's noise ``uniform(key_i, (n_i,))`` (T2 on the card). Returns
    (wire, scales): packed words (int32 bit patterns; ``pack=False``:
    the int32 codes) and 0-dim f32 scales, by name."""
    names = sorted(tree)
    if cfg.stochastic and cfg.enabled:
        if key is None:
            raise ValueError("stochastic quantization needs a PRNG key")
        keys = list(prng.split(key, len(names)))
    else:
        keys = [None] * len(names)
    wire, scales = {}, {}
    for name, k in zip(names, keys):
        code, s = quantize_int(tree[name].reshape(-1), cfg, k)
        wire[name] = pack_bits(code, cfg.bits) if pack else code
        scales[name] = s
    return wire, scales


def dequantize_pytree(wire: Params, scales: Params, like: Params,
                      cfg: QuantConfig, packed: bool = True) -> Params:
    """Inverse of :func:`quantize_pytree`; ``like`` supplies shapes."""
    out = {}
    for name, ref in like.items():
        n = ref.numel()
        code = unpack_bits(wire[name], cfg.bits, n) if packed else wire[name]
        out[name] = dequantize_int(code, scales[name]).reshape(ref.shape)
    return out


def message_bits(d: int, cfg: QuantConfig) -> int:
    """Bits to send one d-dim tensor to ONE neighbor (paper: 32 + d*b)."""
    if not cfg.enabled:
        return 32 * d
    return 32 + d * cfg.bits
