"""b-bit quantizers (paper §3.2, Assumption 4), PyTorch port of the JAX
package's ``core/quantize.py`` — the part the main path uses.

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

__all__ = ["QuantConfig", "scale_from_amax", "quantize_int",
           "dequantize_int", "message_bits"]


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
    a = x / s[..., None]
    k = torch.floor(a)
    if cfg.stochastic:
        if key is None:
            raise ValueError("stochastic quantization needs a PRNG key")
        u = prng.uniform(key.to(x.device), (x.shape[-1],))
        k = k + (u < (a - k)).to(torch.float32)
    k = k.clamp(cfg.qmin, cfg.qmax).to(torch.int32)
    return k, s


def dequantize_int(k: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int`: levels k [..., n], s [...]."""
    return k.to(torch.float32) * s[..., None]


def message_bits(d: int, cfg: QuantConfig) -> int:
    """Bits to send one d-dim tensor to ONE neighbor (paper: 32 + d*b)."""
    if not cfg.enabled:
        return 32 * d
    return 32 + d * cfg.bits
