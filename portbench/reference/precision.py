"""The precision the reference computes in. ``f32``: every product and
every activation in float32. ``fp8``, the control: the reference computed
one precision below the configuration's bf16, every tensor that the
configuration's dtype would hold (each product's operands and result,
and each activation a family marks with ``act``: embeddings, norm and
convolution outputs, attention's and the SSD's outputs, the residual
stream) rounded to float8 e4m3 with one scale a tensor (its largest
magnitude onto 448); the arithmetic between the roundings stays float32.
The rounding passes the gradient straight through."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    @staticmethod
    def backward(ctx, grad):
        return grad


class F32:
    """Float32 throughout."""

    @staticmethod
    def act(t: torch.Tensor) -> torch.Tensor:
        return t

    @staticmethod
    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return a @ w


class Fp8:
    """The control (module docstring)."""

    act = staticmethod(_RoundFp8.apply)

    @staticmethod
    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return _RoundFp8.apply(_RoundFp8.apply(a) @ _RoundFp8.apply(w))


PRECISIONS = {"f32": F32, "fp8": Fp8}
