"""Public entry points around the kernels, and their launch counters — the
port of the JAX package's ``kernels/ops.py``.

The per-tensor entry points work on ONE flat parameter vector ``[n]``,
read as its zero-padded planar view ``[per, W]`` (W =
``planar_pad_len(n, bits)[1]``, row-major):

encode_delta         — per-tensor scale + B6 (quantize + pack; keyed on
                       the card: the noise is drawn in the kernel)
decode_apply_ring    — B8, the ring form of eq. 7
decode_apply_plan    — B7, eq. 7 over a plan's [k, W] stream stack
momentum_update_flat — B3 on one flat vector (a one-leaf table)

On the card the two decodes read x [n] in place and write only [:n]: a
call on an f32 x is one launch and no other device operation.
``momentum_update`` is the heavy-ball step over a dict of parameter
leaves (one B3 launch for all of them), which
``make_fused_momentum_update`` returns. Words travel as int32 bit
patterns of the JAX package's uint32.
"""
from __future__ import annotations

import torch

from . import native
from .dequant_mix import dequant_mix_flat, dequant_mix_plan_flat
from .momentum_sgd import momentum_sgd, momentum_sgd_leaves
from .quantize_pack import quantize_pack
from .ref import pad_planar

Params = dict[str, torch.Tensor]


def encode_delta(delta: torch.Tensor, bits: int, *, stochastic: bool = True,
                 key: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat f32 delta [n] -> (packed words int32 [W], per-tensor scale s).

    ``s = amax / qmax`` is a true division (1.0 when amax is 0), as in
    the JAX package's ``encode_delta`` — not the reciprocal multiply of
    ``core.quantize.scale_from_amax``. The noise is ``uniform(key,
    (per, W))`` over the whole padded buffer from one key: on the CPU
    drawn by ``prng.uniform``, on the card by B6 itself from the key
    (a host key by value), the same bits."""
    if stochastic and key is None:
        raise ValueError("stochastic encode needs a key")
    x2d = pad_planar(delta, bits)
    qmax = torch.full((), 2 ** (bits - 1) - 1, dtype=torch.float32,
                      device=x2d.device)
    amax = delta.to(torch.float32).abs().amax()
    # Divide by a device tensor: CUDA turns a division by a host scalar
    # into a multiply by its reciprocal.
    s = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    return quantize_pack(x2d, s, bits, key=key if stochastic else None), s


def decode_apply_ring(x: torch.Tensor, q_own: torch.Tensor,
                      q_left: torch.Tensor, q_right: torch.Tensor,
                      scales: torch.Tensor, *, bits: int, w_self: float,
                      w_nb: float) -> torch.Tensor:
    """Fused eq.-7 ring apply for a flat parameter vector x [n]. On the
    card one B8 launch for an f32 x; another dtype is converted to f32
    before it and back after it (two more operations)."""
    out = dequant_mix_flat(x.to(torch.float32).contiguous(), q_own, q_left,
                           q_right, scales, bits, w_self, w_nb)
    return out.to(x.dtype)


def decode_apply_plan(x: torch.Tensor, streams: torch.Tensor,
                      scales: torch.Tensor, weights: torch.Tensor, *,
                      bits: int) -> torch.Tensor:
    """Fused GossipPlan apply for a flat parameter vector x [n] (eq. 7):
    ``x + sum_k weights[k] * deq(streams[k], scales[k])``; streams int32
    [k, W] (own stream first), scales and weights f32 [k] on x's device.
    On the card one B7 launch for an f32 x; another dtype is converted to
    f32 before it and back after it (two more operations)."""
    out = dequant_mix_plan_flat(x.to(torch.float32).contiguous(), streams,
                                scales, weights, bits)
    return out.to(x.dtype)


def momentum_update_flat(y: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                         eta: float, theta: float
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One heavy-ball step on flat vectors [n], one B3 launch. The Pallas
    form pads to (8, 512) blocks and slices back; B3 needs no padding, so
    the values are the same. Returns (y', v')."""
    return momentum_sgd(y.contiguous(), v.contiguous(),
                        g.to(y.dtype).contiguous(), eta, theta)


def momentum_update(y: Params, v: Params, g: Params,
                    eta: float | torch.Tensor,
                    theta: float) -> tuple[Params, Params]:
    """(y', v') with ``v' = theta*v - eta*g`` and ``y' = y + v'`` over
    every leaf, in ``y``'s key order: one B3 launch on CUDA tensors.
    ``eta`` is a float, or an f32 tensor [m] on the leaves' device (client
    c's values step with ``eta[c]``: B3's lane entry, one launch too). The
    outputs are views into one allocation (see
    :func:`~repro_torch.kernels.momentum_sgd.momentum_sgd_leaves`)."""
    names = list(y)
    ys, vs = momentum_sgd_leaves([y[n] for n in names],
                                 [v[n] for n in names],
                                 [g[n] for n in names], eta, theta)
    return dict(zip(names, ys)), dict(zip(names, vs))


def make_fused_momentum_update():
    """The heavy-ball update over a dict of parameter leaves (one B3
    launch): :func:`momentum_update`, the counterpart of the JAX package's
    ``make_fused_momentum_update``."""
    return momentum_update


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset."""
    return dict(native.LAUNCHES)


def reset_launch_counts() -> None:
    for k in native.LAUNCHES:
        native.LAUNCHES[k] = 0
