"""Kernel microbench: the wire encode, the ring decode and the fused
momentum step on one 1M-parameter vector — the reference's
``benchmarks/bench_kernels.py`` on the port.

The reference's rows (``kernels/encode_ref/b{8,4}``,
``kernels/dequant_mix_ref/b{8,4}``, ``kernels/momentum_ref``) time the
plain versions (``kernels/ref.py``), as the reference times its jitted
oracles: its Pallas kernels would run in interpret mode off the TPU. On
the card each row gets a twin for the entry point itself —
``encode_delta`` (B6), ``decode_apply_ring`` (B8) and
``momentum_update_flat`` (B3) — with the same derived column.
``us_per_call`` is the host clock to a synchronize (median of 5 calls).
``chip_smoke.py`` holds each entry point bitwise with its plain version
and times its kernel on the device clock. ``--smoke``: N = 4096.
"""
from __future__ import annotations

import torch

from .. import prng
from ..device import resolve_device
from ..kernels.ops import decode_apply_ring, encode_delta, momentum_update_flat
from ..kernels.ref import (dequant_mix_ref, momentum_sgd_ref, pad_planar,
                           quantize_pack_ref)
from .common import timed

N = 1 << 20     # 1M-param tensor
SMOKE_N = 1 << 12
S = 0.01        # the reference's fixed encode step
W_SELF, W_NB = 0.5, 0.25


def encode_plain(x: torch.Tensor, bits: int, s: torch.Tensor
                 ) -> torch.Tensor:
    """The reference's ``quantize_pack_ref(x, bits, s)`` on a flat x:
    the zero-padded planar view, then B6's plain version (floor)."""
    return quantize_pack_ref(pad_planar(x, bits), s, bits)


def ring_plain(x: torch.Tensor, words: torch.Tensor, scales: torch.Tensor,
               bits: int) -> torch.Tensor:
    """The reference's ``dequant_mix_ref(x, w, w, w, scales, bits, 0.5,
    0.25)`` on a flat x: B8's plain version on the padded planar view,
    cut back to [n]."""
    out = dequant_mix_ref(pad_planar(x, bits), words, words, words, scales,
                          bits, W_SELF, W_NB)
    return out.reshape(-1)[:x.shape[0]]


def operands(n: int, dev: torch.device):
    """x = normal(PRNGKey(0), (n,)), v = 0, g = normal(PRNGKey(1), (n,))
    on ``dev`` (T4 on the card), as the reference draws them."""
    x = prng.normal(prng.PRNGKey(0, device=dev), (n,))
    g = prng.normal(prng.PRNGKey(1, device=dev), (n,))
    return x, torch.zeros_like(x), g


def run(*, smoke: bool = False, device=None):
    dev = resolve_device(device)
    card = dev.type == "cuda"
    x, v, g = operands(SMOKE_N if smoke else N, dev)
    s_fixed = torch.full((), S, dtype=torch.float32, device=dev)
    rows = []

    def row(name, fn, *args, derived):
        rows.append((name, timed(fn, *args, device=dev), derived))

    for bits in (8, 4):
        saving = 32 / bits
        row(f"kernels/encode_ref/b{bits}", encode_plain, x, bits, s_fixed,
            derived=f"wire_saving={saving:.0f}x")
        words, s = encode_delta(x, bits, stochastic=False)
        if card:
            row(f"kernels/encode_delta/b{bits}", lambda b=bits: encode_delta(
                x, b, stochastic=False), derived=f"wire_saving={saving:.0f}x")
        scales = torch.stack([s, s, s])
        row(f"kernels/dequant_mix_ref/b{bits}", ring_plain, x, words, scales,
            bits, derived="fused=1pass")
        if card:
            row(f"kernels/decode_apply_ring/b{bits}",
                lambda b=bits, w=words, sc=scales: decode_apply_ring(
                    x, w, w, w, sc, bits=b, w_self=W_SELF, w_nb=W_NB),
                derived="fused=1pass")
    row("kernels/momentum_ref", momentum_sgd_ref, x, v, g, 0.01, 0.9,
        derived="hbm_traffic=5N")
    if card:
        row("kernels/momentum_update_flat", momentum_update_flat, x, v, g,
            0.01, 0.9, derived="hbm_traffic=5N")
    return rows
