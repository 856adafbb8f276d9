"""Mamba2 (arXiv:2405.21060) as its published description runs it, in the
SSD's quadratic "dual" form over the whole sequence: for every head,
``y_t = sum_{s <= t} (C_t . B_s) exp(sum_{j=s+1..t} dt_j A) dt_s x_s +
D x_t``, with the segment sums taken by a masked cumulative sum (the
paper's ``segsum``), not by the chunked scan.

A block: RMSNorm, then the mixer: projections z, x, B, C and dt of the
normed input; depthwise causal convolutions (``d_conv`` taps) of x, B
and C, each followed by SiLU; ``dt = softplus(. + dt_bias)``, ``A =
-exp(A_log)``; the SSD with one group of B and C; the gated RMSNorm
``norm(y * silu(z))`` over the inner dim; the output projection; the
residual. Then a final RMSNorm and the embedding tied as the output head;
the loss is the mean next-token cross-entropy.

Leaves (one client; layers stacked on axis 0 under ``stages/0/``):
``embed/table`` [V, d], ``final_norm/scale`` [d], ``ln/scale`` [L, d],
``mixer/wz`` and ``mixer/wx`` [L, d, di], ``mixer/wB`` and ``mixer/wC``
[L, d, N], ``mixer/wdt`` [L, d, H], ``mixer/conv_x`` [L, d_conv, di],
``mixer/conv_B`` and ``mixer/conv_C`` [L, d_conv, N], ``mixer/A_log``,
``mixer/D`` and ``mixer/dt_bias`` [L, H], ``mixer/norm_scale`` [L, di],
``mixer/wo`` [L, di, d].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .smollm import rms_norm


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution, then SiLU: x [b, l, c], w [taps, c];
    out_t = sum_i w_i x_{t - taps + 1 + i}."""
    taps = w.shape[0]
    xp = F.pad(x, (0, 0, taps - 1, 0))
    l = x.shape[1]
    return F.silu(sum(xp[:, i:i + l] * w[i] for i in range(taps)))


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., T] -> [..., T, T]: entry (t, s) is ``sum_{j=s+1..t} a_j``
    for t >= s, -inf above the diagonal."""
    t = a.shape[-1]
    below = torch.ones(t, t, dtype=torch.bool, device=a.device).tril(-1)
    x = a[..., :, None].expand(*a.shape[:-1], t, t)      # x[t', s] = a_t'
    out = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    diag = torch.ones(t, t, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~diag, -torch.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The SSD's dual form. x [b, l, H, P], dt [b, l, H], a [H] (negative),
    b and c [b, l, N] -> y [b, l, H, P] (without the D term)."""
    decay = torch.exp(segsum((dt * a).transpose(1, 2)))      # [b, H, l, l]
    cb = torch.einsum("btn,bsn->bts", c, b)                  # [b, l, l]
    return torch.einsum("bhts,bshp->bthp", decay * cb[:, None],
                        x * dt[..., None])


def loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
         cfg: dict, prec) -> torch.Tensor:
    """Mean next-token cross-entropy of one client's batch [b, l], in
    precision ``prec`` (``precision.py``: its ``mm`` every weight product,
    its ``act`` every activation the configuration's dtype holds)."""
    mm, act = prec.mm, prec.act
    d, p = cfg["d_model"], cfg["headdim"]
    di = cfg["expand"] * d
    n_heads = di // p
    eps = cfg["norm_epsilon"]
    b, l = tokens.shape
    table = params["embed/table"]
    x = act(table[tokens])

    def leaf(name, i):
        return params[f"stages/0/{name}"][i]

    for i in range(cfg["n_layer"]):
        h = act(rms_norm(x, leaf("ln/scale", i), eps))
        z = mm(h, leaf("mixer/wz", i))
        xc, bc, cc = (act(causal_conv(mm(h, leaf(f"mixer/w{n}", i)),
                                      leaf(f"mixer/conv_{n}", i)))
                      for n in ("x", "B", "C"))
        dt = F.softplus(h @ leaf("mixer/wdt", i) + leaf("mixer/dt_bias", i))
        a = -torch.exp(leaf("mixer/A_log", i))
        xh = xc.reshape(b, l, n_heads, p)
        y = ssd(xh, dt, a, bc, cc) + leaf("mixer/D", i)[:, None] * xh
        g = y.reshape(b, l, di) * F.silu(z)     # float32, as the program
        g = act(rms_norm(g, leaf("mixer/norm_scale", i), eps))
        x = act(x + mm(g, leaf("mixer/wo", i)))
    x = act(rms_norm(x, params["final_norm/scale"], eps))
    logits = mm(x, table.t())
    return F.cross_entropy(logits.reshape(b * l, -1),
                           targets.reshape(-1).long())
