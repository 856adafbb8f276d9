"""Shared building blocks of the models (functional style), the port of
the JAX package's ``models/layers.py``.

Parameters are flat dicts (``convert``'s ``/`` names). Inside the model
every parameter and activation carries a leading client axis m (one model
a client; ``models.model`` adds an axis of 1 for an unstacked model): a
weight ``[m, d_in, d_out]`` applies to activations ``[m, ..., d_in]`` as
one batched product over the clients (:func:`mm`), every client's tokens
folded into the rows. Norms run in f32 (eps 1e-6) and cast back.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import prng

Params = dict[str, torch.Tensor]


def dense_init(key: torch.Tensor, shape, dtype=torch.float32,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from a port PRNG key, the JAX
    package's ``dense_init``: ``prng.normal(key, shape)`` (the bits of
    ``jax.random.normal``, within a few ulp) times ``1 / sqrt(max(fan_in,
    1))`` in double, applied to the f32 draw, then cast to ``dtype``. The
    draw runs on the key's device (T4 on the card)."""
    fi = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fi, 1))
    return (prng.normal(key, tuple(shape)) * std).to(dtype)


def sub(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix + "/"``, the prefix stripped."""
    p = prefix + "/"
    return {n[len(p):]: t for n, t in params.items() if n.startswith(p)}


def prefixed(prefix: str, params: Params) -> Params:
    return {f"{prefix}/{n}": t for n, t in params.items()}


def bcast(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-client vector ``[m, d]`` shaped to broadcast against
    activations ``[m, ..., d]``."""
    return p.reshape((p.shape[0],) + (1,) * (x.dim() - 2) + (p.shape[-1],))


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for every client: x ``[m, ..., d_in]``, w ``[m, d_in,
    *out]`` -> ``[m, ..., *out]``, one batched product (the rows of a
    client folded together, the output dims of w flattened)."""
    m, d_in = w.shape[0], w.shape[1]
    out = w.shape[2:]
    y = torch.bmm(x.reshape(m, -1, d_in), w.reshape(m, d_in, -1))
    return y.reshape(x.shape[:-1] + out)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, d: int, dtype) -> Params:
    if kind == "nonparam_ln":      # OLMo: LayerNorm without scale/bias
        return {}
    if kind in ("rmsnorm", "layernorm"):
        p = {"scale": torch.ones((d,), dtype=dtype)}
        if kind == "layernorm":
            p["bias"] = torch.zeros((d,), dtype=dtype)
        return p
    raise ValueError(f"unknown norm {kind!r}")


def _rms(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)


def apply_norm(kind: str, params: Params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = _rms(xf, eps) * bcast(params["scale"].to(torch.float32), x)
        return y.to(x.dtype)
    if kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = (y * bcast(params["scale"].to(torch.float32), x)
                 + bcast(params["bias"].to(torch.float32), x))
        return y.to(x.dtype)
    raise ValueError(kind)


def rms_norm_headdim(x: torch.Tensor, scale: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """qk-norm (Qwen3): RMS-normalize the last (head_dim) axis; x
    ``[m, ..., hd]``, scale ``[m, hd]``."""
    y = _rms(x.to(torch.float32), eps) * bcast(scale.to(torch.float32), x)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x ``[..., seq, heads, head_dim]``; positions ``[seq]``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[:, None].to(torch.float32) * freqs      # [seq, hd/2]
    cos = torch.cos(ang)[:, None, :]                        # [seq, 1, hd/2]
    sin = torch.sin(ang)[:, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU / ReLU)
# ---------------------------------------------------------------------------

def init_mlp(key: torch.Tensor, d_model: int, d_ff: int, kind: str,
             dtype) -> Params:
    k1, k2, k3 = prng.split(key, 3)
    if kind in ("swiglu", "geglu"):
        return {"wg": dense_init(k1, (d_model, d_ff), dtype),
                "wu": dense_init(k2, (d_model, d_ff), dtype),
                "wd": dense_init(k3, (d_ff, d_model), dtype, fan_in=d_ff)}
    if kind == "relu":
        return {"wu": dense_init(k1, (d_model, d_ff), dtype),
                "wd": dense_init(k2, (d_ff, d_model), dtype, fan_in=d_ff)}
    raise ValueError(f"unknown mlp {kind!r}")


def apply_mlp(kind: str, params: Params, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(mm(x, params["wg"])) * mm(x, params["wu"])
    elif kind == "geglu":
        h = F.gelu(mm(x, params["wg"]), approximate="tanh") \
            * mm(x, params["wu"])
    elif kind == "relu":
        h = F.relu(mm(x, params["wu"]))
    else:
        raise ValueError(kind)
    return mm(h, params["wd"])


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def init_embedding(key: torch.Tensor, vocab: int, d_model: int,
                   dtype) -> Params:
    return {"table": dense_init(key, (vocab, d_model), dtype,
                                fan_in=d_model)}


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens ``[m, ...]`` -> rows of each client's table ``[m, V, d]``:
    one ``F.embedding`` over the stacked tables (client c's row t is row
    c*V + t), whose backward on the card sorts the indices (no atomics)."""
    table = params["table"]
    m, vocab, d = table.shape
    offset = (torch.arange(m, device=tokens.device) * vocab).reshape(
        (m,) + (1,) * (tokens.dim() - 1))
    return F.embedding(tokens.long() + offset, table.reshape(m * vocab, d))


def logits_from_embedding(params: Params, h: torch.Tensor) -> torch.Tensor:
    return mm(h, params["table"].transpose(1, 2))
