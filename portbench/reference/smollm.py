"""SmolLM (a Llama-style decoder) as its published description runs it:
RMSNorm before attention and before the MLP, grouped-query attention with
rotary embeddings (the halves rotated, theta ``rope_theta``) and a causal
softmax, a SwiGLU MLP, a final RMSNorm and the embedding tied as the
output head; the loss is the mean next-token cross-entropy.

Leaves (one client; layers stacked on axis 0 under ``stages/0/``):
``embed/table`` [V, d], ``final_norm/scale`` [d], ``ln1/scale`` and
``ln2/scale`` [L, d], ``attn/wq`` [L, d, H, hd], ``attn/wk`` and
``attn/wv`` [L, d, KV, hd], ``attn/wo`` [L, H, hd, d], ``mlp/wg`` and
``mlp/wu`` [L, d, F], ``mlp/wd`` [L, F, d].
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [b, l, heads, hd], position t at row t."""
    b, l, h, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(l, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v):
    """Causal softmax attention; q [b, l, H, hd], k and v [b, l, KV, hd],
    query head h reading KV head h // (H / KV)."""
    b, l, h, hd = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", scores.softmax(dim=-1), v)


def loss(params: dict, tokens: torch.Tensor, targets: torch.Tensor,
         cfg: dict, prec) -> torch.Tensor:
    """Mean next-token cross-entropy of one client's batch [b, l], in
    precision ``prec`` (``precision.py``: its ``mm`` every weight product,
    its ``act`` every activation the configuration's dtype holds)."""
    mm, act = prec.mm, prec.act
    d = cfg["hidden_size"]
    n_heads, n_kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // n_heads
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    b, l = tokens.shape
    table = params["embed/table"]
    x = act(table[tokens])

    def leaf(name, i):
        return params[f"stages/0/{name}"][i]

    for i in range(cfg["num_hidden_layers"]):
        h = act(rms_norm(x, leaf("ln1/scale", i), eps))
        q = mm(h, leaf("attn/wq", i).reshape(d, -1)).reshape(b, l, n_heads,
                                                             hd)
        k = mm(h, leaf("attn/wk", i).reshape(d, -1)).reshape(b, l, n_kv, hd)
        v = mm(h, leaf("attn/wv", i).reshape(d, -1)).reshape(b, l, n_kv, hd)
        o = act(attention(act(rope(q, theta)), act(rope(k, theta)), v))
        x = act(x + mm(o.reshape(b, l, -1), leaf("attn/wo", i).reshape(-1,
                                                                       d)))
        h = act(rms_norm(x, leaf("ln2/scale", i), eps))
        gate = act(F.silu(mm(h, leaf("mlp/wg", i)))
                   * mm(h, leaf("mlp/wu", i)))
        x = act(x + mm(gate, leaf("mlp/wd", i)))
    x = act(rms_norm(x, params["final_norm/scale"], eps))
    logits = mm(x, table.t())
    return F.cross_entropy(logits.reshape(b * l, -1),
                           targets.reshape(-1).long())
