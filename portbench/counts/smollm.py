"""SmolLM's parameters and model FLOPs from its published architecture
(the configuration's keys), for the benchmark's yardstick.

Per token, forward and backward, nothing recomputed: 6 x the matmul
parameters a token passes (every layer's q, k, v, o and SwiGLU
projections and the tied head; the embedding's gather is no product),
plus attention's scores and weighted values: 4 x seq x heads x head_dim
a layer forward (QK^T and AV over the whole sequence), x 3 with the
backward."""
from __future__ import annotations


def _dims(cfg: dict):
    d, h, kv = (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["num_key_value_heads"])
    return d, h, kv, d // h, cfg["intermediate_size"], \
        cfg["num_hidden_layers"], cfg["vocab_size"]


def _layer_matmul(cfg: dict) -> int:
    d, h, kv, hd, f, _, _ = _dims(cfg)
    return d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f


def params_by_dtype(cfg: dict) -> dict:
    """Every stored value of one client, by dtype: the table, each layer's
    projections and two norm scales, the final norm's scale."""
    d, _, _, _, _, n_layers, vocab = _dims(cfg)
    n = vocab * d + n_layers * (_layer_matmul(cfg) + 2 * d) + d
    return {cfg["torch_dtype"]: n}


def flops_terms(cfg: dict, seq: int) -> dict:
    """Model FLOPs a token, by term."""
    d, h, _, hd, _, n_layers, vocab = _dims(cfg)
    return {"matmul": 6 * (n_layers * _layer_matmul(cfg) + vocab * d),
            "attention": 12 * n_layers * seq * h * hd}
