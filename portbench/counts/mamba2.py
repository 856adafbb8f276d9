"""Mamba2's parameters and model FLOPs from its published architecture
(arXiv:2405.21060; the configuration's keys), for the benchmark's
yardstick.

Per token, forward and backward (x 3), nothing recomputed:
  matmul: 6 x the projections a token passes (z, x, B, C, dt in; the
      output projection; the tied head);
  ssd: the chunked algorithm's products at chunk Q (one group of B and
      C, H heads of P channels, state N), a layer forward: C B^T within
      the chunk (2 Q N), its masked product with x (2 Q H P), the chunk's
      states B^T x (2 N H P), their passing from chunk to chunk (2 H N P
      / Q) and the output from the states C h (2 N H P).
The depthwise convolutions and elementwise work are no products."""
from __future__ import annotations


def _dims(cfg: dict):
    d = cfg["d_model"]
    di = cfg["expand"] * d
    p = cfg["headdim"]
    mult = cfg["pad_vocab_size_multiple"]
    rows = -(-cfg["vocab_size"] // mult) * mult
    return d, di, di // p, p, cfg["d_state"], cfg["d_conv"], \
        cfg["n_layer"], rows


def _layer_matmul(cfg: dict) -> int:
    d, di, h, _, n, _, _, _ = _dims(cfg)
    return 2 * d * di + 2 * d * n + d * h + di * d


def params_by_dtype(cfg: dict) -> dict:
    """Every stored value of one client, by dtype: the table, each
    layer's projections, convolutions, norm scales (the block's and the
    gated norm's) in the model's dtype; A_log, D and dt_bias a head in
    float32; the final norm's scale."""
    d, di, h, _, n, conv, n_layers, rows = _dims(cfg)
    main = rows * d + n_layers * (_layer_matmul(cfg) + conv * (di + 2 * n)
                                  + d + di) + d
    return {cfg["torch_dtype"]: main, "float32": n_layers * 3 * h}


def flops_terms(cfg: dict, seq: int) -> dict:
    """Model FLOPs a token, by term."""
    d, _, h, p, n, _, n_layers, rows = _dims(cfg)
    q = min(cfg["chunk_size"], seq)
    ssd = 2 * q * n + 2 * q * h * p + 2 * n * h * p + 2 * h * n * p / q \
        + 2 * n * h * p
    return {"matmul": 6 * (n_layers * _layer_matmul(cfg) + rows * d),
            "ssd": 3 * n_layers * ssd}
