"""whisper-tiny [arXiv:2212.04356] — enc-dec; conv/mel frontend is a STUB.

4 encoder + 4 decoder layers, d=384, 6 heads. The stub supplies 1500
frame embeddings (30 s after conv stride-2). Decoder is run mechanically
at the assigned decode shapes (the real model caps at 448 positions).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=4,            # decoder layers (encoder_layers below)
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    mlp="relu",            # whisper uses GELU MLP; relu-family (see DESIGN)
    pos="learned",
    is_encoder_decoder=True,
    encoder_layers=4,
    frontend="audio",
    frontend_tokens=1500,
    tie_embeddings=True,
    dtype="bfloat16",
))
