"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision].

40-layer text decoder with gated cross-attention layers every 5th slot
(model card: cross layers at 3, 8, ..., 38). Vision tower is a STUB:
input_specs supply patch embeddings [b, 1601, 4096] (one 448px tile).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    cross_attn_layers=tuple(range(3, 40, 5)),
    frontend="vision",
    frontend_tokens=1601,
    rope_theta=500000.0,
    tie_embeddings=False,
    dtype="bfloat16",
))
