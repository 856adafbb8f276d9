"""zamba2-1.2b [arXiv:2411.15242] — Mamba2 backbone + ONE shared attention
block re-entered every 6 layers (input: concat(hidden, embedding), 2*d).
The 32H/kv=32, d_ff=8192 numbers describe that shared block (2*2048=4096
wide, 32 heads x 128)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_every=6,
    tie_embeddings=True,
    dtype="bfloat16",
))
