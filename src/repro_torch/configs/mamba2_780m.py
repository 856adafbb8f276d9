"""mamba2-780m [arXiv:2405.21060] — attention-free SSD (state-space duality)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    n_heads=0,             # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,       # d_inner=3072 -> 48 SSD heads
    pos="rope",            # unused by ssm blocks (no attention)
    tie_embeddings=True,
    dtype="bfloat16",
))
