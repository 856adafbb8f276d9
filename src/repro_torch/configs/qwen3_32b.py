"""qwen3-32b [hf:Qwen/Qwen3-8B family] — dense, qk_norm, GQA kv=8."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
    dtype="bfloat16",
))
