"""mixtral-8x22b [arXiv:2401.04088] — 8-expert top-2 MoE with sliding-window
attention (window 4096) => bounded KV cache, eligible for long_500k."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="arXiv:2401.04088",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,          # GQA kv=8
    head_dim=128,
    d_ff=0,
    vocab_size=32768,
    n_experts=8,
    experts_per_token=2,
    moe_d_ff=16384,
    sliding_window=4096,
    rope_theta=1e6,
    tie_embeddings=False,
    dtype="bfloat16",
))
