"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B] — 128-expert top-8 MoE."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,          # GQA kv=4
    head_dim=128,
    d_ff=0,                # all-MoE FFN; per-expert width below
    vocab_size=151936,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=False,
    dtype="bfloat16",
))
