"""gemma-7b [arXiv:2403.08295] — GeGLU, head_dim=256, embed scaling."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b",
    arch_type="dense",
    source="arXiv:2403.08295",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,         # 7b uses MHA (MQA is the 2b variant)
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp="geglu",
    embed_scale=True,
    tie_embeddings=True,
    dtype="bfloat16",
))
