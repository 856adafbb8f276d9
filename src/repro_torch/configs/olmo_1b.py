"""olmo-1b [arXiv:2402.00838] — non-parametric LayerNorm."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="olmo-1b",
    arch_type="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,         # MHA (kv=16)
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparam_ln",    # OLMo: LN without scale/bias
    mlp="swiglu",
    tie_embeddings=True,
    dtype="bfloat16",
))
