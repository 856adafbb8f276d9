"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M] — small llama-arch."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-135m",
    arch_type="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,          # GQA kv=3
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    dtype="bfloat16",
))
