"""STUB modality frontends, the port of the JAX package's
``models/frontends.py``.

[audio] whisper: the mel-spectrogram + conv feature extractor is stubbed;
we supply frame embeddings [b, frontend_tokens, d_model] directly (whisper
tiny: 30 s -> 1500 frames after the conv stride-2).

[vlm] llama-3.2-vision: the ViT tower + adapter is stubbed; we supply
patch/tile embeddings [b, frontend_tokens, d_model] (one 448px tile ->
1601 patch tokens in the model card; the projector in model.py is real).

The embeddings are ``prng.normal(PRNGKey(seed), shape)`` cast to the
config's dtype: the bits of the reference's ``jax.random.normal`` within
a few ulp (T4 on the card), deterministic in (seed, shape).
"""
from __future__ import annotations

import torch

from .. import prng
from ..configs.base import ArchConfig
from ..device import resolve_device
from .transformer import torch_dtype


def frontend_shape(cfg: ArchConfig, batch: int) -> tuple[int, int, int]:
    if cfg.frontend is None:
        raise ValueError(f"{cfg.name} has no frontend")
    return (batch, cfg.frontend_tokens, cfg.d_model)


def stub_frontend_embeddings(cfg: ArchConfig, batch: int, seed: int = 0,
                             device=None) -> torch.Tensor:
    """Deterministic stand-in for precomputed frame/patch embeddings, on
    ``device`` (CUDA unless ``"cpu"``)."""
    shape = frontend_shape(cfg, batch)
    key = prng.PRNGKey(seed, device=resolve_device(device))
    return prng.normal(key, shape).to(torch_dtype(cfg.dtype))
