"""Architecture config schema + registry + input shapes — the port's own
copy of the JAX package's ``configs/base.py`` (which it may not import),
field for field.

Every assigned architecture provides ``configs/<id>.py`` exposing
``CONFIG`` (exact paper/model-card numbers, cited) and registering itself.
``reduced()`` derives the CPU smoke-test variant (<=2 layers, d_model<=512,
<=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "register",
           "get_config", "list_archs", "reduced"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""               # citation (hf:/arXiv: ...)
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    qk_norm: bool = False
    pos: str = "rope"              # rope | learned
    rope_theta: float = 10000.0
    max_seq: int = 524288          # rope / learned-pos allocation cap
    sliding_window: int = 0        # 0 = full attention
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # --- structure ---
    shared_attn_every: int = 0     # zamba2: shared attn block cadence
    cross_attn_layers: tuple[int, ...] = ()   # vlm: cross-attn layer ids
    is_encoder_decoder: bool = False          # whisper
    encoder_layers: int = 0
    frontend: str | None = None    # "audio" | "vision" (STUB embeddings)
    frontend_tokens: int = 0       # embeddings supplied by the stub
    # --- numerics / training ---
    tie_embeddings: bool = True
    embed_scale: bool = False      # gemma: multiply embeddings by sqrt(d)
    dtype: str = "float32"         # param/compute dtype ("bfloat16" on TPU)
    remat: bool = True
    # "full": recompute whole blocks (min memory, re-runs TP collectives
    # in backward); "dots": jax.checkpoint_policies.checkpoint_dots —
    # saves matmul outputs (post-all-reduce), so the backward does NOT
    # re-run the forward's TP all-reduces (§Perf, gemma train).
    remat_policy: str = "full"

    # ---------------- derived structure ----------------
    def block_pattern(self) -> tuple[str, ...]:
        """Per-slot block kinds for the decoder stack. Kinds: dense, moe,
        ssm, cross, shared (zamba2 shared block re-entry)."""
        if self.is_encoder_decoder:
            # every decoder layer: self-attn + cross-attn + MLP (whisper)
            return ("cross",) * self.n_layers
        out: list[str] = []
        for i in range(self.n_layers):
            if i in self.cross_attn_layers:
                out.append("xattn")
            elif self.n_experts > 0:
                out.append("moe")
            elif self.ssm_state > 0:
                out.append("ssm")
            else:
                out.append("dense")
            if (self.shared_attn_every > 0
                    and (i + 1) % self.shared_attn_every == 0):
                out.append("shared")
        return tuple(out)

    def stages(self) -> tuple[tuple[str, int], ...]:
        """Run-length grouping of block_pattern -> scan stages."""
        pat = self.block_pattern()
        runs: list[tuple[str, int]] = []
        for kind in pat:
            if runs and runs[-1][0] == kind:
                runs[-1] = (kind, runs[-1][1] + 1)
            else:
                runs.append((kind, 1))
        return tuple(runs)

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k decode (see DESIGN.md §5)."""
        return (self.arch_type in ("ssm", "hybrid")
                or self.sliding_window > 0)

    def n_params(self) -> int:
        """Approximate parameter count (exact for our init, used for comm
        accounting and roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.pos == "learned":
            total += self.max_learned_pos() * d
        for kind in self.block_pattern():
            total += self._block_params(kind)
        if self.is_encoder_decoder:
            total += self.encoder_layers * self._block_params("enc")
            total += self.max_learned_pos() * d   # encoder pos table
        total += d   # final norm scale (approx; nonparam -> 0)
        return total

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.n_experts == 0:
            return self.n_params()
        d = self.d_model
        per_expert = 3 * d * self.moe_d_ff
        inactive = (self.n_experts - self.experts_per_token) * per_expert
        n_moe_layers = sum(1 for k in self.block_pattern() if k == "moe")
        return self.n_params() - n_moe_layers * inactive

    def max_learned_pos(self) -> int:
        return min(self.max_seq, 32768)

    def _block_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd \
            + self.n_heads * hd * d
        mlp_mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        if kind in ("dense", "enc"):
            return attn + mlp_mult * d * self.d_ff + 2 * d
        if kind == "moe":
            return attn + d * self.n_experts \
                + self.n_experts * 3 * d * self.moe_d_ff + 2 * d
        if kind == "ssm":
            di = self.ssm_expand * d
            n = self.ssm_state
            h = di // self.ssm_head_dim
            return (2 * d * di + 2 * d * n + d * h + 4 * (di + 2 * n)
                    + 3 * h + di + di * d + d)
        if kind == "cross":   # whisper decoder: self + cross + mlp
            return 2 * attn + mlp_mult * d * self.d_ff + 3 * d
        if kind == "xattn":   # vlm gated cross-attn layer: cross + mlp
            return attn + mlp_mult * d * self.d_ff + 2 * d + 1
        if kind == "shared":
            d2 = 2 * d
            attn2 = d2 * (self.n_heads + 2 * self.n_kv_heads) * hd \
                + self.n_heads * hd * d2
            return attn2 + mlp_mult * d2 * self.d_ff + d2 * d + 2 * d2
        raise ValueError(kind)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    import importlib
    for mod in ("qwen3_moe_30b_a3b", "mamba2_780m", "llama32_vision_11b",
                "olmo_1b", "whisper_tiny", "gemma_7b", "zamba2_1p2b",
                "smollm_135m", "mixtral_8x22b", "qwen3_32b", "paper_models"):
        importlib.import_module(f"{__package__}.{mod}")


def reduced(cfg: ArchConfig, *, n_layers: int = 2, d_model: int = 256,
            seq_cap: int = 512) -> ArchConfig:
    """CPU smoke-test variant of the same family (brief: <=2 layers,
    d_model<=512, <=4 experts)."""
    d = min(d_model, cfg.d_model)
    hd = 32
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = max(1, min(n_heads, cfg.n_kv_heads))
    while n_heads % n_kv:
        n_kv -= 1
    cross = tuple(i for i in (1,) if cfg.cross_attn_layers) \
        if cfg.cross_attn_layers else ()
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=n_layers,
        d_model=d,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        max_seq=seq_cap,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_d_ff=min(cfg.moe_d_ff, d) if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        sliding_window=min(cfg.sliding_window, 128) if cfg.sliding_window
        else 0,
        shared_attn_every=1 if cfg.shared_attn_every else 0,
        cross_attn_layers=cross,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 16) if cfg.frontend_tokens
        else 0,
        dtype="float32",
        remat=False,
    )
