"""Model configuration schema covering all assigned architecture families.

One frozen dataclass describes dense GQA transformers, MoE, pure SSM
(Mamba1/2), hybrid SSM+attention, encoder-decoder (audio), and VLM-stub
variants.  Every assigned arch is a concrete instance in a sibling module;
``smoke(cfg)`` derives the reduced CPU-testable variant of the same family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int

    # -- attention ----------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0            # 0 → d_model // n_heads
    qk_norm: bool = False
    attn_window: int = 0         # sliding-window width for local layers
    local_global_pattern: int = 0  # k → k local layers then 1 global; 0 = all global
    rope_base: float = 10_000.0

    # -- mlp ------------------------------------------------------------------
    d_ff: int = 0
    mlp_type: str = "swiglu"     # swiglu | geglu | relu2 | gelu

    # -- moe ------------------------------------------------------------------
    n_experts: int = 0
    experts_top_k: int = 0
    moe_every: int = 1           # MoE block every k-th layer (1 = every layer)
    shared_expert: bool = False  # llama4-style always-on shared FFN
    capacity_factor: float = 1.25

    # -- ssm ------------------------------------------------------------------
    ssm_type: str = "none"       # none | mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64       # mamba2 head width
    shared_attn_every: int = 0   # hybrid: shared attn block cadence (zamba2)

    # -- encoder-decoder (whisper) ---------------------------------------------
    encoder_layers: int = 0
    max_source_len: int = 1500   # audio frames after the (stubbed) conv frontend

    # -- modality frontend stubs -------------------------------------------------
    frontend: str = "none"       # none | audio | vision
    num_patches: int = 0         # vision prefix length (anyres tiles)

    # -- embeddings / numerics -----------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # -- derived ----------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_is_global(self, i: int) -> bool:
        """Local:global attention pattern (gemma3: 5 local then 1 global)."""
        if self.local_global_pattern == 0 or self.attn_window == 0:
            return True
        return (i + 1) % (self.local_global_pattern + 1) == 0

    def layer_is_moe(self, i: int) -> bool:
        return self.is_moe and (i % self.moe_every == 0)

    def param_count(self) -> int:
        """Approximate parameter count N for MODEL_FLOPS = 6·N·D."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        hd = self.head_dim_
        attn = 0
        if self.has_attention:
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * hd * d
        ff_mult = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[self.mlp_type]
        dense_ff = ff_mult * d * self.d_ff
        ssm = 0
        if self.ssm_type != "none":
            di, n = self.d_inner, self.ssm_state
            ssm = 2 * d * di + di * d          # in_proj(x,z) + out_proj
            ssm += di * self.ssm_conv
            if self.ssm_type == "mamba1":
                dt_rank = max(1, d // 16)
                ssm += di * n + di * 2         # A, D + dt bias-ish
                ssm += di * (dt_rank + 2 * n) + dt_rank * di
            else:
                ssm += d * (2 * n + 2 * self.ssm_heads) + self.ssm_heads * 2
        per_layer = 0
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.layer_is_moe(i))
        dense_layers = self.n_layers - moe_layers
        if self.family in ("dense", "encdec", "vlm"):
            per = attn + dense_ff
            total += self.n_layers * per
            if self.family == "encdec":
                total += self.encoder_layers * (attn + dense_ff)
                total += self.n_layers * attn  # cross attention
        elif self.family == "moe":
            moe_ff = ff_mult * d * self.d_ff * self.n_experts + d * self.n_experts
            if self.shared_expert:
                moe_ff += dense_ff
            total += moe_layers * (attn + moe_ff) + dense_layers * (attn + dense_ff)
        elif self.family == "ssm":
            total += self.n_layers * ssm
        elif self.family == "hybrid":
            total += self.n_layers * ssm
            if self.shared_attn_every:
                total += attn  # one shared block
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        ff_mult = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[self.mlp_type]
        inactive = (self.n_experts - self.experts_top_k) * ff_mult * d * self.d_ff
        moe_layers = sum(1 for i in range(self.n_layers)
                         if self.layer_is_moe(i))
        return self.param_count() - moe_layers * inactive


def smoke(cfg: ModelConfig) -> ModelConfig:
    """The reduced same-family variant used by CPU smoke tests."""
    n_layers = min(cfg.n_layers, 4 if cfg.shared_attn_every else 2)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        vocab=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=2 if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        n_experts=min(cfg.n_experts, 4),
        experts_top_k=min(cfg.experts_top_k, 2),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_type == "mamba2" else cfg.ssm_head_dim,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        max_source_len=16 if cfg.encoder_layers else cfg.max_source_len,
        num_patches=8 if cfg.num_patches else 0,
        attn_window=min(cfg.attn_window, 8) if cfg.attn_window else 0,
        local_global_pattern=min(cfg.local_global_pattern, 1),
        dtype="float32",
    )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
