"""Model configuration dataclasses (a copy of ``repro.configs.base``).

Every architecture is a :class:`ModelConfig`: a plain frozen dataclass, so
the port and the JAX package describe the same model with the same fields.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------
DENSE = "dense"          # attention + MLP decoder block
MOE = "moe"              # attention + routed-expert block
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block (sequential)
MAMBA2 = "mamba2"        # SSD block
SHARED_ATTN = "shared_attn"  # Zamba2 shared transformer block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01  # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Parameters shared by mLSTM / Mamba2 style blocks."""
    state_size: int = 64          # N (mamba2 state dim per head)
    conv_width: int = 4           # depthwise conv width (mamba2)
    expand: int = 2               # inner expansion factor
    chunk_size: int = 256         # chunked-scan block length
    num_ssm_heads: int = 0        # 0 -> derived from d_inner/headdim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 -> full attention
    local_global_pattern: int = 0  # k -> k local layers per 1 global layer
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    use_rope: bool = True          # False -> absolute (sinusoidal) positions
    norm_type: str = "rms"         # "rms" | "layernorm"
    mlp_kind: str = "gated_silu"   # "gated_silu" | "gelu"
    # --- mixture of experts -------------------------------------------------
    moe: Optional[MoEConfig] = None
    # --- ssm / hybrid -------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    hybrid_attn_period: int = 0    # zamba2: shared attn block every k blocks
    # --- enc-dec (audio) ----------------------------------------------------
    encoder_layers: int = 0        # 0 -> decoder-only
    encoder_seq: int = 0           # fixed encoder sequence (e.g. 1500 frames)
    # --- vlm ----------------------------------------------------------------
    vision_tokens: int = 0         # prefix patch-embedding count (stub frontend)
    # --- early exit (the paper's technique) ---------------------------------
    exit_layers: Tuple[int, ...] = ()   # 1-based layer indices with exit heads
    # --- citation -----------------------------------------------------------
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode: ssm, hybrid, or sliding-window dense."""
        return self.arch_type in ("ssm", "hybrid") or (
            self.sliding_window > 0 and self.local_global_pattern > 0
        )

    def block_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind sequence for the *decoder* stack."""
        if self.arch_type == "moe":
            return (MOE,) * self.n_layers
        if self.arch_type == "ssm":
            # xLSTM: sLSTM block at every 7th position (arXiv:2405.04517)
            return tuple(SLSTM if (i % 7 == 3) else MLSTM
                         for i in range(self.n_layers))
        if self.arch_type == "hybrid":
            # Zamba2: mamba2 backbone, shared attention block every
            # `hybrid_attn_period` layers.
            period = self.hybrid_attn_period or 6
            return tuple(SHARED_ATTN if (i % period == period - 1) else MAMBA2
                         for i in range(self.n_layers))
        return (DENSE,) * self.n_layers

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-decoder-layer sliding window (0 = full attention)."""
        if self.sliding_window and self.local_global_pattern:
            period = self.local_global_pattern + 1
            return tuple(self.sliding_window if (i % period) < self.local_global_pattern
                         else 0 for i in range(self.n_layers))
        if self.sliding_window:
            return (self.sliding_window,) * self.n_layers
        return (0,) * self.n_layers

    def validate(self) -> "ModelConfig":
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be a multiple of "
                             f"n_kv_heads")
        if self.exit_layers:
            if not all(1 <= l <= self.n_layers for l in self.exit_layers):
                raise ValueError(f"{self.name}: exit layer out of range")
            if tuple(sorted(self.exit_layers)) != self.exit_layers:
                raise ValueError(f"{self.name}: exit layers must be sorted")
        if self.arch_type == "moe" and self.moe is None:
            raise ValueError(f"{self.name}: moe arch needs a MoEConfig")
        return self


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_heads: int = 4, vocab: int = 512) -> ModelConfig:
    """A smoke-test-sized variant of the same family (<= 2 layers,
    d_model <= 512, <= 4 experts)."""
    kv = min(cfg.n_kv_heads, n_heads)
    while n_heads % kv:
        kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(cfg.moe, num_experts=4,
                                  top_k=min(2, cfg.moe.top_k),
                                  expert_d_ff=max(64, d_model // 4))
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_size=16, chunk_size=32)
    exits = (1,) if n_layers >= 2 else ()
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=kv,
        head_dim=d_model // n_heads,
        d_ff=0 if cfg.d_ff == 0 else d_model * 2,
        vocab_size=vocab,
        moe=moe,
        ssm=ssm,
        encoder_layers=min(cfg.encoder_layers, n_layers),
        encoder_seq=min(cfg.encoder_seq, 64),
        vision_tokens=min(cfg.vision_tokens, 16),
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window else 0,
        hybrid_attn_period=2 if cfg.hybrid_attn_period else 0,
        exit_layers=exits,
    ).validate()
