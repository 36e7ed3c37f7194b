"""Config system: frozen dataclasses describing models and residency.

Every architecture in ``repro_torch.configs`` builds a :class:`ModelConfig`;
the engine pairs it with a :class:`ResidencyConfig`. Configs are plain data,
so they can be constructed and diffed without touching device state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# The block kind the port's model assembly (repro_torch.models.transformer) runs.
BLOCK_KINDS = ("attn_moe",)     # full attention + MoE FFN


@dataclass(frozen=True)
class AttentionConfig:
    """Grouped-query attention settings."""

    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window size for local attention
    logit_soft_cap: Optional[float] = None

    def __post_init__(self) -> None:
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(
                f"num_heads={self.num_heads} must be divisible by "
                f"num_kv_heads={self.num_kv_heads}"
            )

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts FFN settings (routed + optional shared experts)."""

    num_experts: int
    top_k: int
    expert_d_ff: int
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    # normalize top-k router weights to sum to 1 (qwen-style) or use raw softmax mass
    norm_topk_prob: bool = True
    # EP padding: expert weights stored as [padded_experts, ...] with
    # never-routed zero dummies so the expert dim divides the model axis
    # (qwen2-moe 60 -> 64). 0 = num_experts (no padding).
    padded_experts: int = 0

    def __post_init__(self) -> None:
        if self.top_k > self.num_experts:
            raise ValueError("top_k cannot exceed num_experts")
        if self.padded_experts and self.padded_experts < self.num_experts:
            raise ValueError("padded_experts must be >= num_experts")

    @property
    def storage_experts(self) -> int:
        return self.padded_experts or self.num_experts


@dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description.

    ``segments`` encodes the layer stack as a sequence of (unit, repeats): the
    unit is a tuple of block kinds executed in order, repeated ``repeats``
    times, e.g. ``((("attn_moe",), 48),)`` = 48 layers.
    """

    name: str
    d_model: int
    vocab_size: int
    segments: Tuple[Tuple[Tuple[str, ...], int], ...]
    attention: AttentionConfig
    moe: MoEConfig
    mlp: str = "swiglu"                # "swiglu" | "gelu_mlp"
    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""                   # provenance note [paper/hf id; tier]

    def __post_init__(self) -> None:
        for unit, reps in self.segments:
            if reps <= 0:
                raise ValueError("segment repeats must be positive")
            for kind in unit:
                if kind not in BLOCK_KINDS:
                    raise NotImplementedError(
                        f"{self.name}: the port runs {BLOCK_KINDS} stacks only, got {kind!r}")

    @property
    def num_layers(self) -> int:
        return sum(len(unit) * reps for unit, reps in self.segments)


# ---------------------------------------------------------------------------
# Residency — the paper's contribution, configured here.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ResidencyConfig:
    """Rotary accelerator-residency settings (the paper's §4/§5 machinery).

    ``mode``:
      * ``full``   — every expert resident in HBM (EP-sharded); paper's "whole warehouse".
      * ``rotary`` — slot-group residency with cyclic forward/reverse rotation (the paper).
      * ``lru``    — least-recently-used eviction baseline the paper contrasts against.
      * ``static`` — fixed top-frequency resident set, never rotated.
    ``quantization`` other than None is not ported yet (``check_feasibility`` refuses it).
    """

    mode: str = "full"
    num_slots: int = 0                  # device-resident slots per MoE layer (0 = all)
    rotation_stride: int = 1
    prefetch_margin: int = 2            # slots reserved for in-flight prefetch
    predictor_ema: float = 0.8
    reverse_threshold: float = 0.85     # demand-correlation trigger for reverse rotation
    hbm_budget_bytes: Optional[int] = None
    host_compute_misses: bool = True    # paper's n-cpu-moe: misses run on host
    quantization: Optional[str] = None  # None | "int8" | "int4"

    def __post_init__(self) -> None:
        if self.mode not in ("full", "rotary", "lru", "static"):
            raise ValueError(f"unknown residency mode {self.mode!r}")
        if self.quantization not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
