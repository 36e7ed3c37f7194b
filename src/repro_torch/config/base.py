"""Config system: frozen dataclasses describing models, residency and runs.

Every architecture in ``repro_torch.configs`` builds a :class:`ModelConfig`;
the engine pairs it with a :class:`ResidencyConfig`, the trainer with a
:class:`RunConfig`, the trainer and the sharded paths with a
:class:`ShardingConfig`.
Configs are plain data, so they can be constructed and diffed without
touching device state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# The block kinds the port's model assembly (repro_torch.models.transformer) runs.
BLOCK_KINDS = (
    "attn_mlp",     # full attention + dense MLP
    "attn_moe",     # full attention + MoE FFN
    "local_attn",   # sliding-window attention + dense MLP
    "mlstm",        # xLSTM matrix-memory block
    "slstm",        # xLSTM scalar-memory block
    "rglru",        # RecurrentGemma RG-LRU block (+ dense MLP)
)
# Kinds whose per-layer decode state is a KV cache (the rest carry a
# recurrent state, updated destructively by every step).
KV_KINDS = ("attn_mlp", "attn_moe", "local_attn")

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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
    # the training / prefill dispatch (models/moe.py: moe_dense, moe_sorted)
    # keeps at most max(k, ceil(T*k/E * capacity_factor)) assignments per
    # expert and drops the rest; decode and the engines are dropless
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01       # Switch load-balance loss weight
    router_z_coef: float = 1e-3         # router z-loss weight
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
class RecurrentConfig:
    """Settings for recurrent block kinds (rglru / xlstm)."""

    lru_width: int = 0             # RG-LRU hidden width (0 -> d_model)
    conv_width: int = 4            # temporal-conv width in the RG-LRU block
    num_heads: int = 4             # recurrence heads (xLSTM / RG-LRU block diagonal)


@dataclass(frozen=True)
class ModelConfig:
    """Complete architecture description.

    ``segments`` encodes the layer stack as a sequence of (unit, repeats): the
    unit is a tuple of block kinds executed in order, repeated ``repeats``
    times, e.g. ``((("attn_moe",), 48),)`` = 48 layers. ``attn_mlp`` and
    ``local_attn`` blocks run a dense MLP of width ``d_ff``; ``attn_moe``
    blocks need ``moe``; the recurrent kinds (``rglru``, ``mlstm``,
    ``slstm``) need ``recurrent``. A stack without attention blocks (xLSTM)
    has ``attention`` None.
    A ``frontend`` arch prepends ``frontend_len`` precomputed embeddings of
    width ``frontend_dim`` (projected to ``d_model`` when the widths
    differ) to the prompt at prefill.
    """

    name: str
    family: str                        # one of FAMILIES
    d_model: int
    vocab_size: int
    segments: Tuple[Tuple[Tuple[str, ...], int], ...]
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    d_ff: int = 0                      # dense-MLP hidden size (0 for pure-ssm archs)
    mlp: str = "swiglu"                # "swiglu" | "gelu_mlp" | "none"
    norm: str = "rmsnorm"              # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    frontend: Optional[str] = None     # None | "vision_patches" | "audio_frames"
    frontend_len: int = 0
    frontend_dim: int = 0
    source: str = ""                   # provenance note [paper/hf id; tier]

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        for unit, reps in self.segments:
            if reps <= 0:
                raise ValueError("segment repeats must be positive")
            for kind in unit:
                if kind not in BLOCK_KINDS:
                    raise ValueError(f"unknown block kind {kind!r}")
        if self.mlp not in ("swiglu", "gelu_mlp", "none"):
            raise ValueError(f"unknown mlp {self.mlp!r}")
        kinds = set(self.layer_kinds)
        if kinds & set(KV_KINDS) and self.attention is None:
            raise ValueError(f"{self.name}: attention blocks present but no AttentionConfig")
        if self.has_moe and self.moe is None:
            raise ValueError(f"{self.name}: attn_moe blocks present but no MoEConfig")
        if kinds & {"rglru", "mlstm", "slstm"} and self.recurrent is None:
            raise ValueError(f"{self.name}: recurrent blocks present but no RecurrentConfig")
        if kinds & {"attn_mlp", "local_attn", "rglru"} and self.d_ff <= 0:
            raise ValueError(f"{self.name}: {sorted(kinds)} blocks need d_ff > 0")

    @property
    def num_layers(self) -> int:
        return sum(len(unit) * reps for unit, reps in self.segments)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        kinds: list = []
        for unit, reps in self.segments:
            kinds.extend(list(unit) * reps)
        return tuple(kinds)

    @property
    def has_moe(self) -> bool:
        return any(k == "attn_moe" for k in self.layer_kinds)

    @property
    def uses_kv_cache(self) -> bool:
        return any(k in KV_KINDS for k in self.layer_kinds)

    @property
    def kv_only(self) -> bool:
        """Every layer's state is a KV cache (no recurrent layer)."""
        return all(k in KV_KINDS for k in self.layer_kinds)

    @property
    def num_moe_layers(self) -> int:
        return sum(k == "attn_moe" for k in self.layer_kinds)

    def require_moe(self, what: str) -> MoEConfig:
        """``moe`` for a caller that needs MoE layers; a dense config raises."""
        if not self.has_moe:
            raise ValueError(f"{what} requires an MoE architecture; {self.name} has no "
                             f"attn_moe layers")
        return self.moe


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
    ``quantization``: None (the model's type), ``int8`` (per-output-channel
    f32 scale) or ``int4`` (two nibbles per byte with an f16 scale and min per
    ``quant_group_size`` rows; ``repro_torch.quant``).
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
    quant_group_size: int = 64          # int4 rows per scale/min group

    def __post_init__(self) -> None:
        if self.mode not in ("full", "rotary", "lru", "static"):
            raise ValueError(f"unknown residency mode {self.mode!r}")
        if self.quantization not in (None, "int8", "int4"):
            raise ValueError(f"unknown quantization {self.quantization!r}")
        if self.quant_group_size < 2 or self.quant_group_size % 2:
            raise ValueError("quant_group_size must be an even integer >= 2")


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
REMAT_POLICIES = ("none", "full", "dots_saveable")
MOE_IMPLS = ("dense", "sorted", "epsum")


@dataclass(frozen=True)
class ShardingConfig:
    """The reference's ``ShardingConfig``, without its XLA-only switches
    (``scan_layers``, ``use_pallas``).

    Mesh axes (``distributed/sharding.py``): ``dp_axes`` carry the batch
    (``("pod", "data")`` on a multi-pod mesh), ``tp_axis`` the experts (EP)
    and, in the sharded prefill, the query positions (SP); ``seq_axis`` is
    the reference's sequence axis for long prefill; ``zero1`` shards the
    optimizer moments over the dp axes (a rule of ``opt_spec``).
    ``remat_policy``: per-layer activation checkpointing in training
    (``none``; ``full`` recomputes the layer; ``dots_saveable`` keeps the
    matmul outputs and recomputes the rest). ``moe_impl``: the MoE dispatch,
    ``dense`` (GShard one-hot einsums), ``sorted`` (sort + gather) or
    ``epsum`` (expert parallelism over ``tp_axis``), which falls back to
    ``sorted`` without a device mesh, as in the reference.
    ``grad_compression="int8_ef"``: the cross-pod int8 gradient reduction
    with error feedback (``training/compression.py``).
    """

    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    seq_axis: Optional[str] = "data"
    remat_policy: str = "dots_saveable"
    grad_compression: Optional[str] = None     # None | "int8_ef"
    zero1: bool = True
    moe_impl: str = "epsum"

    def __post_init__(self) -> None:
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {self.remat_policy!r}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"unknown moe impl {self.moe_impl!r}")
        if self.grad_compression not in (None, "int8_ef"):
            raise ValueError(f"unknown grad compression {self.grad_compression!r}")


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the reference's ``ShapeConfig``): the batch the
    sharding rules split over the dp axes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                                  # "train" | "prefill" | "decode"

    def __post_init__(self) -> None:
        if self.kind not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown shape kind {self.kind!r}")


@dataclass(frozen=True)
class RunConfig:
    """Training run hyperparameters (the reference's ``RunConfig``). Its
    fields that no code reads are left out: ``microbatch`` (the microbatch
    count is ``make_train_step(num_micro=)``), ``seed`` (``init_params``'
    and ``SyntheticSpec``'s), ``checkpoint_dir`` and ``keep_checkpoints``
    (``CheckpointManager(directory, keep=)``)."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    checkpoint_every: int = 200
    log_every: int = 10
