"""Parameter and model-FLOP accounting (the counterpart of
``repro/models/params.py``).

``count_params`` walks a real parameter tree; ``analytic_params`` counts a
configuration's parameters without allocating; ``active_only`` restricts
MoE layers to the top-k routed + shared experts a token reads.
``check_feasibility`` and the engine's modeled clock use them, and the
trainer's MFU reads ``model_flops`` (6 x N(_active) x tokens).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.config.base import ModelConfig
from repro_torch.tree import leaves


def count_params(params: Any) -> int:
    return sum(int(p.numel()) for p in leaves(params))


def _block_params(cfg: ModelConfig, kind: str, active_only: bool) -> int:
    """One block of any kind, as the reference counts it."""
    d = cfg.d_model
    norm = d if cfg.norm == "rmsnorm" else 2 * d
    mats = 3 if cfg.mlp == "swiglu" else 2
    if kind == "mlstm":
        d_inner = 2 * d
        h = cfg.recurrent.num_heads
        # norm, up, q/k/v, i/f gates + bias, skip, down
        return (norm + d * 2 * d_inner + 3 * d_inner * d_inner + d_inner * 2 * h + 2 * h
                + d_inner + d_inner * d)
    if kind == "slstm":
        h = cfg.recurrent.num_heads
        up = (4 * d) // 3
        # norm, w_in + b, block-diagonal r, gated MLP
        return norm + d * 4 * d + 4 * d + 4 * h * (d // h) ** 2 + d * 2 * up + up * d
    if kind == "rglru":
        w = cfg.recurrent.lru_width or d
        # norms, branch in-projs, conv, gates + lambda, out, MLP
        return (2 * norm + 2 * d * w + cfg.recurrent.conv_width * w + w + 2 * w * w + w
                + w * d + mats * d * cfg.d_ff)
    a = cfg.attention
    n = 2 * norm
    n += d * a.num_heads * a.head_dim * 2                  # wq, wo
    n += d * a.num_kv_heads * a.head_dim * 2               # wk, wv
    if a.qk_norm:
        n += 2 * a.head_dim
    if kind != "attn_moe":                                 # attn_mlp, local_attn
        return n + mats * d * cfg.d_ff
    m = cfg.moe
    experts = m.top_k if active_only else m.storage_experts
    n += d * m.num_experts                                 # router (always read)
    n += experts * mats * d * m.expert_d_ff
    if m.num_shared_experts:
        sf = m.num_shared_experts * m.shared_d_ff
        n += 3 * d * sf + d                                # fused shared + gate
    return n


def analytic_params(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab_size * cfg.d_model                       # embed
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab_size                  # lm head
    if cfg.frontend is not None and cfg.frontend_dim != cfg.d_model:
        n += cfg.frontend_dim * cfg.d_model
    n += cfg.d_model if cfg.norm == "rmsnorm" else 2 * cfg.d_model
    return n + sum(_block_params(cfg, kind, active_only) for kind in cfg.layer_kinds)


def model_flops(cfg: ModelConfig, tokens: int) -> int:
    """MODEL_FLOPS = 6 x N(_active) x tokens (forward + backward; a
    forward-only caller divides by 3)."""
    return 6 * analytic_params(cfg, active_only=cfg.has_moe) * tokens


def param_summary(cfg: ModelConfig) -> Dict[str, float]:
    total = analytic_params(cfg, active_only=False)
    active = analytic_params(cfg, active_only=True)
    return {
        "total_params_B": total / 1e9,
        "active_params_B": active / 1e9,
        "bf16_bytes_GB": 2 * total / 2**30,
    }
