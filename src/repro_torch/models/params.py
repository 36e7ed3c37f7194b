"""Analytic parameter counts (the counterpart of ``repro/models/params.py``).

``analytic_params`` counts a configuration's parameters without allocating;
``active_only`` restricts MoE layers to the top-k routed + shared experts a
token reads. ``check_feasibility`` and the engine's modeled clock use them.
"""
from __future__ import annotations

from repro_torch.config.base import ModelConfig


def _block_params(cfg: ModelConfig, active_only: bool) -> int:
    """One ``attn_moe`` block (the only kind ``ModelConfig`` admits)."""
    d = cfg.d_model
    norm = d if cfg.norm == "rmsnorm" else 2 * d
    a = cfg.attention
    n = 2 * norm
    n += d * a.num_heads * a.head_dim * 2                  # wq, wo
    n += d * a.num_kv_heads * a.head_dim * 2               # wk, wv
    if a.qk_norm:
        n += 2 * a.head_dim
    m = cfg.moe
    experts = m.top_k if active_only else m.storage_experts
    mats = 3 if cfg.mlp == "swiglu" else 2
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
    n += cfg.d_model if cfg.norm == "rmsnorm" else 2 * cfg.d_model
    return n + cfg.num_layers * _block_params(cfg, active_only)
