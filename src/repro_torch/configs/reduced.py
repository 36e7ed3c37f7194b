"""Reduced configs for CPU tests: the same block structure at tiny widths."""
from __future__ import annotations

import dataclasses

from repro_torch.config.base import AttentionConfig, ModelConfig, MoEConfig


def reduce_for_smoke(
    cfg: ModelConfig,
    *,
    d_model: int = 64,
    head_dim: int = 16,
    vocab: int = 256,
    max_repeats: int = 2,
) -> ModelConfig:
    """Shrink a full config while preserving its structure.

    Preserved: block-kind units, GQA-ness (MHA stays MHA, MQA stays MQA, grouped stays
    grouped), MoE shared/routed split, qk-norm, windowing, norm/mlp type.
    """
    attn = cfg.attention
    if attn is not None:
        if attn.num_kv_heads == attn.num_heads:
            heads, kv = 4, 4              # MHA
        elif attn.num_kv_heads == 1:
            heads, kv = 4, 1              # MQA
        else:
            heads, kv = 4, 2              # grouped
        attn = AttentionConfig(
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            rope_theta=attn.rope_theta,
            qk_norm=attn.qk_norm,
            window=min(attn.window, 16) if attn.window else None,
            logit_soft_cap=attn.logit_soft_cap,
        )
    moe = cfg.moe
    if moe is not None:
        moe = MoEConfig(
            num_experts=8,
            top_k=min(moe.top_k, 2),
            expert_d_ff=48,
            num_shared_experts=min(moe.num_shared_experts, 2),
            shared_d_ff=48 if moe.num_shared_experts else 0,
            norm_topk_prob=moe.norm_topk_prob,
        )
    segments = tuple((unit, min(reps, max_repeats)) for unit, reps in cfg.segments)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        vocab_size=vocab,
        segments=segments,
        attention=attn,
        moe=moe,
    )
