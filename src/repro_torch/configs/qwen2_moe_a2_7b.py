"""Qwen1.5/2-MoE-A2.7B — fine-grained MoE, 60 routed top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        d_model=2048,
        vocab_size=151936,
        segments=((("attn_moe",), 24),),
        attention=AttentionConfig(num_heads=16, num_kv_heads=16, head_dim=128),
        moe=MoEConfig(
            num_experts=60,
            top_k=4,
            expert_d_ff=1408,
            num_shared_experts=4,
            shared_d_ff=1408,
            norm_topk_prob=False,
            padded_experts=64,          # EP: 60 -> 64 never-routed dummies
        ),
        mlp="swiglu",
        norm="rmsnorm",
        source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
    )
