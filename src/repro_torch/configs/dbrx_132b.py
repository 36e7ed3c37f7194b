"""DBRX-132B — coarse-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, register


@register("dbrx-132b")
def dbrx() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        family="moe",
        d_model=6144,
        vocab_size=100352,
        segments=((("attn_moe",), 40),),
        attention=AttentionConfig(num_heads=48, num_kv_heads=8, head_dim=128,
                                  rope_theta=500_000.0),
        moe=MoEConfig(num_experts=16, top_k=4, expert_d_ff=10752),
        mlp="swiglu",
        norm="layernorm",
        source="hf:databricks/dbrx-base; unverified",
    )
