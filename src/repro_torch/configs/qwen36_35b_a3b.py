"""Qwen3.6-35B-A3B-class MoE — the paper's own validation model (§6, Table 2).

The paper names "Qwen3.6-35B-A3B" (GGUF Q4_K_M, ~19.7 GB); we model it on the public
Qwen3-30B-A3B recipe: 48L, d_model=2048, 32Q/4KV heads (head_dim 128, qk-norm), 128 routed
experts top-8 with expert_d_ff=768, vocab 151936. This is the primary arch for the rotary
residency experiments (DESIGN.md §7). [hf:Qwen/Qwen3-30B-A3B; proxy for the paper's model]
"""
from repro_torch.config import AttentionConfig, ModelConfig, MoEConfig, register


@register("qwen36-35b-a3b")
def qwen36_35b_a3b() -> ModelConfig:
    return ModelConfig(
        name="qwen36-35b-a3b",
        family="moe",
        d_model=2048,
        vocab_size=151936,
        segments=((("attn_moe",), 48),),
        attention=AttentionConfig(num_heads=32, num_kv_heads=4, head_dim=128, qk_norm=True,
                                  rope_theta=1_000_000.0),
        moe=MoEConfig(num_experts=128, top_k=8, expert_d_ff=768, norm_topk_prob=True),
        mlp="swiglu",
        norm="rmsnorm",
        source="paper §6 Table 2; modeled on hf:Qwen/Qwen3-30B-A3B",
    )
