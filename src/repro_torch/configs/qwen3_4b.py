"""Qwen3-4B — dense GQA with qk-norm. [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register


@register("qwen3-4b")
def qwen3_4b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-4b",
        family="dense",
        d_model=2560,
        vocab_size=151936,
        segments=((("attn_mlp",), 36),),
        # Qwen3 decouples head_dim from d_model/num_heads (explicit head_dim=128).
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=128, qk_norm=True,
                                  rope_theta=1_000_000.0),
        d_ff=9728,
        mlp="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        source="hf:Qwen/Qwen3-8B; hf",
    )
