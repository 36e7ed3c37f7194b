"""Phi-3-mini-3.8B — dense MHA (kv=heads) with RoPE + SwiGLU. [arXiv:2404.14219; unverified]"""
from repro_torch.config import AttentionConfig, ModelConfig, register


@register("phi3-mini-3.8b")
def phi3_mini() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        d_model=3072,
        vocab_size=32064,
        segments=((("attn_mlp",), 32),),
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=96),
        d_ff=8192,
        mlp="swiglu",
        norm="rmsnorm",
        source="arXiv:2404.14219; unverified",
    )
