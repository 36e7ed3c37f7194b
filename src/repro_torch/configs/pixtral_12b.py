"""Pixtral-12B — mistral-nemo decoder backbone; pixtral-ViT frontend is a STUB
(input_specs provides precomputed patch embeddings). [hf:mistralai/Pixtral-12B-2409; unverified]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register


@register("pixtral-12b")
def pixtral_12b() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b",
        family="vlm",
        d_model=5120,
        vocab_size=131072,
        segments=((("attn_mlp",), 40),),
        attention=AttentionConfig(num_heads=32, num_kv_heads=8, head_dim=160,
                                  rope_theta=1_000_000.0),
        d_ff=14336,
        mlp="swiglu",
        norm="rmsnorm",
        frontend="vision_patches",
        frontend_len=1024,        # 1024 precomputed patch embeddings prepended
        frontend_dim=5120,
        source="hf:mistralai/Pixtral-12B-2409; unverified",
    )
