"""StarCoder2-3B — dense GQA+RoPE code LM. [arXiv:2402.19173; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register


@register("starcoder2-3b")
def starcoder2_3b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        d_model=3072,
        vocab_size=49152,
        segments=((("attn_mlp",), 30),),
        attention=AttentionConfig(num_heads=24, num_kv_heads=2, head_dim=128),
        d_ff=12288,
        mlp="gelu_mlp",
        norm="layernorm",
        source="arXiv:2402.19173; hf",
    )
