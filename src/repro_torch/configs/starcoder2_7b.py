"""StarCoder2-7B — dense GQA+RoPE code LM. [arXiv:2402.19173; hf]"""
from repro_torch.config import AttentionConfig, ModelConfig, register


@register("starcoder2-7b")
def starcoder2_7b() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        d_model=4608,
        vocab_size=49152,
        segments=((("attn_mlp",), 32),),
        attention=AttentionConfig(num_heads=36, num_kv_heads=4, head_dim=128),
        d_ff=18432,
        mlp="gelu_mlp",
        norm="layernorm",
        source="arXiv:2402.19173; hf",
    )
