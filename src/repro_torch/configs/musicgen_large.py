"""MusicGen-Large — decoder-only transformer over EnCodec tokens; the EnCodec/conditioning
frontend is a STUB (input_specs provides precomputed frame embeddings). [arXiv:2306.05284; hf]
"""
from repro_torch.config import AttentionConfig, ModelConfig, register


@register("musicgen-large")
def musicgen_large() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        d_model=2048,
        vocab_size=2048,
        segments=((("attn_mlp",), 48),),
        attention=AttentionConfig(num_heads=32, num_kv_heads=32, head_dim=64),
        d_ff=8192,
        mlp="gelu_mlp",
        norm="layernorm",
        frontend="audio_frames",
        frontend_len=256,        # 256 precomputed conditioning-frame embeddings prepended
        frontend_dim=2048,
        source="arXiv:2306.05284; hf",
    )
