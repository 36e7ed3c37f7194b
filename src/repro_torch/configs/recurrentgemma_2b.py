"""RecurrentGemma-2B: Griffin-style RG-LRU + local attention, 1 attn : 2
recurrent. [arXiv:2402.19427; hf]

26 layers = 8 x (rglru, rglru, local_attn) + 2 trailing rglru.
"""
from repro_torch.config import AttentionConfig, ModelConfig, RecurrentConfig, register


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        d_model=2560,
        vocab_size=256000,
        segments=(
            (("rglru", "rglru", "local_attn"), 8),
            (("rglru",), 2),
        ),
        attention=AttentionConfig(num_heads=10, num_kv_heads=1, head_dim=256, window=2048),
        recurrent=RecurrentConfig(lru_width=2560, conv_width=4, num_heads=10),
        d_ff=7680,
        mlp="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
        source="arXiv:2402.19427; hf",
    )
