"""xLSTM-350M: alternating mLSTM (matrix memory) / sLSTM (scalar memory)
blocks. [arXiv:2405.04517; unverified]
"""
from repro_torch.config import ModelConfig, RecurrentConfig, register


@register("xlstm-350m")
def xlstm_350m() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        family="ssm",
        d_model=1024,
        vocab_size=50304,
        segments=((("mlstm", "slstm"), 12),),   # 24 layers
        recurrent=RecurrentConfig(num_heads=4),
        d_ff=0,
        mlp="none",
        norm="rmsnorm",
        tie_embeddings=True,
        source="arXiv:2405.04517; unverified",
    )
