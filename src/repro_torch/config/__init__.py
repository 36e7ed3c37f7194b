from repro_torch.config.base import (
    AttentionConfig, ModelConfig, MoEConfig, RecurrentConfig, ResidencyConfig, RunConfig,
    ShapeConfig, ShardingConfig,
)
from repro_torch.config.registry import get_config, list_archs, register

__all__ = [
    "AttentionConfig",
    "ModelConfig",
    "MoEConfig",
    "RecurrentConfig",
    "ResidencyConfig",
    "RunConfig",
    "ShapeConfig",
    "ShardingConfig",
    "get_config",
    "list_archs",
    "register",
]
