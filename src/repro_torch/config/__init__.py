from repro_torch.config.base import AttentionConfig, ModelConfig, MoEConfig, ResidencyConfig
from repro_torch.config.registry import get_config, list_archs, register

__all__ = [
    "AttentionConfig",
    "ModelConfig",
    "MoEConfig",
    "ResidencyConfig",
    "get_config",
    "list_archs",
    "register",
]
