"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.config.base import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str) -> Callable[[Callable[[], ModelConfig]], Callable[[], ModelConfig]]:
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        if arch_id in _REGISTRY:
            raise ValueError(f"duplicate arch id {arch_id!r}")
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    # Import lazily so `import repro_torch.config` never pulls the whole config package.
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
