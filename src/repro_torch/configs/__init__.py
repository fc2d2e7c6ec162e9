from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import (
    ARCHS,
    arch_ids,
    get_config,
    smoke_config,
)

__all__ = [
    "ModelConfig", "ShapeConfig", "ARCHS", "arch_ids", "get_config",
    "smoke_config",
]
