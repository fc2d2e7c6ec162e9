from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import (
    ARCHS,
    arch_ids,
    get_config,
    get_shape,
    smoke_config,
    smoke_shape,
)

__all__ = [
    "ModelConfig", "ShapeConfig", "ARCHS", "arch_ids", "get_config",
    "get_shape", "smoke_config", "smoke_shape",
]
