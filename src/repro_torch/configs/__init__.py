"""Architecture configs — one module per assigned architecture."""

from repro_torch.configs.base import (
    SHAPES,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    ShapeConfig,
    cells,
    get_config,
    get_smoke_config,
    list_archs,
    shape_applicable,
)

__all__ = [
    "SHAPES", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
    "ShapeConfig", "cells", "get_config", "get_smoke_config", "list_archs",
    "shape_applicable",
]
