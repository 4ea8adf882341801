from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import (ARCH_IDS, REDUCED_SHAPE, cells,
                                          get_config, reduced_config)
from repro_torch.configs.shapes import (SHAPES, ShapeConfig, get_shape,
                                        shape_applicable)

__all__ = ["ARCH_IDS", "MLAConfig", "ModelConfig", "MoEConfig", "REDUCED_SHAPE",
           "SHAPES", "SSMConfig", "ShapeConfig", "cells", "get_config",
           "get_shape", "reduced_config", "shape_applicable"]
