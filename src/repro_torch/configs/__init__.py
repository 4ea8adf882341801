from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config

__all__ = ["ARCH_IDS", "MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "get_config", "reduced_config"]
