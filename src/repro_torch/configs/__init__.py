from repro_torch.configs.base import (
    ArchConfig, MoEConfig, MLAConfig, SSMConfig, FrontendConfig,
    get_arch, list_archs, register,
)

__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "FrontendConfig",
    "get_arch", "list_archs", "register",
]
