from repro_torch.configs.base import (
    ArchConfig, MoEConfig, MLAConfig, SSMConfig, FrontendConfig,
    get_arch, list_archs, register,
)
from repro_torch.configs.shapes import (
    ShapeSuite, SHAPE_SUITES, get_shape,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

__all__ = [
    "ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "FrontendConfig",
    "get_arch", "list_archs", "register",
    "ShapeSuite", "SHAPE_SUITES", "get_shape",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
