from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, Budgets, DualConfig, FLConfig, FrontendConfig, InputShape,
    MLAConfig, MoEConfig, ModelConfig, RGLRUConfig, XLSTMConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_IDS, get_config, get_fl_config, get_smoke_config,
)
