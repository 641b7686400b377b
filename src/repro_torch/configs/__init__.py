from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, Budgets, DualConfig, FLConfig, InputShape, ModelConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    get_config, get_fl_config,
)
