from repro_torch.configs.base import (  # noqa: F401
    Budgets, DualConfig, FLConfig, ModelConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    get_config, get_fl_config,
)
