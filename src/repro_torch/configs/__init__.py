from repro_torch.configs.base import (  # noqa: F401
    Budgets, DualConfig, FLConfig, ModelConfig,
)
