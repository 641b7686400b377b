from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState, Optimizer, adamw, make_optimizer,
)
