from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState, Optimizer, adam, adamw, make_optimizer, momentum, sgd,
)
