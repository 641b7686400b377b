from repro_torch.optim.optimizers import (  # noqa: F401
    AdamState, Optimizer, adam, adamw, apply_updates, clip_by_global_norm,
    global_norm, make_optimizer, momentum, sgd,
)
