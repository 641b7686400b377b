"""Learning-rate schedules (pure functions step -> lr), as
``repro.optim.schedules``: the same float arithmetic."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: lr


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` then cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``."""
    def f(step):
        s = float(step)
        if warmup_steps and s < warmup_steps:
            return peak_lr * (s + 1) / warmup_steps
        t = min(1.0, (s - warmup_steps) / max(1, total_steps - warmup_steps))
        cos = 0.5 * (1 + math.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return f


def inverse_sqrt(peak_lr: float, warmup_steps: int):
    """Linear warmup, then ``peak_lr * sqrt(warmup / step)``."""
    def f(step):
        s = float(step)
        if warmup_steps and s < warmup_steps:
            return peak_lr * (s + 1) / warmup_steps
        return peak_lr * math.sqrt(warmup_steps / max(s, 1.0))

    return f


def scale_lr_for_accum(lr: float, grad_accum: int, rule: str = "linear"):
    """The learning rate for a batch that Eq. 8 enlarged by gradient
    accumulation: times ``grad_accum`` ("linear"), times its square root
    ("sqrt"), or unchanged (any other rule)."""
    if rule == "linear":
        return lr * grad_accum
    if rule == "sqrt":
        return lr * math.sqrt(grad_accum)
    return lr
