"""AdamW as plain functions on the parameter dict: an ``(init, update)``
pair with ``update(grads, state, params) -> (updates, state)``, the
convention of ``repro.optim.optimizers``.

Not ``torch.optim.AdamW``: that one applies weight decay to every
parameter it holds (frozen leaves included) and orders the bias
correction differently. This keeps the reference's arithmetic: moments
and bias corrections in fp32, decay on leaves with ``ndim >= 2`` only
(which, in the stacked layout, includes the LayerNorm scales and
biases of the units), the step scaled by ``-lr``. SGD, momentum, Adam
and bf16 moments are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


class AdamState(NamedTuple):
    mu: Tensors
    nu: Tensors
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params: Tensors) -> AdamState:
        zeros = {k: torch.zeros_like(p, dtype=torch.float32)
                 for k, p in params.items()}
        device = next(iter(params.values())).device
        return AdamState(mu=zeros,
                         nu={k: torch.zeros_like(z) for k, z in zeros.items()},
                         count=torch.zeros((), dtype=torch.int32,
                                           device=device))

    @torch.no_grad()
    def update(grads: Tensors, state: AdamState, params: Tensors):
        count = state.count + 1
        mu = {k: b1 * state.mu[k] + (1 - b1) * g.to(torch.float32)
              for k, g in grads.items()}
        nu = {k: b2 * state.nu[k] + (1 - b2) * torch.square(g.to(torch.float32))
              for k, g in grads.items()}
        cf = count.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        ups = {}
        for k, p in params.items():
            step = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
            if weight_decay and p.ndim >= 2:   # decay matrices only
                step = step + weight_decay * p.to(torch.float32)
            ups[k] = (-lr * step).to(p.dtype)
        return ups, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0
                   ) -> Optimizer:
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name in ("sgd", "momentum", "adam", "adamw_bf16"):
        raise NotImplementedError(f"optimizer {name!r} is not ported yet")
    raise ValueError(name)
