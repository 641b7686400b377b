"""Optimizers as plain functions on the parameter dict: SGD, momentum,
Adam and AdamW, each an ``(init, update)`` pair with
``update(grads, state, params) -> (updates, state)``, the convention of
``repro.optim.optimizers``; and its tree utilities ``apply_updates``,
``global_norm`` and ``clip_by_global_norm``.

Not ``torch.optim``: that one applies weight decay to every parameter it
holds (frozen leaves included) and orders the bias correction
differently. This keeps the reference's arithmetic: momentum and moments
in fp32 (bf16 storage for ``adamw_bf16``, computed in fp32 and rounded
on store), bias corrections in fp32, decay on leaves with ``ndim >= 2``
only (which, in the stacked layout, includes the LayerNorm scales and
biases of the units), the step scaled by ``-lr``. Every update builds
new tensors and never reads a value back to the host, so it runs under
``torch.func.vmap`` (the batched executor vmaps it over clients).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def sgd(lr: float) -> Optimizer:
    def init(params: Tensors):
        return ()

    @torch.no_grad()
    def update(grads: Tensors, state, params=None):
        return {k: -lr * g for k, g in grads.items()}, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params: Tensors) -> Tensors:
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    @torch.no_grad()
    def update(grads: Tensors, state: Tensors, params=None):
        new_m = {k: beta * state[k] + g.to(torch.float32)
                 for k, g in grads.items()}
        return {k: -lr * m for k, m in new_m.items()}, new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: Tensors
    nu: Tensors
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0,
          moment_dtype: torch.dtype = torch.float32) -> Optimizer:
    def init(params: Tensors) -> AdamState:
        zeros = {k: torch.zeros_like(p, dtype=moment_dtype)
                 for k, p in params.items()}
        device = next(iter(params.values())).device
        count = torch.zeros((), dtype=torch.int32, device=device)
        return AdamState(mu=zeros,
                         nu={k: torch.zeros_like(z) for k, z in zeros.items()},
                         count=count)

    @torch.no_grad()
    def update(grads: Tensors, state: AdamState, params: Tensors):
        count = state.count + 1
        mu = {k: (b1 * state.mu[k].to(torch.float32)
                  + (1 - b1) * g.to(torch.float32)).to(moment_dtype)
              for k, g in grads.items()}
        nu = {k: (b2 * state.nu[k].to(torch.float32)
                  + (1 - b2) * torch.square(g.to(torch.float32))
                  ).to(moment_dtype)
              for k, g in grads.items()}
        cf = count.to(torch.float32)
        bc1 = 1 - b1 ** cf
        bc2 = 1 - b2 ** cf
        ups = {}
        for k, p in params.items():
            m = mu[k].to(torch.float32)
            v = nu[k].to(torch.float32)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay and p.ndim >= 2:   # decay matrices only
                step = step + weight_decay * p.to(torch.float32)
            ups[k] = (-lr * step).to(p.dtype)
        return ups, AdamState(mu=mu, nu=nu, count=count)

    return Optimizer(init, update)


def adam(lr: float, **kw) -> Optimizer:
    return adamw(lr, weight_decay=0.0, **kw)


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0
                   ) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr)
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay)
    if name == "adamw_bf16":
        # half-width moments: half the optimizer state's bytes
        return adamw(lr, weight_decay=weight_decay,
                     moment_dtype=torch.bfloat16)
    raise ValueError(name)


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``params + updates``, each update cast to its parameter's dtype."""
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def global_norm(tree: Tensors) -> torch.Tensor:
    """The L2 norm of every leaf together, in fp32, the leaves' squared
    sums added in the dict's order (the reference adds in JAX's leaf
    order, which the port's parameter dicts keep)."""
    total = 0
    for leaf in tree.values():
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Tensors, max_norm: float):
    """-> (grads scaled by min(1, max_norm / (norm + 1e-9)), norm). The
    fp32 scale promotes a narrower gradient to fp32, as in JAX."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: g.to(torch.promote_types(g.dtype, scale.dtype)) * scale
            for k, g in grads.items()}, norm
