"""Optimizers as plain functions on the parameter dict: SGD, momentum,
Adam and AdamW, each an ``(init, update)`` pair with
``update(grads, state, params) -> (updates, state)``, the convention of
``repro.optim.optimizers``; and its tree utilities ``apply_updates``,
``global_norm`` and ``clip_by_global_norm``. Each optimizer also has
``update_``, the same step written into the parameters and state it is
given (see ``Optimizer``).

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

from typing import Callable, Dict, NamedTuple, Optional

import torch

Tensors = Dict[str, torch.Tensor]

#: elements of one parameter piece per step of ``update_`` (its fp32
#: temporaries then take ~2 GB, not several times the largest leaf)
UPDATE_PIECE = 1 << 26


class Optimizer(NamedTuple):
    """``update`` builds new tensors. ``update_(grads, state, params,
    mask=None)`` takes the same step in place, into ``params`` and
    ``state``, a piece of a parameter (``UPDATE_PIECE`` elements along
    dim 0) at a time, so that old and new state are never live together.
    A mask (a 0/1 tensor per parameter, broadcast against its leading
    dims) multiplies the gradients in their own buffers (a gradient
    shared by two parameters, or laid out with overlaps, is copied
    first), then the updates, each cast to the tensor's dtype. It
    empties ``grads`` as it goes, freeing each gradient once its
    parameter is updated."""
    init: Callable
    update: Callable
    update_: Callable


def _in_place(piece_update: Callable, tick: Optional[Callable] = None
              ) -> Callable:
    """``Optimizer.update_`` from ``piece_update(state, name, rows, g, p)
    -> update of rows ``rows`` of parameter ``name````, which writes
    those rows of the state in place; ``tick(state)`` advances the
    state's shared leaves once, before the pieces."""

    @torch.no_grad()
    def update_(grads: Tensors, state, params: Tensors,
                mask: Optional[Tensors] = None):
        if tick is not None:
            tick(state)
        if mask is not None:
            _own_buffers(grads)
        for k in list(grads):
            g_all, p_all = grads.pop(k), params[k]
            m_all = None if mask is None else mask[k]
            for rows in _pieces(p_all):
                g, p = g_all[rows], p_all[rows]
                m = m_all if m_all is None or m_all.ndim == 0 else m_all[rows]
                if m is not None:
                    g.mul_(m.to(g.dtype))
                u = piece_update(state, k, rows, g, p)
                if m is not None:
                    u = u * m.to(u.dtype)
                p.add_(u.to(p.dtype))
            del g_all
        return params, state

    return update_


def _own_buffers(grads: Tensors) -> None:
    """Make every gradient safe to write in place: autograd may hand one
    tensor to two parameters, or an expanded one (a broadcast's
    gradient); those are copied."""
    seen = set()
    for k, g in grads.items():
        if id(g) in seen or not g.is_contiguous():
            grads[k] = g.clone(memory_format=torch.contiguous_format)
        seen.add(id(g))


def _pieces(t: torch.Tensor):
    """Index ranges along dim 0 of at most ~``UPDATE_PIECE`` elements
    (the whole tensor when it is 0-dim)."""
    if t.ndim == 0:
        yield ...
        return
    rows = max(1, UPDATE_PIECE // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


def sgd(lr: float) -> Optimizer:
    def init(params: Tensors):
        return ()

    @torch.no_grad()
    def update(grads: Tensors, state, params=None):
        return {k: -lr * g for k, g in grads.items()}, state

    def piece(state, name, rows, g, p):
        return -lr * g

    return Optimizer(init, update, _in_place(piece))


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params: Tensors) -> Tensors:
        return {k: torch.zeros_like(p, dtype=torch.float32)
                for k, p in params.items()}

    def advance(m, g):
        return beta * m + g.to(torch.float32)

    @torch.no_grad()
    def update(grads: Tensors, state: Tensors, params=None):
        new_m = {k: advance(state[k], g) for k, g in grads.items()}
        return {k: -lr * m for k, m in new_m.items()}, new_m

    def piece(state, name, rows, g, p):
        m = state[name][rows]
        m.copy_(advance(m, g))
        return -lr * m

    return Optimizer(init, update, _in_place(piece))


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

    def moments(mu, nu, g):
        g = g.to(torch.float32)
        return ((b1 * mu.to(torch.float32) + (1 - b1) * g).to(moment_dtype),
                (b2 * nu.to(torch.float32) + (1 - b2) * torch.square(g)
                 ).to(moment_dtype))

    def corrections(count):
        cf = count.to(torch.float32)
        return 1 - b1 ** cf, 1 - b2 ** cf

    def step_of(mu, nu, p, bc1, bc2):
        m = mu.to(torch.float32)
        v = nu.to(torch.float32)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay and p.ndim >= 2:   # decay matrices only
            step = step + weight_decay * p.to(torch.float32)
        return (-lr * step).to(p.dtype)

    @torch.no_grad()
    def update(grads: Tensors, state: AdamState, params: Tensors):
        count = state.count + 1
        new = {k: moments(state.mu[k], state.nu[k], g)
               for k, g in grads.items()}
        mu = {k: m for k, (m, _) in new.items()}
        nu = {k: v for k, (_, v) in new.items()}
        bc1, bc2 = corrections(count)
        ups = {k: step_of(mu[k], nu[k], p, bc1, bc2)
               for k, p in params.items()}
        return ups, AdamState(mu=mu, nu=nu, count=count)

    def tick(state: AdamState):
        state.count.add_(1)

    def piece(state: AdamState, name, rows, g, p):
        mu, nu = state.mu[name][rows], state.nu[name][rows]
        m, v = moments(mu, nu, g)
        mu.copy_(m)
        nu.copy_(v)
        return step_of(m, v, p, *corrections(state.count))

    return Optimizer(init, update, _in_place(piece, tick))


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
