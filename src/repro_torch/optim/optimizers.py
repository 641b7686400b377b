"""Optimizers as plain functions on the parameter dict: SGD, momentum,
Adam and AdamW, each an ``(init, update)`` pair with
``update(grads, state, params) -> (updates, state)``, the convention of
``repro.optim.optimizers``; and its tree utilities ``apply_updates``,
``global_norm`` and ``clip_by_global_norm``. Each optimizer also has
``update_``, the same step written into the parameters and state it is
given (see ``Optimizer``).

Not ``torch.optim``: that one applies weight decay to every parameter it
holds (frozen leaves included) and orders the bias correction
differently. This keeps the reference's arithmetic (AdamW's lives in
``kernels/ref.py``, beside the fused kernel that repeats it): momentum
and moments in fp32 (bf16 storage for ``adamw_bf16``, computed in fp32
and rounded on store), bias corrections in fp32, decay on leaves with
``ndim >= 2`` only (which, in the stacked layout, includes the LayerNorm
scales and biases of the units), the step scaled by ``-lr``. Every
``update`` builds new tensors and never reads a value back to the host,
so it runs under ``torch.func.vmap`` (the batched executor vmaps it over
clients).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import telemetry
from repro_torch.kernels import ops, ref

Tensors = Dict[str, torch.Tensor]

#: elements of one parameter piece per step of the plain ``update_``
#: (its fp32 temporaries then take ~2 GB, not several times the largest
#: leaf)
UPDATE_PIECE = 1 << 26


class Optimizer(NamedTuple):
    """``update`` builds new tensors. ``update_(grads, state, params,
    mask=None)`` takes the same step in place, into ``params`` and
    ``state``, so that old and new state are never live together: AdamW
    on the card in one fused kernel per parameter
    (``kernels.ops.adamw_update_``), every other step a piece of a
    parameter (``UPDATE_PIECE`` elements along dim 0) at a time. A mask
    (a 0/1 tensor per parameter, broadcast against its leading dims)
    multiplies the gradients (in their own buffers on the plain path: a
    gradient shared by two parameters, or laid out with overlaps, is
    copied first), then the updates, each cast to the tensor's dtype. It
    empties ``grads`` as it goes, freeing each gradient once its
    parameter is updated."""
    init: Callable
    update: Callable
    update_: Callable


def _in_place(leaf_update: Callable, tick: Optional[Callable] = None
              ) -> Callable:
    """``Optimizer.update_`` from ``leaf_update(state, name, g, p, mask,
    step)``, which updates parameter ``name`` and its state in place;
    ``tick(state)`` advances the state's shared leaves once, before the
    parameters, and returns ``step`` (what the step's parameters
    share)."""

    @torch.no_grad()
    def update_(grads: Tensors, state, params: Tensors,
                mask: Optional[Tensors] = None):
        step = tick(state) if tick is not None else None
        if mask is not None:
            _own_buffers(grads)
        local_state = _local(state)
        for k in list(grads):
            g_all, p_all = grads.pop(k), params[k]
            m_all = None if mask is None else mask[k]
            g_all, p_all, m_all = _on_shards(g_all, p_all, m_all)
            leaf_update(local_state, k, g_all, p_all, m_all, step)
            del g_all
        return params, state

    return update_


def _piecewise(piece_update: Callable) -> Callable:
    """A ``leaf_update`` that steps the parameter a piece at a time
    (``ref.update_pieces_``), ``piece_update(state, name, rows, g, p)``
    giving the update of those rows and writing their state in place."""

    def leaf_update(state, name, g, p, m, step):
        ref.update_pieces_(g, p, m, functools.partial(piece_update, state,
                                                      name), UPDATE_PIECE)

    return leaf_update


def _local(tree):
    """A state tree with each DTensor replaced by its local shard (same
    storage: writes land in the DTensor)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.to_local()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_local(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _local(v) for k, v in tree.items()}
    return tree


def _on_shards(g, p, m):
    """A mesh's step updates each rank's shard in place: a DTensor
    parameter's gradient is redistributed to the parameter's placements
    (a ``Partial`` gradient reduced, a replicated one sliced), and the
    update runs on the local shards of gradient, parameter and mask
    (the elementwise arithmetic is the same on every shard)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(p, DTensor):
        return g, p, m
    if g.placements != p.placements:
        g = g.redistribute(p.device_mesh, p.placements)
    if isinstance(m, DTensor):
        if m.ndim and m.placements != p.placements:
            raise ValueError("a mask under a mesh must be split as its "
                             "parameter is")
        m = m.to_local()
    return g.to_local(), p.to_local(), m


def _own_buffers(grads: Tensors) -> None:
    """Make every gradient safe to write in place: autograd may hand one
    tensor to two parameters, or an expanded one (a broadcast's
    gradient); those are copied."""
    seen = set()
    for k, g in grads.items():
        if id(g) in seen or not g.is_contiguous():
            grads[k] = g.clone(memory_format=torch.contiguous_format)
        seen.add(id(g))


def sgd(lr: float) -> Optimizer:
    def init(params: Tensors):
        return ()

    @torch.no_grad()
    def update(grads: Tensors, state, params=None):
        return {k: -lr * g for k, g in grads.items()}, state

    def piece(state, name, rows, g, p):
        return -lr * g

    return Optimizer(init, update, _in_place(_piecewise(piece)))


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

    return Optimizer(init, update, _in_place(_piecewise(piece)))


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
        new = {k: ref.adamw_moments(state.mu[k], state.nu[k], g, b1, b2,
                                    moment_dtype)
               for k, g in grads.items()}
        mu = {k: m for k, (m, _) in new.items()}
        nu = {k: v for k, (_, v) in new.items()}
        bc1, bc2 = ref.adamw_corrections(count, b1, b2)
        ups = {k: ref.adamw_step(mu[k], nu[k], p, bc1, bc2, lr, eps,
                                 weight_decay)
               for k, p in params.items()}
        return ups, AdamState(mu=mu, nu=nu, count=count)

    def tick(state: AdamState):
        state.count.add_(1)
        count = _local(state.count)
        # the step's bias corrections, worked out once, when the fused
        # kernel first asks (the plain pieces work out their own)
        return functools.cache(lambda: ref.adamw_corrections(count, b1, b2))

    def leaf(state: AdamState, name, g, p, m, bias_corrections):
        mu, nu = state.mu[name], state.nu[name]
        # the least bytes the step moves: the gradient read, the
        # parameter and both moments read and written
        telemetry.count("optim.bytes", p.numel() * (
            g.element_size() + 2 * (p.element_size() + mu.element_size()
                                    + nu.element_size())))
        ops.adamw_update_(g, p, mu, nu, m, state.count, lr=lr, b1=b1, b2=b2,
                          eps=eps, weight_decay=weight_decay,
                          piece=UPDATE_PIECE, corrections=bias_corrections)

    return Optimizer(init, update, _in_place(leaf, tick))


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
