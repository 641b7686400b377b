"""Step functions: train, prefill and decode.

``make_train_step(model, optimizer, ...)``, ``make_prefill_step(model,
shape)`` and ``make_decode_step(model)`` return the functions a
deployment calls, as the reference's ``repro.launch.steps`` does (there
they are what the dry-run lowers and pjits; here they run eagerly on the
parameters' device). The train step takes its gradient through the
reference's memory design (each stacked unit and each loss chunk
recomputed in the backward pass), so its attention is the plain
``blockwise_attention``; prefill runs without a gradient, so its
attention is the flash kernel on the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch import telemetry
from repro_torch.configs.base import InputShape
from repro_torch.models.convert import as_params
from repro_torch.models.layers import active_mesh
from repro_torch.models.zoo import Model
from repro_torch.optim import Optimizer

Tensors = Dict[str, torch.Tensor]


def mesh_scope():
    """Under ``launch.mesh.use_mesh``: DTensor's implicit replication, so
    that the plain tensors a step makes (positions, masks, accumulators)
    join its DTensors as replicated ones; a null context otherwise."""
    if active_mesh()[0] is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_train_step(model: Model, optimizer: Optimizer,
                    with_freezing_mask: bool = False, microbatches: int = 1):
    """(params, opt_state, batch[, mask]) -> (params, opt_state, loss),
    the reference's train step.

    The loss and its gradient come from ``model.train_loss(..., remat=
    True)``. ``microbatches > 1`` splits the batch along dim 0, sums the
    slices' gradients and losses in fp32 and scales both by
    1 / microbatches; with one microbatch the gradients reach the
    optimizer in the parameters' dtype. A freezing mask
    (``core.freezing.mask_tree``) multiplies the gradients, then the
    updates, each cast to the tensor's dtype.

    The step runs on the parameters' device and donates its inputs, as
    the reference's dry-run jit does (``donate_argnums=(0, 1)``): the
    optimizer's ``update_`` writes the new parameters and state into the
    tensors it was given, which the step returns, so that old and new
    state are never live together (16 B a parameter under AdamW with an
    fp32 accumulator, not 24 plus several times the largest leaf): on
    the card AdamW in one fused kernel a parameter, with no temporaries;
    elsewhere a piece of a parameter at a time, so that the update's
    fp32 temporaries stay small. Keep a copy of what the caller still
    needs."""

    def grads_of(params: Tensors, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss, _ = model.train_loss(leaves, batch, remat=True)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        materialize_grads=True)
        return loss.detach(), dict(zip(leaves, grads))

    def accumulate(params: Tensors, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        if any(v.shape[0] % microbatches for v in batch.values()):
            raise ValueError(f"batch does not split into {microbatches} "
                             "equal microbatches")
        split = {k: torch.chunk(v, microbatches) for k, v in batch.items()}
        with telemetry.span("train.accumulate"):
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=next(iter(params.values())).device)
            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
        for i in range(microbatches):
            loss, grads = grads_of(params, {k: c[i] for k, c in split.items()})
            with telemetry.span("train.accumulate"):
                loss_sum = loss_sum + loss
                for k, g in grads.items():
                    gsum[k].add_(g)
            del grads
        scale = 1.0 / microbatches
        with telemetry.span("train.accumulate"):
            for g in gsum.values():
                g.mul_(scale)
            return loss_sum * scale, gsum

    @torch.no_grad()
    def train_step(params, opt_state, batch, mask: Optional[Tensors] = None):
        params = as_params(params)
        with mesh_scope():
            loss, grads = accumulate(params, batch)
            with telemetry.span("train.optimizer"):
                optimizer.update_(grads, opt_state, params, mask)
        return params, opt_state, loss

    if not with_freezing_mask:
        return lambda p, o, b: train_step(p, o, b, None)
    return train_step


def make_prefill_step(model: Model, shape: InputShape,
                      max_new_tokens: int = 0):
    """(params, batch) -> (last logits (B, 1, V), decode caches). The
    batch goes to the model whole: its tokens, and a vision frontend's
    ``patch_embeds`` or an encoder-decoder's ``src_embeds`` with them.

    ``long_500k`` windows the global layers' caches by the config's
    ``decode_window``, as the reference does. ``max_new_tokens`` leaves
    room in the global layers' caches for that many decode steps before
    the oldest token rolls out (the reference's ``prefill`` argument;
    its step passes 0)."""
    long = shape.name == "long_500k"

    def prefill_step(params, batch):
        with telemetry.span("serve.prefill"), mesh_scope():
            return model.prefill(params, batch, use_decode_window=long,
                                 max_new_tokens=max_new_tokens)

    return prefill_step


def make_decode_step(model: Model):
    """(params, caches, tokens (B, 1)) -> (logits (B, 1, V), caches); the
    caches are updated in place."""
    def decode_step(params, cache, tokens):
        with mesh_scope():
            return model.decode_step(params, cache, tokens)

    return decode_step
