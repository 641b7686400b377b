"""Serving step functions: prefill and decode.

``make_prefill_step(model, shape)`` and ``make_decode_step(model)``
return the functions a deployment calls, as the reference's
``repro.launch.steps`` does (there they are what the dry-run lowers and
pjits; here they run eagerly on the parameters' device). Prefill runs
without a gradient, so its attention is the flash kernel on the card.
``make_train_step`` is not ported yet: the federated client
(``core.client``) is the port's training path.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape
from repro_torch.models.zoo import Model


def make_train_step(*args, **kwargs):
    raise NotImplementedError(
        "make_train_step is not ported yet (ROADMAP queue 1 item 13); the "
        "federated client (repro_torch.core.client) trains the char-LM")


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
        return model.prefill(params, batch, use_decode_window=long,
                             max_new_tokens=max_new_tokens)

    return prefill_step


def make_decode_step(model: Model):
    """(params, caches, tokens (B, 1)) -> (logits (B, 1, V), caches); the
    caches are updated in place."""
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step
