"""Model zoo: the decoder-only ``Model`` of the char-LM.

``build(cfg)`` returns a ``Model``:

    init(gen, device=None) -> ParamTree
    train_loss(params, batch) -> (loss, metrics)
    param_count() -> {"total", "active"}

``params`` is a ``ParamTree`` or the parameter dict (dotted JAX paths ->
tensors, see ``models.convert``). A batch holds integer ``tokens`` and
``targets`` of shape (B, S). The embedding is tied: the unembedding is
``embed.T``. The loss is the mean cross-entropy over all tokens (the
reference's chunked CE is one chunk at the char-LM's size) plus an aux
loss of 0. ``prefill``, ``decode_step``, loss masks and the
encoder-decoder model are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import ParamTree, as_params, flatten, unflatten


def ce_loss(x, w_unembed, targets):
    """x: (B,S,D), w_unembed: (D,V), targets: (B,S) -> mean CE in fp32."""
    logits = (x @ w_unembed).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return torch.sum(lse - ll) / targets.numel()


def io_init(gen, cfg: ModelConfig, device):
    return {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  cfg.param_dtype, device),
            "final_norm": L.norm_init(cfg, device),
            "pos_embed": L.embed_init(gen, cfg.learned_pos_emb, cfg.d_model,
                                      cfg.param_dtype, device)}


def embed_tokens(p, tokens, cfg: ModelConfig):
    """Token embedding plus the learned position of each column."""
    b, s = tokens.shape
    x = torch.index_select(p["embed"], 0, tokens.reshape(-1))
    x = x.reshape(b, s, -1).to(cfg.compute_dtype)
    return x + p["pos_embed"][:s].to(cfg.compute_dtype)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init_tree(self, gen: torch.Generator, device: DeviceLike = None):
        """The parameters as a nested dict of tensors (the JAX layout)."""
        dev = resolve_device(device)
        return {"io": io_init(gen, self.cfg, dev),
                "stack": T.stack_init(gen, self.cfg, dev)}

    def init(self, gen: torch.Generator, device: DeviceLike = None
             ) -> ParamTree:
        """Fresh parameters from ``gen`` (a CPU ``torch.Generator``; the
        draws are made on the CPU and moved, so a seed gives the same
        weights on every device): normal x 1/sqrt(fan_in) for matrices,
        normal x 0.02 for the embeddings, ones/zeros for norms and
        biases."""
        return ParamTree(flatten(self.init_tree(gen, device)))

    def train_loss(self, params, batch):
        cfg = self.cfg
        p = unflatten(as_params(params))
        tokens = batch["tokens"]
        x = embed_tokens(p["io"], tokens, cfg)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        x = T.stack_apply_full(p["stack"], x, positions, cfg)
        x = L.norm_apply(p["io"]["final_norm"], x)
        w = p["io"]["embed"].T.to(cfg.compute_dtype)
        ce = ce_loss(x, w, batch["targets"])
        return ce, {"ce": ce, "aux": 0.0}

    def param_count(self) -> Dict[str, int]:
        tree = self.init_tree(torch.Generator().manual_seed(0), "cpu")
        total = sum(math.prod(t.shape) for t in flatten(tree).values())
        return {"total": total, "active": total}


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
