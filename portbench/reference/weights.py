"""Weights made by the benchmark from ``--seed`` and handed to both sides.

Each leaf (and each layer's slice of a stacked leaf) is drawn from a
generator of its own on the device, seeded from the run's seed and the
leaf's name, in fp32 with one call and cast to the configuration's
dtype: the program gets the whole tree, and the reference draws any one
layer again when it needs it, without holding the rest. Matrices are
normal x 1/sqrt(fan in), embeddings normal x 0.02, layer norms scale 1
and bias 0, biases 0 (the port's own initialisation laws).

``leaf_specs(cfg)`` lists the leaves by the program's parameter names
(the interface through which the weights are handed over); ``cfg`` is a
configuration file's ``model`` section.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]     # per layer for a stacked leaf
    init: str                  # "normal" | "ones" | "zeros"
    std: float
    dtype: str
    stacked: bool              # leading axis: one slice per layer


def leaf_specs(cfg: Dict) -> List[Leaf]:
    d, h, kvh, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    dt, v = cfg["dtype"], cfg["vocab_size"]
    out = [Leaf("io.embed", (v, d), "normal", 0.02, dt, False),
           Leaf("io.final_norm.scale", (d,), "ones", 0.0, dt, False),
           Leaf("io.final_norm.bias", (d,), "zeros", 0.0, dt, False)]
    if not cfg["tie_embeddings"]:
        out.append(Leaf("io.head", (d, v), "normal", d ** -0.5, dt, False))
    if cfg.get("learned_pos_emb"):
        out.append(Leaf("io.pos_embed", (cfg["learned_pos_emb"], d),
                        "normal", 0.02, dt, False))
    u = "stack.units.b0."
    for ln in ("ln1", "ln2"):
        out += [Leaf(u + ln + ".scale", (d,), "ones", 0.0, dt, True),
                Leaf(u + ln + ".bias", (d,), "zeros", 0.0, dt, True)]
    out += [Leaf(u + "attn.wq", (d, h * hd), "normal", d ** -0.5, dt, True),
            Leaf(u + "attn.wk", (d, kvh * hd), "normal", d ** -0.5, dt, True),
            Leaf(u + "attn.wv", (d, kvh * hd), "normal", d ** -0.5, dt, True),
            Leaf(u + "attn.wo", (h * hd, d), "normal", (h * hd) ** -0.5, dt,
                 True)]
    if cfg.get("num_experts"):
        e, f = cfg["num_experts"], cfg["d_ff_expert"]
        out += [Leaf(u + "ffn.router", (d, e), "normal", d ** -0.5,
                     "float32", True),
                Leaf(u + "ffn.expert_gate", (e, d, f), "normal", d ** -0.5,
                     dt, True),
                Leaf(u + "ffn.expert_up", (e, d, f), "normal", d ** -0.5,
                     dt, True),
                Leaf(u + "ffn.expert_down", (e, f, d), "normal", f ** -0.5,
                     dt, True)]
    else:
        f = cfg["d_ff"]
        out += [Leaf(u + "ffn.w_up", (d, f), "normal", d ** -0.5, dt, True),
                Leaf(u + "ffn.b_up", (f,), "zeros", 0.0, dt, True),
                Leaf(u + "ffn.w_down", (f, d), "normal", f ** -0.5, dt, True),
                Leaf(u + "ffn.b_down", (d,), "zeros", 0.0, dt, True)]
    return out


def _seed_of(seed: int, name: str, layer: Optional[int]) -> int:
    key = f"{seed}:{name}:{layer}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


def draw(leaf: Leaf, seed: int, device, layer: Optional[int] = None
         ) -> torch.Tensor:
    """One leaf (one layer's slice of a stacked leaf), in its dtype."""
    dtype = DTYPES[leaf.dtype]
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_of(seed, leaf.name, layer))
    x = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(leaf.std).to(dtype)


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The whole tree, stacked leaves filled one layer at a time."""
    out = {}
    layers = cfg["num_layers"]
    for leaf in leaf_specs(cfg):
        if not leaf.stacked:
            out[leaf.name] = draw(leaf, seed, device)
            continue
        t = torch.empty((layers,) + leaf.shape, dtype=DTYPES[leaf.dtype],
                        device=device)
        for i in range(layers):
            t[i] = draw(leaf, seed, device, i)
        out[leaf.name] = t
    return out


def layer_weights(cfg: Dict, seed: int, device, layer: int,
                  dtype: Optional[torch.dtype] = None
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s slices of the stacked leaves, keyed by the name
    after ``stack.units.b0.`` (``attn.wq``, ...); in the configuration's
    dtypes, or cast to ``dtype`` after the draw."""
    out = {}
    for leaf in leaf_specs(cfg):
        if leaf.stacked:
            t = draw(leaf, seed, device, layer)
            out[leaf.name[len("stack.units.b0."):]] = (
                t if dtype is None else t.to(dtype))
    return out


def io_weights(cfg: Dict, seed: int, device,
               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    out = {}
    for leaf in leaf_specs(cfg):
        if not leaf.stacked:
            t = draw(leaf, seed, device)
            out[leaf.name] = t if dtype is None else t.to(dtype)
    return out
