"""Decoder stack in the reference's stacked-units layout.

The reference stacks each repeating unit's parameters along a leading
``n_units`` axis and drives it with ``jax.lax.scan``. The port keeps that
parameter layout (AdamW's ``ndim >= 2`` decay rule and the per-unit
freezing mask both read it) and loops over the axis in Python. The
char-LM's unit is one attention block; prefix/suffix layers, the
recurrent block kinds, MoE and the decode caches are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def stack_plan(cfg: ModelConfig):
    """-> (prefix_kinds, unit_kinds, n_units, suffix_kinds): every layer is
    one unit of a single attention block."""
    return [], ["attn"], cfg.num_layers, []


def block_init(gen, cfg: ModelConfig, device):
    return {"ln1": L.norm_init(cfg, device),
            "attn": L.attn_init(gen, cfg, device),
            "ln2": L.norm_init(cfg, device),
            "ffn": L.mlp_init(gen, cfg, device)}


def block_apply_full(p, x, positions, cfg: ModelConfig):
    """Pre-norm attention block; its aux loss is 0."""
    x = x + L.attn_apply_full(p["attn"], L.norm_apply(p["ln1"], x), positions,
                              cfg)
    return x + L.mlp_apply(p["ffn"], L.norm_apply(p["ln2"], x))


def _stack_leaves(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_leaves([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unit_slice(tree, u: int):
    if isinstance(tree, dict):
        return {k: _unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def stack_init(gen, cfg: ModelConfig, device):
    _, unit, n_units, _ = stack_plan(cfg)
    units = [{f"b{j}": block_init(gen, cfg, device) for j in range(len(unit))}
             for _ in range(n_units)]
    return {"units": _stack_leaves(units)}


def stack_apply_full(params, x, positions, cfg: ModelConfig):
    """Loops over the stacked ``units`` axis."""
    _, unit, n_units, _ = stack_plan(cfg)
    for u in range(n_units):
        unit_params = _unit_slice(params["units"], u)
        for j in range(len(unit)):
            x = block_apply_full(unit_params[f"b{j}"], x, positions, cfg)
    return x
