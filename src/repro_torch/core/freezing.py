"""Freezing depth (the policy's ``k`` knob) as a parameter mask dict.

``k`` = number of *top* (closest-to-head) unfrozen transformer layers.
Frozen layers carry no gradients, no optimizer movement, and are excluded
from ``params_active``, which is what the paper's E/C/M proxies charge
for. The mask maps each parameter name to a 0/1 f32 tensor shaped to
broadcast against the leaf: a scalar for the io leaves and for each
prefix layer's, and per unit along axis 0 (``(n_units, 1, ...)``) for
the stacked unit leaves.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.convert import as_params
from repro_torch.models.transformer import stack_plan

_IO_FREEZABLE = ("embed", "pos_embed", "frontend_proj")


def mask_tree(params: Any, cfg: ModelConfig, k: int) -> Dict[str, torch.Tensor]:
    """1.0 = trainable, 0.0 = frozen. Top-k layers + head/final norm are
    trainable; embeddings freeze whenever any layer is frozen."""
    params = as_params(params)
    prefix, unit, n_units, suffix = stack_plan(cfg)
    n_prefix, unit_len = len(prefix), len(unit)
    total = cfg.num_layers
    k = max(1, min(k, total))
    first_unfrozen = total - k          # layer index of first trainable layer
    unit_first_layer = np.arange(n_units) * unit_len + n_prefix
    # a unit is trainable iff its *last* layer is unfrozen; partial units
    # round down (freeze)
    unit_last_layer = unit_first_layer + unit_len - 1
    unit_trainable = (unit_last_layer >= first_unfrozen).astype(np.float32)
    full = k >= total

    mask = {}
    for name, leaf in params.items():
        path = name.split(".")
        if path[:2] == ["stack", "units"]:
            vec = torch.as_tensor(unit_trainable, device=leaf.device)
            mask[name] = vec.reshape((n_units,) + (1,) * (leaf.ndim - 1))
            continue
        if path[:2] == ["stack", "prefix"]:
            trainable = int(path[2]) >= first_unfrozen
        else:
            trainable = (not (path[0] == "io" and path[1] in _IO_FREEZABLE)
                         or full)
        mask[name] = torch.tensor(1.0 if trainable else 0.0,
                                  dtype=torch.float32, device=leaf.device)
    return mask


def apply_mask(tree: Dict[str, torch.Tensor], mask: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    return {k: t * mask[k].to(t.dtype) for k, t in tree.items()}


def count_params(params: Any) -> int:
    return sum(int(np.prod(l.shape)) for l in as_params(params).values())


def count_active(params: Any, mask: Dict[str, torch.Tensor]) -> float:
    """Masked parameter count (params the round actually trains/ships),
    with the reference's float arithmetic and leaf order."""
    total = 0.0
    for name, leaf in as_params(params).items():
        m_arr = mask[name].cpu().numpy()
        size = np.prod(leaf.shape)
        if m_arr.ndim == 0:
            total += float(m_arr) * size
        else:
            frac = float(np.mean(m_arr))
            total += frac * size
    return total
