"""The parameter layout of the port, and the bridge to and from the JAX
parameter tree.

Parameters keep the JAX tree path for path: the port's parameter dict
maps each dotted path (``"stack.units.b0.attn.wq"``) to a tensor of the
JAX leaf's shape, in JAX's leaf order (dict keys sorted at every level,
list items by index: ``stack.prefix.2`` before ``stack.prefix.10``), so
that every loop over leaves (``count_active``, the wire accounting) adds
in the reference's order. A list's items are the path components that
are all digits (no dict key of the model trees is). The scan-stacked
unit leaves keep their leading ``n_units`` axis: AdamW's ``ndim >= 2``
decay rule and the per-unit freezing mask both read that layout.

The layout is the reference's for every ported config: the char-LM's
units hold one block ``b0`` with layer norms, a biased GELU MLP and a
``pos_embed`` table; Gemma2's units hold a local block ``b0`` and a
global block ``b1``, each with RMS norms (one ``scale`` leaf), the
``post1`` / ``post2`` norms and a GeGLU MLP; an MoE block's ``ffn``
holds the f32 ``router`` and the expert stacks (n_units, E, d, f);
DeepSeek-V3's dense lead-in is the list ``stack.prefix``.
RecurrentGemma's remainder layers are the list ``stack.suffix``, and its
``rec`` blocks hold the RG-LRU (``rec.*``, with the f32 leaf
``lambda_raw``), ``ln2`` and ``ffn``; xLSTM's blocks hold ``mlstm.*``
(f32 gate leaves ``w_i``, ``b_i``, ``w_f``, ``b_f``) or ``slstm.*``
(f32 ``b_in``); SeamlessM4T's tree is ``io`` (with ``enc_norm`` and
``frontend_proj``), ``enc`` and ``dec``, each stack with a leading
layer axis. A leaf keeps its dtype both ways, so a bf16 model's f32
leaves stay f32.

``ParamTree`` is the ``nn.Module`` that holds such a dict, with the same
dotted names as its parameter names. ``params_from_numpy`` and
``params_to_numpy`` move a JAX tree (as a nested dict of NumPy arrays)
in and out, so both packages can run from the same initial weights; a
bfloat16 leaf (NumPy's ``ml_dtypes`` type, as JAX hands it out) comes in
through its 16-bit pattern.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def _path_key(name: str):
    return tuple((0, int(part), "") if part.isdigit() else (1, 0, part)
                 for part in name.split("."))


def jax_order(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The same mapping with keys in JAX's leaf order."""
    return {k: flat[k] for k in sorted(flat, key=_path_key)}


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {dotted path: leaf} in JAX's leaf order."""
    out: Dict[str, Any] = {}
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(flatten(value, name + "."))
        elif isinstance(value, (list, tuple)):
            out.update(flatten(dict(enumerate(value)), name + "."))
        else:
            out[name] = value
    return out


def unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{dotted path: leaf} -> nested dict, with lists where the keys are
    list indices (no copies)."""
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = tree
        *parents, last = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return _lists(tree)


def _lists(node):
    if not isinstance(node, dict):
        return node
    items = {k: _lists(v) for k, v in node.items()}
    if items and all(k.isdigit() for k in items):
        return [items[str(i)] for i in range(len(items))]
    return items


class ParamTree(nn.Module):
    """An ``nn.Module`` whose parameter names are the JAX tree paths.

    The parameters do not require grad: the client computes gradients
    functionally on detached copies (see ``core.client``)."""

    def __init__(self, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in jax_order(flat).items():
            *parents, last = name.split(".")
            mod: nn.Module = self
            for p in parents:
                if p not in mod._modules:
                    mod.add_module(p, nn.Module())
                mod = mod._modules[p]
            mod.register_parameter(last, nn.Parameter(t, requires_grad=False))

    def params(self) -> Params:
        """The parameter dict (sharing storage), in JAX's leaf order."""
        return jax_order({n: p.detach() for n, p in self.named_parameters()})


def as_params(params: Union[ParamTree, Mapping[str, torch.Tensor]]) -> Params:
    """Accept a ``ParamTree`` or a parameter dict; return the dict."""
    if isinstance(params, ParamTree):
        return params.params()
    return dict(params)


def params_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> ParamTree:
    """JAX params as a nested dict of NumPy arrays -> ``ParamTree`` on
    ``device`` (``None`` -> ``"cuda"``), same paths, shapes and dtypes."""
    dev = resolve_device(device)
    return ParamTree({name: _from_numpy(leaf).to(dev)
                      for name, leaf in flatten(tree).items()})


def _from_numpy(leaf) -> torch.Tensor:
    a = np.array(leaf, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_to_numpy(params: Union[ParamTree, Mapping[str, torch.Tensor]]
                    ) -> Dict[str, Any]:
    """The inverse: a nested dict of NumPy arrays in the JAX layout."""
    return unflatten({name: t.detach().cpu().numpy()
                      for name, t in as_params(params).items()})
