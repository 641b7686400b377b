"""Input and decode-cache stand-ins for every (architecture x input
shape), and the sharding recipe of every parameter, batch and cache leaf
on a mesh.

The stand-ins are tensors on the meta device, with the reference's
shapes and dtypes (``repro.launch.specs.input_specs`` / ``cache_specs``),
so that nothing is allocated; the dry-run turns them into fake tensors.

The recipe is the reference's table (``_recipe``, first match wins):
Megatron-orientation tensor parallelism on ``model``, FSDP-style
parameter splits on ``data``, expert parallelism for MoE (the expert dim
on ``model``), the batch over (pod, data); ``long_500k`` (batch 1)
splits the KV cache's sequence over ``data``, and KV heads that cannot
cover ``model`` (Gemma2's 8 on 16) give the sequence to ``model``. Its
three recipes are ``RECIPES``. A spec maps tensor dims to mesh axes, as
a ``PartitionSpec`` does; ``param_shardings``, ``batch_shardings`` and
``cache_shardings`` turn each into DTensor placements (mesh dims to
tensor dims, ``placements_of``), ``spec_of`` back, and ``distribute``
places a tree of tensors by them. The port's parameters are a flat dict
of dotted paths (``models/convert.py``), matched with ``.`` read as
``/``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch.mesh import axis_names, axis_size, batch_axes

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Batch stand-ins for train / prefill; decode adds cache stand-ins
    separately. An encoder-decoder splits the length into source frames
    and target tokens (at decode the source is the fixed 4,096-frame
    memory); a vision frontend's patch tokens come out of the text
    length."""
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.encdec:
        s_src, s_tgt = s // 2, s - s // 2
        if shape.kind == "decode":
            s_src = min(s_src, 4096)        # fixed encoder memory at decode
        out["src_embeds"] = sds((b, s_src, cfg.frontend.embed_dim),
                                torch.float32)
        out["tokens"] = sds((b, s_tgt), torch.int32)
        if shape.kind == "train":
            out["targets"] = sds((b, s_tgt), torch.int32)
        return out
    n_text = s
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        out["patch_embeds"] = sds((b, cfg.frontend.num_prefix_tokens,
                                   cfg.frontend.embed_dim), torch.float32)
        n_text = s - cfg.frontend.num_prefix_tokens
    out["tokens"] = sds((b, n_text), torch.int32)
    if shape.kind == "train":
        out["targets"] = sds((b, n_text), torch.int32)
    return out


def cache_specs(model, cfg: ModelConfig, shape: InputShape):
    """Decode-cache stand-ins (``long_500k`` windows the global layers'
    caches by ``decode_window``; an encoder-decoder's cross K/V cover
    4,096 source frames)."""
    long = shape.name == "long_500k"
    if cfg.encdec:
        return model.init_cache(shape.global_batch, shape.seq_len, long=long,
                                src_len=4096, device=META)
    return model.init_cache(shape.global_batch, shape.seq_len, long=long,
                            device=META)


# ---------------------------------------------------------------------------
# sharding recipe
# ---------------------------------------------------------------------------

# A spec maps each tensor dim to a mesh axis, a tuple of axes (split major
# to minor) or None, as the reference's ``PartitionSpec`` does; ``None``
# as a whole spec means replicated.
Spec = Optional[Tuple]


def _recipe(dp, mp) -> List[Tuple[str, Spec]]:
    """name-pattern -> spec; first match wins. dp = data (params keep to
    data; the batch adds pod), mp = model. The reference's table."""
    return [
        # --- MoE expert banks (E, in, out): expert-parallel on model ---
        (r"ffn/(expert_gate|expert_up)$", (mp, dp, None)),
        (r"ffn/expert_down$", (mp, None, dp)),
        (r"ffn/router$", (dp, None)),
        # --- MLA ---
        (r"attn/w_dq$", (dp, mp)),
        (r"attn/w_uq$", (None, mp)),
        (r"attn/w_dkv$", (dp, None)),
        (r"attn/w_uk$", (None, mp)),
        (r"attn/w_uv$", (None, mp)),
        (r"attn/w_kr$", (dp, None)),
        # --- attention (megatron orientation) ---
        (r"(attn|self_attn|cross_attn)/w[qkv]$", (dp, mp)),
        (r"(attn|self_attn|cross_attn)/b[qkv]$", (mp,)),
        (r"(attn|self_attn|cross_attn)/wo$", (mp, dp)),
        # --- dense MLP ---
        (r"(ffn|shared)/(w_gate|w_up)$", (dp, mp)),
        (r"(ffn|shared)/b_up$", (mp,)),
        (r"(ffn|shared)/w_down$", (mp, dp)),
        (r"(ffn|shared)/b_down$", (dp,)),
        # --- xLSTM ---
        (r"mlstm/w_up$", (dp, mp)),
        (r"mlstm/conv_w$", (None, mp)),
        (r"mlstm/w[qkv]$", (dp, mp)),
        (r"mlstm/w_[if]$", (dp, None)),
        (r"mlstm/(skip_scale|gn_scale)$", (mp,)),
        (r"mlstm/w_down$", (mp, dp)),
        (r"slstm/w_in$", (dp, mp)),
        (r"slstm/b_in$", (mp,)),
        (r"slstm/r_blocks$", (None, None, None, None)),
        (r"slstm/gn_scale$", (None,)),
        (r"slstm/w_up$", (dp, mp)),
        (r"slstm/w_down$", (mp, dp)),
        # --- RG-LRU ---
        (r"rec/(w_gate_branch|w_rec_branch)$", (dp, mp)),
        (r"rec/conv_w$", (None, mp)),
        (r"rec/w_[ri]$", (dp, mp)),
        (r"rec/lambda_raw$", (mp,)),
        (r"rec/w_out$", (mp, dp)),
        # --- io ---
        (r"io/embed$", (mp, dp)),
        (r"io/head$", (dp, mp)),
        (r"io/pos_embed$", (None, None)),
        (r"io/frontend_proj$", (None, dp)),
        # --- norms & everything 1-D: replicated ---
        (r".*", None),
    ]


RECIPES = {
    # (dp_axis, mp_axis): Megatron-TP on `model` + FSDP on `data`
    "default": ("data", "model"),
    # serving: params replicated over data (no per-step FSDP gathers),
    # TP over model
    "tp_serve": (None, "model"),
    # pure ZeRO/FSDP over the combined (data, model) axes, no tensor
    # parallelism (small-hidden recurrent archs: xLSTM)
    "fsdp": (("data", "model"), None),
}

#: ``shard_batch``'s batch axes under each recipe (the reference's
#: ``REPRO_BATCH_AXES``: the dry-run sets "pod,data,model" under fsdp)
SHARD_BATCH_AXES = {"default": ("pod", "data"), "tp_serve": ("pod", "data"),
                    "fsdp": ("pod", "data", "model")}


def _leaf_spec(path: str, shape, recipe, n_lead: int) -> Tuple:
    for pat, spec in recipe:
        if re.search(pat, path):
            if spec is None:
                return ()
            parts = list(spec) + [None] * max(0, len(shape) - n_lead
                                              - len(spec))
            parts = parts[: len(shape) - n_lead]
            return tuple([None] * n_lead + parts)
    return ()


def _tree_paths(tree, prefix=""):
    """(``/``-joined path, leaf) of a nested dict / list tree, dict keys
    sorted. A tuple is a leaf (a spec, or a tensor's placements)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _path(name: str) -> str:
    return "/" + name.replace(".", "/")


def _divisible(dim: int, mesh, axis) -> bool:
    if axis is None:
        return True
    names = axis if isinstance(axis, tuple) else (axis,)
    n = 1
    for name in names:
        n *= axis_size(mesh, name)
    return dim % n == 0


def placements_of(spec: Sequence, mesh) -> tuple:
    """A spec (tensor dim -> axis / axes / None) -> DTensor placements
    (mesh dim -> ``Shard(d)`` / ``Replicate()``). A tuple of axes on one
    dim shards it over each of them; DTensor splits mesh dims left to
    right, JAX a tuple major to minor, so the tuple must follow the
    mesh's order (every recipe's does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} out of the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def spec_of(placements: Sequence, mesh) -> Tuple:
    """The inverse of ``placements_of``: placements -> the spec (tensor
    dim -> None / an axis / a tuple of axes in mesh order), trailing
    replicated dims dropped."""
    names = axis_names(mesh)
    dims: Dict[int, List[str]] = {}
    for name, pl in zip(names, placements):
        if pl.is_shard():
            dims.setdefault(pl.dim, []).append(name)
    n = max(dims, default=-1) + 1
    return tuple(None if d not in dims else
                 dims[d][0] if len(dims[d]) == 1 else tuple(dims[d])
                 for d in range(n))


def _walk(tree, one, prefix=""):
    """``tree`` with each leaf replaced by ``one(path, leaf)``; a flat
    parameter dict's dotted names are read as paths."""
    if isinstance(tree, dict):
        return {k: _walk(v, one, f"{prefix}/{k}" if "." not in k
                         else _path(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, one, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return one(prefix, tree)


def param_shardings(mesh, params, cfg: ModelConfig,
                    recipe_name: str = "default"):
    """The recipe's placements of every parameter (a flat dict of dotted
    paths, or a nested tree). Dims that do not divide their mesh axis
    fall back to replicated on that dim (e.g. SeamlessM4T's vocab
    256,206 on a 16-way axis)."""
    dp, mp = RECIPES[recipe_name]
    recipe = _recipe(dp, mp)

    def one(path, leaf):
        n_lead = 1 if "/units/" in path or path.endswith("units") or \
            re.search(r"/(units|enc|dec)/", path) else 0
        spec = _leaf_spec(path, leaf.shape, recipe, n_lead)
        spec = spec + (None,) * (len(leaf.shape) - len(spec))
        return placements_of(tuple(a if _divisible(dim, mesh, a) else None
                                   for dim, a in zip(leaf.shape, spec)),
                             mesh)

    return _walk(params, one)


def batch_shardings(mesh, batch_tree, shape: InputShape):
    """tokens / targets / embeds: batch over (pod, data) when it divides,
    else over data, else replicated (batch 1)."""
    bx = batch_axes(mesh)
    b = shape.global_batch
    ax = bx if _divisible(b, mesh, tuple(bx)) else (
        ("data",) if _divisible(b, mesh, "data") else None)
    return _walk(batch_tree, lambda path, leaf: placements_of(
        (ax,) + (None,) * (len(leaf.shape) - 1), mesh))


def cache_shardings(mesh, cache_tree, cfg: ModelConfig, shape: InputShape):
    """KV caches: batch over (pod, data) when it divides; otherwise
    (long_500k, batch 1) the sequence / buffer dim over data. Head dims
    over model when they divide it, else (GQA's 8 KV heads on a 16-way
    axis) the sequence over model; recurrent states shard features over
    model. The reference's ``cache_shardings``."""
    bx = batch_axes(mesh)
    b = shape.global_batch
    batch_ok = _divisible(b, mesh, tuple(bx))
    data_ok = _divisible(b, mesh, "data")
    b_ax = tuple(bx) if batch_ok else ("data" if data_ok else None)
    n_data, n_model = axis_size(mesh, "data"), axis_size(mesh, "model")

    def one(path, leaf):
        n_lead = 1 if (re.search(r"/(units|self)/", path) or "/units" in path
                       or re.search(r"/cross_[kv]", path)) else 0
        dims = tuple(leaf.shape[n_lead:])
        spec = [None] * n_lead
        if len(dims) == 0:          # index scalar
            return placements_of(spec, mesh)
        rest = [None] * len(dims)
        rest[0] = b_ax
        # (B, S, KVH, D) / (B, S, R): pick seq or head sharding
        if len(dims) >= 2 and b_ax is None and dims[1] % n_data == 0 \
                and dims[1] > 1024:
            rest[1] = "data"        # sequence-sharded cache (batch=1)
        if len(dims) == 4 and _divisible(dims[2], mesh, "model"):
            rest[2] = "model"       # kv heads cover the model axis
        elif (len(dims) >= 3 and rest[1] is None and dims[1] >= 4096
                and dims[1] % n_model == 0):
            rest[1] = "model"       # the sequence over model instead
        # recurrent states (B, H, Dk, Dv) / (B, D): features on model
        if re.search(r"/(C|n|h|c|m)$", path):
            rest = [None] * len(dims)
            rest[0] = b_ax
            for i in range(len(dims) - 1, 0, -1):
                if dims[i] % n_model == 0 and dims[i] >= 16:
                    rest[i] = "model"
                    break
        return placements_of(spec + rest, mesh)

    return _walk(cache_tree, one)


def replicated(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in axis_names(mesh))


def distribute(tree, placements, mesh):
    """A tree of tensors -> DTensors, each split by its placements (the
    tree ``param_shardings`` / ``batch_shardings`` / ``cache_shardings``
    gave for it). A tensor on the mesh's device is split as it is (every
    rank holds the global tensor: the tests, which seed it equally on
    every rank); a ``meta`` or fake tensor takes its local shard's shape
    without data (``DTensor.from_local`` of an empty shard)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, placements[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, p, mesh) for v, p in zip(tree, placements)]
    if isinstance(tree, DTensor) or not isinstance(tree, torch.Tensor):
        return tree
    if tree.device.type == "meta":
        local = local_shape(tree.shape, placements, mesh)
        return DTensor.from_local(
            torch.empty(local, dtype=tree.dtype, device=mesh.device_type),
            mesh, placements, run_check=False, shape=tree.shape,
            stride=torch.empty(tree.shape, device="meta").stride())
    return distribute_tensor(tree, mesh, placements)


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of ``shape`` under ``placements``
    (every split divides: the recipe replicates a dim that does not)."""
    out = list(shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            out[pl.dim] //= mesh.shape[i]
    return tuple(out)
