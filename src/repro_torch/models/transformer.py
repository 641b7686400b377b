"""Decoder stack in the reference's layout, ``prefix | stacked units |
suffix``: block specs, full-sequence forward (train, eval, prefill) and
one-token decode.

The reference stacks each repeating unit's parameters along a leading
``n_units`` axis and drives it with ``jax.lax.scan``. The port keeps that
parameter layout (AdamW's ``ndim >= 2`` decay rule and the per-unit
freezing mask both read it) and loops over the axis in Python. A unit is
the lcm of the attention pattern and the block pattern: the char-LM's is
one global attention block, Gemma2's a local block ``b0`` and a global
block ``b1`` (42 layers = 21 units). The prefix is a list of leading
blocks that differ from the unit: DeepSeek-V3's dense layers before its
MoE layers (``moe.first_dense_layers``, with ``moe.d_ff_dense`` as their
MLP width). The decode caches keep the same layout: ``{"prefix": [...],
"suffix": [], "units": {"b0": {"k", "v": (n_units, B, S_buf, KVH, D),
"index": (n_units,)}, ...}}``, with ``c_kv`` and ``k_rope`` in place of
``k`` and ``v`` under MLA.

A block is attention (GQA or MLA) followed by a dense MLP or an MoE
layer; its aux loss (MoE's load balance, else 0) is summed over the
stack in the reference's order. The recurrent, mLSTM and sLSTM kinds and
suffix layers raise ``NotImplementedError`` (ROADMAP queue 1 item 11b).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 11b)"


class BlockSpec(NamedTuple):
    kind: str                  # attn (rec | mlstm | slstm: not ported)
    window: Optional[int]      # attention window (None = global)
    use_moe: bool


def block_spec(cfg: ModelConfig, i: int) -> BlockSpec:
    kind = cfg.layer_kind(i)
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} {_NOT_PORTED}")
    window = cfg.window if cfg.attn_type(i) == "local" else None
    use_moe = cfg.moe is not None and i >= cfg.moe.first_dense_layers
    return BlockSpec(kind, window, use_moe)


def stack_plan(cfg: ModelConfig):
    """-> (prefix_specs, unit_specs, n_units, suffix_specs). The prefix is
    MoE's dense lead-in; the unit is the lcm of the block and attention
    patterns, and every unit has the same specs."""
    n_prefix = cfg.moe.first_dense_layers if cfg.moe else 0
    pat = len(cfg.block_pattern) if cfg.block_pattern else 1
    pat = pat * len(cfg.attn_pattern) // math.gcd(pat, len(cfg.attn_pattern))
    n_units, n_suffix = divmod(cfg.num_layers - n_prefix, pat)
    specs = [block_spec(cfg, i) for i in range(cfg.num_layers)]
    unit = specs[n_prefix:n_prefix + pat]
    for u in range(n_units):
        got = specs[n_prefix + u * pat:n_prefix + (u + 1) * pat]
        assert got == unit, f"non-uniform unit {u}: {got} != {unit}"
    suffix = specs[cfg.num_layers - n_suffix:] if n_suffix else []
    return specs[:n_prefix], unit, n_units, suffix


def _check_plan(cfg: ModelConfig):
    prefix, unit, n_units, suffix = stack_plan(cfg)
    if suffix:
        raise NotImplementedError(f"suffix layers ({cfg.num_layers} layers "
                                  f"over a unit of {len(unit)}) {_NOT_PORTED}")
    return prefix, unit, n_units


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ModelConfig, spec: BlockSpec, device):
    p = {"ln1": L.norm_init(cfg, device),
         "attn": (L.mla_init if cfg.mla else L.attn_init)(gen, cfg, device),
         "ln2": L.norm_init(cfg, device)}
    if spec.use_moe:
        p["ffn"] = moe_lib.moe_init(gen, cfg, device)
    else:
        d_ff = cfg.d_ff
        if cfg.moe and cfg.moe.first_dense_layers and cfg.moe.d_ff_dense:
            d_ff = cfg.moe.d_ff_dense
        p["ffn"] = L.mlp_init(gen, cfg, device, d_ff=d_ff)
    if cfg.post_norms:
        p["post1"] = L.norm_init(cfg, device)
        p["post2"] = L.norm_init(cfg, device)
    return p


def _ffn(p, x, cfg: ModelConfig, spec: BlockSpec):
    """-> (the MLP or MoE output, its aux loss: 0.0 for a dense MLP)."""
    if spec.use_moe:
        return moe_lib.moe_apply(p["ffn"], x, cfg)
    return L.mlp_apply(p["ffn"], x, cfg), 0.0


def block_apply_full(p, x, positions, cfg: ModelConfig, spec: BlockSpec,
                     s_buf: Optional[int] = None):
    """Pre-norm attention block (with Gemma2's post-norms when the config
    has them) -> (x, decode cache of ``s_buf`` slots from this block's
    post-RoPE k and v (MLA: its latents), or None without ``s_buf``, aux
    loss)."""
    h = L.norm_apply(p["ln1"], x)
    if cfg.mla:
        a, kv = L.mla_apply_full(p["attn"], h, positions, cfg)
    else:
        a, kv = L.attn_apply_full(p["attn"], h, positions, cfg,
                                  window=spec.window)
    if cfg.post_norms:
        a = L.norm_apply(p["post1"], a)
    x = x + a
    f, aux = _ffn(p, L.norm_apply(p["ln2"], x), cfg, spec)
    if cfg.post_norms:
        f = L.norm_apply(p["post2"], f)
    cache = None
    if s_buf is not None:
        cache = (L.mla_cache_from_full if cfg.mla
                 else L.attn_cache_from_full)(*kv, s_buf)
    return x + f, cache, aux


def block_apply_decode(p, x, cache, cfg: ModelConfig, spec: BlockSpec):
    """One token through one block; ``cache`` is updated in place."""
    h = L.norm_apply(p["ln1"], x)
    if cfg.mla:
        a, cache = L.mla_apply_decode(p["attn"], h, cache, cfg)
    else:
        a, cache = L.attn_apply_decode(p["attn"], h, cache, cfg,
                                       window=spec.window)
    if cfg.post_norms:
        a = L.norm_apply(p["post1"], a)
    x = x + a
    f, _ = _ffn(p, L.norm_apply(p["ln2"], x), cfg, spec)
    if cfg.post_norms:
        f = L.norm_apply(p["post2"], f)
    return x + f, cache


def _buf_len(cfg: ModelConfig, spec: BlockSpec, ctx_len: int,
             use_decode_window: bool) -> int:
    s_buf = ctx_len
    if spec.window is not None:
        s_buf = min(s_buf, spec.window)
    elif use_decode_window and cfg.decode_window:
        s_buf = min(s_buf, cfg.decode_window)
    return s_buf


def block_cache_init(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     ctx_len: int, use_decode_window: bool, device):
    s_buf = _buf_len(cfg, spec, ctx_len, use_decode_window)
    if cfg.mla:
        return L.mla_cache_init(cfg, batch, s_buf, device)
    return L.attn_cache_init(cfg, batch, s_buf, device)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def _unit_slice(tree, u: int):
    if isinstance(tree, dict):
        return {k: _unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def _stack_units(make, n_units: int):
    """Stack ``n_units`` trees from ``make(u)``, called for u = 0, 1, ...
    in order, along a new leading axis, one unit at a time into
    preallocated tensors (peak memory: the stack plus one unit; one unit
    is viewed with a new axis, not copied)."""
    def alloc(t):
        return t.new_empty((n_units,) + tuple(t.shape))

    def put(dst, src, u):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], u)
        else:
            dst[u].copy_(src)

    def tree_map(fn, tree):
        if isinstance(tree, dict):
            return {k: tree_map(fn, v) for k, v in tree.items()}
        return fn(tree)

    first = make(0)
    if n_units == 1:
        return tree_map(lambda t: t.unsqueeze(0), first)
    out = tree_map(alloc, first)
    put(out, first, 0)
    del first
    for u in range(1, n_units):
        put(out, make(u), u)
    return out


def stack_init(gen, cfg: ModelConfig, device):
    prefix, unit, n_units = _check_plan(cfg)
    params = {}
    if prefix:
        params["prefix"] = [block_init(gen, cfg, spec, device)
                            for spec in prefix]
    if n_units:
        params["units"] = _stack_units(
            lambda u: {f"b{j}": block_init(gen, cfg, spec, device)
                       for j, spec in enumerate(unit)}, n_units)
    return params


def stack_apply_full(params, x, positions, cfg: ModelConfig,
                     cache_len: Optional[int] = None,
                     use_decode_window: bool = False):
    """The prefix blocks, then a loop over the stacked ``units`` axis ->
    (x, caches or None, aux loss summed over the stack). With
    ``cache_len`` (prefill), each attention block's k and v (MLA: its
    latents) become its rolling decode cache of ``cache_len`` slots (a
    local layer: its window; a global layer under ``use_decode_window``:
    the decode window), stacked per unit like the parameters as the
    units run."""
    prefix, unit, n_units = _check_plan(cfg)
    aux_total = 0.0

    def buf(spec):
        return (None if cache_len is None else
                _buf_len(cfg, spec, cache_len, use_decode_window))

    prefix_caches = []
    for p, spec in zip(params.get("prefix", []), prefix):
        x, cache, aux = block_apply_full(p, x, positions, cfg, spec,
                                         buf(spec))
        prefix_caches.append(cache)
        aux_total = aux_total + aux

    def run(u):
        nonlocal x, aux_total
        unit_params = _unit_slice(params["units"], u)
        caches = {}
        for j, spec in enumerate(unit):
            x, caches[f"b{j}"], aux = block_apply_full(
                unit_params[f"b{j}"], x, positions, cfg, spec, buf(spec))
            aux_total = aux_total + aux
        return caches

    if cache_len is None:
        for u in range(n_units):
            run(u)
        return x, None, aux_total
    caches = {"prefix": prefix_caches, "suffix": []}
    if n_units:
        caches["units"] = _stack_units(run, n_units)
    return x, caches, aux_total


def stack_apply_decode(params, x, caches, cfg: ModelConfig):
    """One token through the prefix and every unit; the caches are
    updated in place and returned."""
    prefix, unit, n_units = _check_plan(cfg)
    for p, spec, cache in zip(params.get("prefix", []), prefix,
                              caches["prefix"]):
        x, _ = block_apply_decode(p, x, cache, cfg, spec)
    for u in range(n_units):
        unit_params = _unit_slice(params["units"], u)
        unit_caches = _unit_slice(caches["units"], u)
        for j, spec in enumerate(unit):
            x, _ = block_apply_decode(unit_params[f"b{j}"], x,
                                      unit_caches[f"b{j}"], cfg, spec)
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, ctx_len: int,
                     use_decode_window: bool = False, device=None):
    prefix, unit, n_units = _check_plan(cfg)

    def init(spec):
        return block_cache_init(cfg, spec, batch, ctx_len, use_decode_window,
                                device)

    caches = {"prefix": [init(spec) for spec in prefix], "suffix": []}
    if n_units:
        caches["units"] = _stack_units(
            lambda u: {f"b{j}": init(spec) for j, spec in enumerate(unit)},
            n_units)
    return caches
