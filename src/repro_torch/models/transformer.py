"""Decoder stack in the reference's stacked-units layout: block specs,
full-sequence forward (train, eval, prefill) and one-token decode.

The reference stacks each repeating unit's parameters along a leading
``n_units`` axis and drives it with ``jax.lax.scan``. The port keeps that
parameter layout (AdamW's ``ndim >= 2`` decay rule and the per-unit
freezing mask both read it) and loops over the axis in Python. A unit is
the lcm of the attention pattern and the block pattern: the char-LM's is
one global attention block, Gemma2's a local block ``b0`` and a global
block ``b1`` (42 layers = 21 units). The decode caches keep the same
layout: ``{"prefix": [], "suffix": [], "units": {"b0": {"k", "v":
(n_units, B, S_buf, KVH, D), "index": (n_units,)}, ...}}``.

Only attention blocks are ported; the recurrent, mLSTM and sLSTM kinds,
MoE, MLA and prefix/suffix layers raise ``NotImplementedError`` (ROADMAP
queue 1 item 11).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 11)"


class BlockSpec(NamedTuple):
    kind: str                  # attn (rec | mlstm | slstm: not ported)
    window: Optional[int]      # attention window (None = global)


def block_spec(cfg: ModelConfig, i: int) -> BlockSpec:
    kind = cfg.layer_kind(i)
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} {_NOT_PORTED}")
    window = cfg.window if cfg.attn_type(i) == "local" else None
    return BlockSpec(kind, window)


def stack_plan(cfg: ModelConfig):
    """-> (prefix_specs, unit_specs, n_units, suffix_specs). The unit is
    the lcm of the block and attention patterns; the port has no prefix
    layers (MoE's dense lead-in)."""
    pat = len(cfg.block_pattern) if cfg.block_pattern else 1
    pat = pat * len(cfg.attn_pattern) // math.gcd(pat, len(cfg.attn_pattern))
    n_units, n_suffix = divmod(cfg.num_layers, pat)
    specs = [block_spec(cfg, i) for i in range(cfg.num_layers)]
    suffix = specs[cfg.num_layers - n_suffix:] if n_suffix else []
    return [], specs[:pat], n_units, suffix


def _check_plan(cfg: ModelConfig):
    prefix, unit, n_units, suffix = stack_plan(cfg)
    if suffix:
        raise NotImplementedError(f"suffix layers ({cfg.num_layers} layers "
                                  f"over a unit of {len(unit)}) {_NOT_PORTED}")
    return unit, n_units


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ModelConfig, device):
    p = {"ln1": L.norm_init(cfg, device),
         "attn": L.attn_init(gen, cfg, device),
         "ln2": L.norm_init(cfg, device),
         "ffn": L.mlp_init(gen, cfg, device)}
    if cfg.post_norms:
        p["post1"] = L.norm_init(cfg, device)
        p["post2"] = L.norm_init(cfg, device)
    return p


def block_apply_full(p, x, positions, cfg: ModelConfig, spec: BlockSpec,
                     s_buf: Optional[int] = None):
    """Pre-norm attention block (with Gemma2's post-norms when the config
    has them) -> (x, decode cache of ``s_buf`` slots from this block's
    post-RoPE k and v, or None without ``s_buf``); its aux loss is 0."""
    a, (k, v) = L.attn_apply_full(p["attn"], L.norm_apply(p["ln1"], x),
                                  positions, cfg, window=spec.window)
    if cfg.post_norms:
        a = L.norm_apply(p["post1"], a)
    x = x + a
    f = L.mlp_apply(p["ffn"], L.norm_apply(p["ln2"], x))
    if cfg.post_norms:
        f = L.norm_apply(p["post2"], f)
    cache = None if s_buf is None else L.attn_cache_from_full(k, v, s_buf)
    return x + f, cache


def block_apply_decode(p, x, cache, cfg: ModelConfig, spec: BlockSpec):
    """One token through one block; ``cache`` is updated in place."""
    a, cache = L.attn_apply_decode(p["attn"], L.norm_apply(p["ln1"], x),
                                   cache, cfg, window=spec.window)
    if cfg.post_norms:
        a = L.norm_apply(p["post1"], a)
    x = x + a
    f = L.mlp_apply(p["ffn"], L.norm_apply(p["ln2"], x))
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
    return L.attn_cache_init(cfg, batch, _buf_len(cfg, spec, ctx_len,
                                                  use_decode_window), device)


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
    preallocated tensors (peak memory: the stack plus one unit)."""
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
    out = tree_map(alloc, first)
    put(out, first, 0)
    del first
    for u in range(1, n_units):
        put(out, make(u), u)
    return out


def stack_init(gen, cfg: ModelConfig, device):
    unit, n_units = _check_plan(cfg)
    return {"units": _stack_units(
        lambda u: {f"b{j}": block_init(gen, cfg, device)
                   for j in range(len(unit))}, n_units)}


def stack_apply_full(params, x, positions, cfg: ModelConfig,
                     cache_len: Optional[int] = None,
                     use_decode_window: bool = False):
    """Loops over the stacked ``units`` axis -> (x, caches or None). With
    ``cache_len`` (prefill), each attention block's k and v become its
    rolling decode cache of ``cache_len`` slots (a local layer: its
    window; a global layer under ``use_decode_window``: the decode
    window), stacked per unit like the parameters as the units run."""
    unit, n_units = _check_plan(cfg)

    def run(u):
        nonlocal x
        unit_params = _unit_slice(params["units"], u)
        caches = {}
        for j, spec in enumerate(unit):
            s_buf = (None if cache_len is None else
                     _buf_len(cfg, spec, cache_len, use_decode_window))
            x, caches[f"b{j}"] = block_apply_full(
                unit_params[f"b{j}"], x, positions, cfg, spec, s_buf)
        return caches

    if cache_len is None:
        for u in range(n_units):
            run(u)
        return x, None
    units = _stack_units(run, n_units)
    return x, {"prefix": [], "units": units, "suffix": []}


def stack_apply_decode(params, x, caches, cfg: ModelConfig):
    """One token through every unit; the caches are updated in place and
    returned."""
    unit, n_units = _check_plan(cfg)
    for u in range(n_units):
        unit_params = _unit_slice(params["units"], u)
        unit_caches = _unit_slice(caches["units"], u)
        for j, spec in enumerate(unit):
            x, _ = block_apply_decode(unit_params[f"b{j}"], x,
                                      unit_caches[f"b{j}"], cfg, spec)
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, ctx_len: int,
                     use_decode_window: bool = False, device=None):
    unit, n_units = _check_plan(cfg)
    return {"prefix": [], "suffix": [], "units": _stack_units(
        lambda u: {f"b{j}": block_cache_init(cfg, spec, batch, ctx_len,
                                             use_decode_window, device)
                   for j, spec in enumerate(unit)}, n_units)}
