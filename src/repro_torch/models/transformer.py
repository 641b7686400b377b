"""Decoder stack in the reference's layout, ``prefix | stacked units |
suffix``: block specs, full-sequence forward (train, eval, prefill) and
one-token decode.

The reference stacks each repeating unit's parameters along a leading
``n_units`` axis and drives it with ``jax.lax.scan``. The port keeps that
parameter layout (AdamW's ``ndim >= 2`` decay rule and the per-unit
freezing mask both read it) and loops over the axis in Python. A unit is
the lcm of the attention pattern and the block pattern: the char-LM's is
one global attention block, Gemma2's a local block ``b0`` and a global
block ``b1`` (42 layers = 21 units), RecurrentGemma's (rec, rec, attn),
xLSTM's seven mLSTM blocks and one sLSTM block. The prefix is a list of
leading blocks that differ from the unit: DeepSeek-V3's dense layers
before its MoE layers (``moe.first_dense_layers``, with
``moe.d_ff_dense`` as their MLP width). The suffix is the list of
layers left when the unit does not divide the depth: RecurrentGemma-2B's
26 layers are 8 units and a (rec, rec) suffix. The decode caches keep
the same layout: ``{"prefix": [...], "suffix": [...], "units": {"b0":
{"k", "v": (n_units, B, S_buf, KVH, D), "index": (n_units,)}, ...}}``,
with ``c_kv`` and ``k_rope`` in place of ``k`` and ``v`` under MLA, and
a recurrent block's state in place of an attention cache: {conv, h}
(RG-LRU), {conv, C, n, m} (mLSTM), {h, c, n, m} (sLSTM).

An attention block is attention (GQA or MLA) followed by a dense MLP or
an MoE layer; its aux loss (MoE's load balance, else 0) is summed over
the stack in the reference's order. Under a mesh every residual sum is
put back in the batch layout (``layers.shard_batch``): DTensor places
each op by itself, where GSPMD propagates one layout through the step. A ``rec`` block is the RG-LRU
followed by the MLP (``ln2`` + ``ffn``); an ``mlstm`` or ``slstm``
block is its cell alone, with its own projections.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rg
from repro_torch.models import ssm


class BlockSpec(NamedTuple):
    kind: str                  # attn | rec | mlstm | slstm
    window: Optional[int]      # attention window (None = global)
    use_moe: bool


def block_spec(cfg: ModelConfig, i: int) -> BlockSpec:
    kind = cfg.layer_kind(i)
    if kind not in ("attn", "rec", "mlstm", "slstm"):
        raise ValueError(f"unknown block kind {kind!r}")
    window = None
    if kind == "attn" and cfg.attn_type(i) == "local":
        window = cfg.window
    use_moe = (cfg.moe is not None and kind == "attn"
               and i >= cfg.moe.first_dense_layers)
    return BlockSpec(kind, window, use_moe)


def stack_plan(cfg: ModelConfig):
    """-> (prefix_specs, unit_specs, n_units, suffix_specs). The prefix is
    MoE's dense lead-in; the unit is the lcm of the block and attention
    patterns, and every unit has the same specs; the suffix is the
    remainder."""
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


# ---------------------------------------------------------------------------
# single block
# ---------------------------------------------------------------------------


def block_init(gen, cfg: ModelConfig, spec: BlockSpec, device):
    p = {"ln1": L.norm_init(cfg, device)}
    if spec.kind == "rec":
        p["rec"] = rg.rglru_init(gen, cfg, device)
        p["ln2"] = L.norm_init(cfg, device)
        p["ffn"] = L.mlp_init(gen, cfg, device)
        return p
    if spec.kind == "mlstm":
        p["mlstm"] = ssm.mlstm_init(gen, cfg, device)
        return p
    if spec.kind == "slstm":
        p["slstm"] = ssm.slstm_init(gen, cfg, device)
        return p
    p["attn"] = (L.mla_init if cfg.mla else L.attn_init)(gen, cfg, device)
    p["ln2"] = L.norm_init(cfg, device)
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


def _recurrent_full(p, x, cfg: ModelConfig, spec: BlockSpec):
    """A rec / mlstm / slstm block over the full sequence -> (x, its
    decode-ready state)."""
    h = L.norm_apply(p["ln1"], x)
    if spec.kind == "rec":
        a, state = rg.rglru_apply_full(p["rec"], h, cfg)
        x = L.shard_batch(x + a)
        f, _ = _ffn(p, L.norm_apply(p["ln2"], x), cfg, spec)
        return L.shard_batch(x + f), state
    if spec.kind == "mlstm":
        a, state = ssm.mlstm_apply_full(p["mlstm"], h, cfg)
        return L.shard_batch(x + a), state
    a, st = ssm.slstm_apply_full(p["slstm"], h, cfg)
    return L.shard_batch(x + a), dict(zip("hcnm", st))


def block_apply_full(p, x, positions, cfg: ModelConfig, spec: BlockSpec,
                     s_buf: Optional[int] = None):
    """One block over the full sequence -> (x, decode cache or None
    without ``s_buf``, aux loss). An attention block is pre-norm
    attention (with Gemma2's post-norms when the config has them) and
    its MLP / MoE; its cache has ``s_buf`` slots from this block's
    post-RoPE k and v (MLA: its latents). A recurrent block's cache is
    its final state, already decode-ready."""
    if spec.kind != "attn":
        x, state = _recurrent_full(p, x, cfg, spec)
        return x, (state if s_buf is not None else None), 0.0
    h = L.norm_apply(p["ln1"], x)
    if cfg.mla:
        a, kv = L.mla_apply_full(p["attn"], h, positions, cfg)
    else:
        a, kv = L.attn_apply_full(p["attn"], h, positions, cfg,
                                  window=spec.window)
    if cfg.post_norms:
        a = L.norm_apply(p["post1"], a)
    x = L.shard_batch(x + a)
    f, aux = _ffn(p, L.norm_apply(p["ln2"], x), cfg, spec)
    if cfg.post_norms:
        f = L.norm_apply(p["post2"], f)
    cache = None
    if s_buf is not None:
        cache = (L.mla_cache_from_full if cfg.mla
                 else L.attn_cache_from_full)(*kv, s_buf)
    return L.shard_batch(x + f), cache, aux


def block_apply_decode(p, x, cache, cfg: ModelConfig, spec: BlockSpec):
    """One token through one block; ``cache`` is updated in place."""
    h = L.norm_apply(p["ln1"], x)
    if spec.kind == "rec":
        a, cache = rg.rglru_apply_decode(p["rec"], h, cache, cfg)
        x = L.shard_batch(x + a)
        f, _ = _ffn(p, L.norm_apply(p["ln2"], x), cfg, spec)
        return L.shard_batch(x + f), cache
    if spec.kind == "mlstm":
        a, cache = ssm.mlstm_apply_decode(p["mlstm"], h, cache, cfg)
        return L.shard_batch(x + a), cache
    if spec.kind == "slstm":
        a, cache = ssm.slstm_apply_decode(p["slstm"], h, cache, cfg)
        return L.shard_batch(x + a), cache
    if cfg.mla:
        a, cache = L.mla_apply_decode(p["attn"], h, cache, cfg)
    else:
        a, cache = L.attn_apply_decode(p["attn"], h, cache, cfg,
                                       window=spec.window)
    if cfg.post_norms:
        a = L.norm_apply(p["post1"], a)
    x = L.shard_batch(x + a)
    f, _ = _ffn(p, L.norm_apply(p["ln2"], x), cfg, spec)
    if cfg.post_norms:
        f = L.norm_apply(p["post2"], f)
    return L.shard_batch(x + f), cache


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
    if spec.kind == "rec":
        return rg.rglru_cache_init(cfg, batch, device)
    if spec.kind == "mlstm":
        return ssm.mlstm_cache_init(cfg, batch, device)
    if spec.kind == "slstm":
        return ssm.slstm_cache_init(cfg, batch, device)
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
        if isinstance(t, DTensor):       # a mesh's cache: split as t is
            local = t.to_local()
            return DTensor.from_local(
                local.new_empty((n_units,) + tuple(local.shape)),
                t.device_mesh, [Shard(p.dim + 1) if p.is_shard() else p
                                for p in t.placements], run_check=False)
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
    prefix, unit, n_units, suffix = stack_plan(cfg)
    params = {}
    if prefix:
        params["prefix"] = [block_init(gen, cfg, spec, device)
                            for spec in prefix]
    if n_units:
        params["units"] = _stack_units(
            lambda u: {f"b{j}": block_init(gen, cfg, spec, device)
                       for j, spec in enumerate(unit)}, n_units)
    if suffix:
        params["suffix"] = [block_init(gen, cfg, spec, device)
                            for spec in suffix]
    return params


def stack_apply_full(params, x, positions, cfg: ModelConfig,
                     cache_len: Optional[int] = None,
                     use_decode_window: bool = False, remat: bool = False):
    """The prefix blocks, a loop over the stacked ``units`` axis, then the
    suffix blocks -> (x, caches or None, aux loss summed over the stack
    in that order). With ``cache_len`` (prefill), each attention block's
    k and v (MLA: its latents) become its rolling decode cache of
    ``cache_len`` slots (a local layer: its window; a global layer under
    ``use_decode_window``: the decode window), and each recurrent block
    keeps its final state; the units' caches are stacked like the
    parameters as the units run. Under ``remat`` (a gradient, no caches)
    each unit is recomputed in the backward pass instead of keeping its
    activations, as the reference's ``jax.checkpoint`` of the scan body
    does; the prefix and suffix blocks keep theirs, as there. The
    recompute runs with the gradient on (``use_reentrant=False``), so it
    takes the same attention route as the forward."""
    prefix, unit, n_units, suffix = stack_plan(cfg)
    aux_total = 0.0

    def buf(spec):
        return (None if cache_len is None else
                _buf_len(cfg, spec, cache_len, use_decode_window))

    def run_list(name, specs):
        nonlocal x, aux_total
        caches = []
        for p, spec in zip(params.get(name, []), specs):
            x, cache, aux = block_apply_full(p, x, positions, cfg, spec,
                                             buf(spec))
            caches.append(cache)
            aux_total = aux_total + aux
        return caches

    def run(u):
        nonlocal x, aux_total
        unit_params = _unit_slice(params["units"], u)
        caches = {}
        for j, spec in enumerate(unit):
            x, caches[f"b{j}"], aux = block_apply_full(
                unit_params[f"b{j}"], x, positions, cfg, spec, buf(spec))
            aux_total = aux_total + aux
        return caches

    def unit_body(u, h, aux_acc):
        unit_params = _unit_slice(params["units"], u)
        for j, spec in enumerate(unit):
            h, _, aux = block_apply_full(unit_params[f"b{j}"], h, positions,
                                         cfg, spec)
            aux_acc = aux_acc + aux
        return h, aux_acc

    caches = {"prefix": run_list("prefix", prefix)}
    if cache_len is None:
        for u in range(n_units):
            x, aux_total = (checkpoint(unit_body, u, x, aux_total,
                                       use_reentrant=False)
                            if remat else unit_body(u, x, aux_total))
    elif n_units:
        caches["units"] = _stack_units(run, n_units)
    caches["suffix"] = run_list("suffix", suffix)
    return x, (None if cache_len is None else caches), aux_total


def stack_apply_decode(params, x, caches, cfg: ModelConfig):
    """One token through the prefix, every unit and the suffix; the
    caches are updated in place and returned."""
    prefix, unit, n_units, suffix = stack_plan(cfg)
    for p, spec, cache in zip(params.get("prefix", []), prefix,
                              caches["prefix"]):
        x, _ = block_apply_decode(p, x, cache, cfg, spec)
    for u in range(n_units):
        unit_params = _unit_slice(params["units"], u)
        unit_caches = _unit_slice(caches["units"], u)
        for j, spec in enumerate(unit):
            x, _ = block_apply_decode(unit_params[f"b{j}"], x,
                                      unit_caches[f"b{j}"], cfg, spec)
    for p, spec, cache in zip(params.get("suffix", []), suffix,
                              caches["suffix"]):
        x, _ = block_apply_decode(p, x, cache, cfg, spec)
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, ctx_len: int,
                     use_decode_window: bool = False, device=None):
    prefix, unit, n_units, suffix = stack_plan(cfg)

    def init(spec):
        return block_cache_init(cfg, spec, batch, ctx_len, use_decode_window,
                                device)

    caches = {"prefix": [init(spec) for spec in prefix],
              "suffix": [init(spec) for spec in suffix]}
    if n_units:
        caches["units"] = _stack_units(
            lambda u: {f"b{j}": init(spec) for j, spec in enumerate(unit)},
            n_units)
    return caches
