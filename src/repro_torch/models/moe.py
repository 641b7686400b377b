"""Mixture-of-Experts layer (GShard / Switch-style dispatch), as
``repro.models.moe``.

Tokens are padded to whole groups of ``group_size``; each group routes
its tokens to the top-k experts of a softmax over the router's logits
(ties: lowest expert first, as ``jax.lax.top_k``), and each expert takes
at most ``capacity`` of a group's (token, k) pairs, first come first
served in token-major order; the rest are dropped. The experts run as
batched einsums over the expert axis on a per-group capacity buffer; the
shared expert, when the config has one, sees every token. The aux loss
is Switch's load balance over each group's first choices.

The combine tensor (G, S, E, C) is built by a scatter of each kept
pair's gate into its (expert, slot) cell, not by the reference's einsum
of the one-hots (G, S, K, E) x (G, S, K, E, C). A token's k experts are
distinct, so each cell of that einsum's sum over k holds at most one
nonzero term: the scatter gives the same values without the (G, S, K,
E, C) tensor (4.3 GB in bf16 at DeepSeek-V3's 1,024-token group and a
capacity of the group size).

The reference adds router noise only when its ``moe_apply`` is given an
rng, which its decoder stack never passes; the port's ``moe_apply`` has
no rng, so ``router_noise`` has no effect in either package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _experts(gen, shape, scale: float, dtype, device):
    """Normal x ``scale`` weights of shape (E, ...), drawn one expert at a
    time so that no f32 transient holds every expert at once."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type != "meta":
        for e in range(shape[0]):
            out[e] = L._normal(gen, shape[1:], device) * scale
    return out


def moe_init(gen, cfg: ModelConfig, device):
    m = cfg.moe
    e, dm, dff, dt = m.num_experts, cfg.d_model, m.d_ff_expert, cfg.param_dtype
    scale = 1.0 / math.sqrt(dm)
    p = {
        # the router stays f32 in every dtype; its matmul runs in the
        # activations' dtype
        "router": L.dense_init(gen, dm, e, torch.float32, device, scale=scale),
        "expert_gate": _experts(gen, (e, dm, dff), scale, dt, device),
        "expert_up": _experts(gen, (e, dm, dff), scale, dt, device),
        "expert_down": _experts(gen, (e, dff, dm), 1.0 / math.sqrt(dff), dt,
                                device),
    }
    if m.num_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, device,
                                 d_ff=m.d_ff_dense or m.d_ff_expert)
    return p


def _capacity(m, tokens_per_group: int) -> int:
    c = int(math.ceil(tokens_per_group * m.top_k * m.capacity_factor
                      / m.num_experts))
    return max(4, c)


def top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, descending,
    equal values lowest index first (``torch.topk`` promises no order
    among ties) -> (values, indices)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


class Routing(NamedTuple):
    xg: torch.Tensor        # (G, gs, D) the padded, grouped tokens
    probs: torch.Tensor     # (G, gs, E) f32 router softmax
    gate: torch.Tensor      # (G, gs, K) f32 gates, renormalised over k
    expert: torch.Tensor    # (G, gs, K) expert of each choice
    pos: torch.Tensor       # (G, gs, K) slot in its expert's queue
    kept: torch.Tensor      # (G, gs, K) bool: pos < capacity
    capacity: int
    n_tok: int              # real tokens (the rest of the last group pads)


def route(p, x, cfg: ModelConfig) -> Routing:
    """x: (B, S, D) -> the routing of its tokens, group by group."""
    m = cfg.moe
    b, s, d = x.shape
    n_tok = b * s
    gs = min(m.group_size, n_tok)
    n_grp = -(-n_tok // gs)
    xf = x.reshape(n_tok, d)
    pad = n_grp * gs - n_tok
    if pad:
        xf = L.along_dim(F.pad, xf, 0, pad=(0, 0, 0, pad))
    xg = xf.reshape(n_grp, gs, d)

    logits = L.dense(xg, p["router"].to(xg.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, expert = top_k(probs, m.top_k)                          # (G,S,K)
    gate = gate / (torch.sum(gate, dim=-1, keepdim=True) + 1e-9)
    # each (token, k) pair's slot in its expert's queue: the count of
    # earlier pairs (token-major, k-minor) sent to that expert
    onehot = F.one_hot(expert, m.num_experts).to(torch.int32)     # (G,S,K,E)
    queue = onehot.reshape(n_grp, gs * m.top_k, -1).cumsum(1)
    pos = queue.reshape(onehot.shape).gather(-1, expert[..., None])[..., 0] - 1
    cap = _capacity(m, gs)
    return Routing(xg, probs, gate, expert, pos, pos < cap, cap, n_tok)


def _expert_ffn(dispatch, combine, xg, w_gate, w_up, w_down):
    """The experts' SwiGLU on their queues, combined back to the tokens:
    dispatch / combine (G,S,E,C), xg (G,S,D), weights (E,D,F) / (E,F,D)
    -> (G,S,D)."""
    xe = torch.einsum("gsec,gsd->egcd", dispatch, xg)             # (E,G,C,D)
    h = torch.einsum("egcd,edf->egcf", xe, w_gate)
    u = torch.einsum("egcd,edf->egcf", xe, w_up)
    ye = torch.einsum("egcf,efd->egcd", F.silu(h) * u, w_down)
    return torch.einsum("gsec,egcd->gsd", combine, ye)


def _expert_parallel(dispatch, combine, xg, w_gate, w_up, w_down):
    """``_expert_ffn``; under a mesh, expert parallel on each rank's
    share: the groups keep their batch split (the tokens replicated over
    the expert split), each rank runs its own experts on their queues
    (the weights gathered over any other split: FSDP), and the combine
    is a ``Partial`` sum over the expert split. Nothing moves the tokens
    (no all-to-all)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(w_gate, DTensor):
        return _expert_ffn(dispatch, combine, xg, w_gate, w_up, w_down)
    from torch.distributed.tensor.experimental import local_map
    mesh = w_gate.device_mesh
    rep = [Replicate()] * mesh.ndim
    dispatch, combine, xg = (t if isinstance(t, DTensor) else
                             DTensor.from_local(t, mesh, rep, run_check=False)
                             for t in (dispatch, combine, xg))
    ep = [i for i, pl in enumerate(w_gate.placements) if pl.is_shard(0)]
    tp = tuple(Replicate() if i in ep or not (pl.is_shard(0))
               else pl for i, pl in enumerate(xg.placements))
    wp = tuple(Shard(0) if i in ep else Replicate() for i in range(mesh.ndim))
    tg = tuple(Partial() if i in ep else pl for i, pl in enumerate(tp))
    wg = tuple(Shard(0) if i in ep else Partial() if tp[i].is_shard()
               else Replicate() for i in range(mesh.ndim))
    op = tuple(Partial() if i in ep else pl for i, pl in enumerate(tp))
    e_loc = w_gate.shape[0] // math.prod(mesh.shape[i] for i in ep)
    lo = L._shard_index(mesh, ep) * e_loc

    def local(d, c, x, wg_, wu_, wd_):
        cut = slice(lo, lo + e_loc)
        return _expert_ffn(d[:, :, cut], c[:, :, cut], x, wg_, wu_, wd_)

    args = [L.redistribute_at("experts", t, pl) for t, pl in
            ((dispatch, tp), (combine, tp), (xg, tp), (w_gate, wp),
             (w_up, wp), (w_down, wp))]
    return local_map(local, out_placements=list(op),
                     in_placements=(tp, tp, tp, wp, wp, wp),
                     in_grad_placements=(tg, tg, tg, wg, wg, wg),
                     device_mesh=mesh)(*args)


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D), aux loss (load balance, f32 scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    r = route(p, x, cfg)
    g, gs, _ = r.xg.shape
    e, cap, dt = m.num_experts, r.capacity, r.xg.dtype
    # combine (G,S,E,C): each kept pair's gate (in the activations' dtype)
    # at its (expert, slot); a dropped pair adds 0 at a clamped slot
    cell = r.expert * cap + r.pos.clamp(max=cap - 1)
    weight = r.gate.to(dt) * r.kept.to(dt)
    combine = torch.zeros((g, gs, e * cap), dtype=dt, device=x.device)
    combine = combine.scatter_add(2, cell, weight).reshape(g, gs, e, cap)
    dispatch = (combine > 0).to(dt)

    y = _expert_parallel(dispatch, combine, r.xg,
                         p["expert_gate"].to(dt), p["expert_up"].to(dt),
                         p["expert_down"].to(dt))                 # (G,S,D)

    y = y.reshape(g * gs, d)[:r.n_tok].reshape(b, s, d)
    if m.num_shared_experts:
        y = y + L.mlp_apply(p["shared"], x, cfg)

    density = torch.mean(F.one_hot(r.expert[..., 0], e).to(torch.float32),
                         dim=1)                                   # (G,E)
    density_proxy = torch.mean(r.probs, dim=1)                    # (G,E)
    aux = torch.mean(density * density_proxy) * (e ** 2) * m.aux_loss_weight
    return y, aux


def moe_param_count(cfg: ModelConfig) -> dict:
    """Total vs active parameters of one MoE layer."""
    m = cfg.moe
    d, dff, e = cfg.d_model, m.d_ff_expert, m.num_experts
    per_expert = 3 * d * dff
    total = e * per_expert + d * e
    active = m.top_k * per_expert + d * e
    if m.num_shared_experts:
        shared = 3 * d * (m.d_ff_dense or dff)
        total += shared
        active += shared
    return {"total": total, "active": active}
