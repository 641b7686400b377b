"""Mixture-of-Experts layer (GShard / Switch-style dispatch), as
``repro.models.moe``.

Tokens are padded to whole groups of ``group_size``; each group routes
its tokens to the top-k experts of a softmax over the router's logits
(ties: lowest expert first, as ``jax.lax.top_k``), and each expert takes
at most ``capacity`` of a group's (token, k) pairs, first come first
served in token-major order; the rest are dropped. The shared expert,
when the config has one, sees every token. The aux loss is Switch's load
balance over each group's first choices.

The experts run on rows, not on the reference's per-group capacity
buffer (G, E, C) reached through one-hot einsums. Each real token's kept
pair gets one row of an (R, D) buffer, expert-major and, within an
expert, group by group in queue order. The row index is worked out on
the device (no host read): a group's count of kept pairs per expert,
their cumulative sums, and each pair's slot in its queue. The SwiGLU
runs as three grouped products over the rows (``grouped_mm``:
``torch._grouped_mm`` on the card, one ``torch.mm`` per expert
elsewhere), and each token sums its kept pairs' rows times their gates
(a bf16 product with fp32 accumulation). The experts' ends need no
alignment: the rows are the products' outer dim, so each expert's rows
start at a multiple of the row stride (D or F elements), and
``torch._grouped_mm`` checks only the operands' strides for 16-byte
alignment. The capacity, the slots,
the dropped pairs and the pad tokens' places in each queue are the
reference's; a pad token's kept pairs take their capacity but get no
row. The products cost what the kept pairs need: ~2.5 M of the prefill
window's ~7.1 M capacity slots hold one.

The reference adds router noise only when its ``moe_apply`` is given an
rng, which its decoder stack never passes; the port's ``moe_apply`` has
no rng, so ``router_noise`` has no effect in either package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import telemetry
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


def grouped_mm(a, w, offs):
    """Rows of ``a`` (R, D) by expert: rows ``[offs[e-1], offs[e])``
    times ``w[e]`` (E, D, F) -> (R, F); the rows past ``offs[-1]`` are
    not computed (on the card they hold whatever the allocator left).
    On a CUDA tensor ``torch._grouped_mm`` (fp32 accumulation), which
    reads ``offs`` on the device; elsewhere ``grouped_mm_twin``."""
    if a.is_cuda:
        return torch._grouped_mm(a, w, offs=offs)
    return grouped_mm_twin(a, w, offs)


def grouped_mm_twin(a, w, offs):
    """``grouped_mm`` as one ``torch.mm`` per expert over its rows (the
    ends read on the host); the rows past ``offs[-1]`` are 0."""
    parts, lo = [], 0
    for e, hi in enumerate(offs.tolist()):
        parts.append(a[lo:hi] @ w[e])
        lo = hi
    parts.append(a.new_zeros((a.shape[0] - lo, w.shape[-1])))
    return torch.cat(parts)


class Rows(NamedTuple):
    row: torch.Tensor       # (G, S, K) int64: each kept pair's row, else R - 1
    src: torch.Tensor       # (R,) int64: each row's token (G x S flat)
    offs: torch.Tensor      # (E,) int32: the experts' end rows


def rows(expert, pos, valid, n_exp: int, n_rows: int) -> Rows:
    """The row index of the pairs ``valid`` (G, S, K) marks, with their
    experts ``expert`` (in [0, ``n_exp``) where valid) and queue slots
    ``pos``: expert-major, then group, then slot. ``n_rows`` (static,
    ``_row_bound``) is the buffers' rows; the last, which no expert's rows
    reach, stands for "no row" (its token, like that of every row past
    the experts' ends, is token 0). The valid pairs of a (group, expert)
    must hold its slots 0, 1, ... (a queue's real tokens come before its
    pad tokens)."""
    g, k = expert.shape[0], expert.shape[-1]
    ok = valid.reshape(g, -1)
    col = torch.where(ok, expert.reshape(g, -1), n_exp)     # n_exp: none
    cnt = torch.zeros((g, n_exp + 1), dtype=torch.int64,
                      device=expert.device)
    cnt = cnt.scatter_add_(1, col, ok.to(torch.int64))[:, :n_exp]  # (G,E)
    # a queue's first row: the rows of the earlier experts and of its
    # expert's earlier groups (an exclusive sum, expert-major)
    flat = cnt.t().reshape(-1)
    done = flat.cumsum(0)
    end = done.view(n_exp, g)[:, -1]                              # (E,)
    start = (done - flat).view(n_exp, g).t()                      # (G,E)
    row = start.gather(1, col.clamp(max=n_exp - 1)).add_(pos.reshape(g, -1))
    row = torch.where(ok, row, n_rows - 1)
    token = torch.arange(row.numel(), device=row.device) // k
    src = torch.zeros(n_rows, dtype=torch.int64, device=row.device)
    src = src.scatter_(0, row.reshape(-1), token)
    return Rows(row.reshape(expert.shape), src, end.to(torch.int32))


def _row_bound(pairs: int) -> int:
    """Rows enough for any routing of ``pairs`` pairs: each kept pair's,
    and the row that stands for none."""
    return pairs + 1


def _expert_rows(xg, gate, expert, pos, valid, n_rows, w_gate, w_up,
                 w_down):
    """The experts' SwiGLU on the rows of the pairs ``valid`` marks,
    summed back to the tokens with their gates: xg (G,S,D); gate, expert,
    pos, valid (G,S,K), experts in [0, E) of the weights (E,D,F) /
    (E,F,D) where valid -> (G,S,D); a token with no valid pair gets 0.
    While a profiler runs: the counter ``moe.rows`` (the rows the
    products ran over, a device sum)."""
    g, s, d = xg.shape
    dt = xg.dtype
    ix = rows(expert, pos, valid, w_gate.shape[0], n_rows)
    if telemetry.enabled():
        telemetry.count("moe.rows", ix.offs[-1])
    xr = xg.reshape(g * s, d).index_select(0, ix.src)             # (R,D)
    if xr.requires_grad:
        # past the experts' ends the products leave their input's gradient
        # unwritten: those rows pass none to their tokens
        past = torch.arange(n_rows, device=xr.device) >= ix.offs[-1]
        xr = torch.where(past[:, None], 0, xr)
    h = grouped_mm(xr, w_gate, ix.offs)
    u = grouped_mm(xr, w_up, ix.offs)
    yr = grouped_mm(F.silu(h) * u, w_down, ix.offs)                # (R,D)
    # each token's kept pairs' rows times their gates; the row for none
    # (and every row past the experts' ends) may hold NaN on the card, so
    # it is masked, not multiplied by 0
    row = ix.row.reshape(g * s, -1)
    yk = yr.index_select(0, row.reshape(-1)).reshape(*row.shape, d)
    yk = torch.where((row != n_rows - 1)[..., None], yk, 0)      # (N,K,D)
    y = torch.bmm(gate.to(dt).reshape(g * s, 1, -1), yk)
    return y.reshape(g, s, d)


def _expert_parallel(xg, gate, expert, pos, kept, n_tok, w_gate, w_up,
                     w_down):
    """``_expert_rows`` on the kept pairs of the first ``n_tok`` tokens
    (the rest pad the last group); under a mesh, expert parallel on each
    rank's share: the groups keep their batch split (the tokens
    replicated over the expert split), each rank runs its own experts on
    their pairs' rows (the weights gathered over any other split: FSDP),
    and the combine is a ``Partial`` sum over the expert split. Nothing
    moves the tokens (no all-to-all)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    g, gs, k = expert.shape
    real = None
    if n_tok < g * gs:
        real = (torch.arange(g * gs, device=expert.device)
                < n_tok).reshape(g, gs, 1)
    if not isinstance(w_gate, DTensor):
        valid = kept if real is None else kept & real
        n_rows = _row_bound(n_tok * k)
        return _expert_rows(xg, gate, expert, pos, valid, n_rows, w_gate,
                            w_up, w_down)
    from torch.distributed.tensor.experimental import local_map
    if real is None:
        real = torch.ones((g, gs, 1), dtype=torch.bool, device=expert.device)
    mesh = w_gate.device_mesh
    rep = [Replicate()] * mesh.ndim
    ins = [t if isinstance(t, DTensor) else
           DTensor.from_local(t, mesh, rep, run_check=False)
           for t in (xg, gate, expert, pos, kept, real)]
    ep = [i for i, pl in enumerate(w_gate.placements) if pl.is_shard(0)]
    tp = tuple(Replicate() if i in ep or not (pl.is_shard(0))
               else pl for i, pl in enumerate(ins[0].placements))
    wp = tuple(Shard(0) if i in ep else Replicate() for i in range(mesh.ndim))
    tg = tuple(Partial() if i in ep else pl for i, pl in enumerate(tp))
    wg = tuple(Shard(0) if i in ep else Partial() if tp[i].is_shard()
               else Replicate() for i in range(mesh.ndim))
    op = tuple(Partial() if i in ep else pl for i, pl in enumerate(tp))
    e_loc = w_gate.shape[0] // math.prod(mesh.shape[i] for i in ep)
    lo = L._shard_index(mesh, ep) * e_loc

    def local(x, g_, e_, p_, k_, r_, wg_, wu_, wd_):
        e_ = e_ - lo
        valid = k_ & r_ & (e_ >= 0) & (e_ < e_loc)
        n_rows = _row_bound(e_.numel())
        return _expert_rows(x, g_, e_, p_, valid, n_rows, wg_, wu_, wd_)

    args = [L.redistribute_at("experts", t, tp) for t in ins] + [
        L.redistribute_at("experts", t, wp) for t in (w_gate, w_up, w_down)]
    return local_map(local, out_placements=list(op),
                     in_placements=(tp,) * 6 + (wp,) * 3,
                     in_grad_placements=(tg,) * 6 + (wg,) * 3,
                     device_mesh=mesh)(*args)


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D), aux loss (load balance, f32 scalar).
    While a profiler runs: the span ``model.moe`` and the counters
    ``moe.pairs_kept`` (real tokens' kept pairs, summed on the device),
    ``moe.slots`` (groups x experts x capacity) and ``moe.rows``
    (``_expert_rows``)."""
    with telemetry.span("model.moe"):
        m = cfg.moe
        b, s, d = x.shape
        r = route(p, x, cfg)
        g, gs, _ = r.xg.shape
        e, cap, dt = m.num_experts, r.capacity, r.xg.dtype
        if telemetry.enabled():
            telemetry.count("moe.pairs_kept",
                            r.kept.reshape(g * gs, -1)[:r.n_tok].sum())
            telemetry.count("moe.slots", g * e * cap)
        y = _expert_parallel(r.xg, r.gate, r.expert, r.pos, r.kept, r.n_tok,
                             p["expert_gate"].to(dt), p["expert_up"].to(dt),
                             p["expert_down"].to(dt))                 # (G,S,D)

        y = y.reshape(g * gs, d)[:r.n_tok].reshape(b, s, d)
        if m.num_shared_experts:
            y = y + L.mlp_apply(p["shared"], x, cfg)

        density = torch.mean(F.one_hot(r.expert[..., 0], e).to(torch.float32),
                             dim=1)                                   # (G,E)
        density_proxy = torch.mean(r.probs, dim=1)                    # (G,E)
        aux = (torch.mean(density * density_proxy) * (e ** 2)
               * m.aux_loss_weight)
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
