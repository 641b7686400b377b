"""A decoder with sparse experts (Phi-3.5-MoE's layout) in plain PyTorch,
layer by layer, for the prefill cell.

As the configuration states it: token embedding; pre-norm blocks of
causal grouped-query attention (RoPE, theta 10,000, the two halves of a
head rotated together, scale 1/sqrt(head_dim), softmax in fp32) and a
routed MoE of SwiGLU experts; layer norms (population variance, eps
1e-6) with scale and bias; a final layer norm and an untied head. The
MoE routes each token to the top-k experts of a softmax over the
router's logits (ties to the lower expert), renormalises the k gates
(sum + 1e-9), and lets each expert take at most
ceil(group x k x capacity factor / E) (at least 4) of a group's (token,
choice) pairs in token-major order; pairs past that are dropped. Tokens
are grouped ``group_size`` at a time, the last group padded with zero
rows.

Top-k routing is a discrete choice: at a near tie any rounding may send
a token to another expert, which changes that token wholesale from
there on. So the judge follows the choices of the side it judges (as a
served model's reference follows its served tokens), and judges each
choice by its own probabilities: ``route_gap``.

Weights are the benchmark's (``weights``), drawn again one layer at a
time; the reference computes in fp32 with TF32 off, or, as the control,
with each matrix product's operands rounded to float8 e4m3 (a scale per
tensor, amax to 448; ``mode="fp8"``), in the backward's products too.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in fp32."""
    scale = E4M3_MAX / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w with every operand rounded to float8 e4m3 (``_fp8``), in the
    forward and in both products of the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fp8(x) @ _fp8(w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _fp8(g) @ _fp8(w).transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            if w.ndim == 2:          # x (..., K) @ w (K, N)
                gw = (_fp8(x).reshape(-1, x.shape[-1]).transpose(0, 1)
                      @ _fp8(g).reshape(-1, g.shape[-1]))
            else:                    # batched, the same leading dims
                gw = _fp8(x).transpose(-1, -2) @ _fp8(g)
        return gx, gw


def matmul(x, w, mode: str = "fp32"):
    if mode == "fp8":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _Fp8Matmul.apply(x, w)
        return _fp8(x) @ _fp8(w)
    return x @ w


def layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def rope(x, theta: float):
    """x (S, H, D)."""
    s, d = x.shape[0], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mode: str, chunk: int = 1024):
    """Causal GQA over one sequence: q (S, H, D), k / v (S, KVH, D) ->
    (S, H, D), queries ``chunk`` at a time."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)          # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    outs = []
    for q0 in range(0, s, chunk):
        q1 = min(q0 + chunk, s)
        qc = q[q0:q1].transpose(0, 1)                          # (H, c, D)
        sc = matmul(qc, k[:, :q1].transpose(1, 2), mode) / math.sqrt(d)
        keep = (torch.arange(q1, device=q.device)[None, :]
                <= torch.arange(q0, q1, device=q.device)[:, None])
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(matmul(torch.softmax(sc, dim=-1), v[:, :q1], mode))
    return torch.cat(outs, dim=1).transpose(0, 1)


def moe(w, x, cfg: Dict, mode: str, expert=None):
    """x (T, D) one sequence's normed tokens -> (T, D), and the routing:
    ``expert`` (T', K) the choices taken (T' the tokens and the last
    group's pad rows), ``route_gap`` the widest margin by which a taken
    choice's probability lies below this side's k-th best (0 where it
    takes its own top-k), ``aux`` the load-balance loss (Switch's, over
    each group's first choices, pad rows included, x the weight).

    ``expert`` given (another side's choices, as integers, for the
    tokens and possibly the pad rows) is followed in place of this
    side's own top-k: the gates are this side's probabilities at those
    experts, renormalised over the k, and the capacity queues are worked
    out again from them."""
    e, k = cfg["num_experts"], cfg["top_k"]
    t, d = x.shape
    gs = min(cfg["group_size"], t)
    n_grp = -(-t // gs)
    xg = F.pad(x, (0, 0, 0, n_grp * gs - t)).reshape(n_grp, gs, d)
    logits = matmul(xg, w["ffn.router"], mode)
    probs = torch.softmax(logits, dim=-1).reshape(-1, e)        # (G gs, E)
    top, own = torch.sort(probs.detach(), dim=-1, descending=True,
                          stable=True)
    own = own[:, :k]
    if expert is None:
        expert, gap = own, 0.0
    else:
        expert = expert.to(probs.device).long()
        n = min(len(expert), t)
        taken = probs.detach()[:n].gather(1, expert[:n])
        gap = float((top[:n, k - 1:k] - taken).clamp(min=0).max())
        expert = torch.cat([expert, own[len(expert):]])
    gate = probs[:t].gather(1, expert[:t])
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    cap = max(4, math.ceil(gs * k * cfg["capacity_factor"] / e))
    # the pad rows queue after every real token of the last group, so
    # they take no real token's slot
    onehot = F.one_hot(expert, e).reshape(n_grp, gs * k, e)
    pos = (onehot.cumsum(1) * onehot).sum(-1).reshape(-1, k)[:t] - 1
    kept = pos < cap
    density = F.one_hot(expert[:, 0], e).to(probs.dtype).reshape(
        n_grp, gs, e).mean(dim=1)
    aux = ((density * probs.reshape(n_grp, gs, e).mean(dim=1)).mean()
           * e ** 2 * cfg["aux_loss_weight"])
    et = expert[:t]
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, choice = torch.nonzero((et == ex) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = x[tok]
        a = F.silu(matmul(h, w["ffn.expert_gate"][ex], mode)) * matmul(
            h, w["ffn.expert_up"][ex], mode)
        out = matmul(a, w["ffn.expert_down"][ex], mode)
        y = y.index_add(0, tok, out * gate[tok, choice][:, None])
    return y, {"expert": expert, "route_gap": gap, "aux": aux}


def block(w: Dict[str, torch.Tensor], x, cfg: Dict, mode: str = "fp32",
          expert=None):
    """One layer over one sequence's hidden states x (S, D) -> (x, its
    keys after RoPE and its values (S, KVH, D), the MoE's routing as
    ``moe`` gives it); ``expert`` as ``moe`` takes it."""
    s, _ = x.shape
    h, kvh, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    y = layer_norm(x, w["ln1.scale"], w["ln1.bias"])
    q = rope(matmul(y, w["attn.wq"], mode).reshape(s, h, hd),
             cfg["rope_theta"])
    k = rope(matmul(y, w["attn.wk"], mode).reshape(s, kvh, hd),
             cfg["rope_theta"])
    v = matmul(y, w["attn.wv"], mode).reshape(s, kvh, hd)
    x = x + matmul(attention(q, k, v, mode).reshape(s, h * hd),
                   w["attn.wo"], mode)
    f, routing = moe(w, layer_norm(x, w["ln2.scale"], w["ln2.bias"]), cfg,
                     mode, expert)
    return x + f, (k, v), routing


def embed(io: Dict[str, torch.Tensor], tokens):
    return io["io.embed"][tokens.long()]


def head_logits(io: Dict[str, torch.Tensor], x, mode: str = "fp32"):
    x = layer_norm(x, io["io.final_norm.scale"], io["io.final_norm.bias"])
    return matmul(x, io["io.head"], mode)
