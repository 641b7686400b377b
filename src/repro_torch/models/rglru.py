"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) in
PyTorch, as ``repro.models.rglru``:

    r_t = sigmoid(W_r x_t),  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Griffin's recurrent block: a gate branch (SiLU) and a recurrence branch
(causal width-4 conv, then the RG-LRU), multiplied and projected out.
Prefill and training run the linear recurrence as a log-depth doubling
scan over the sequence in plain torch (``rglru_scan``: ceil(log2 S)
steps, none per token); the reference runs ``jax.lax.associative_scan``,
which sums in another tree order, so the two agree within fp32
rounding, not bit for bit. Decode is one step, updating its cache in
place. The gates, Lambda and the state are fp32; the projections run in
the parameters' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, _uniform, dense_init
from repro_torch.models.ssm import _store, causal_dwconv, causal_dwconv_step


def rglru_init(gen, cfg: ModelConfig, device):
    g, d, dt = cfg.rglru, cfg.d_model, cfg.param_dtype
    w = g.lru_width or d
    # Lambda so that a^c lies in [0.9, 0.999] (Griffin's appendix):
    # Lambda = softplus^-1(-log(u) / (2 c)), u ~ U[0.9^2, 0.999^2]
    u = _uniform(gen, (w,), 0.9 ** 2, 0.999 ** 2, device)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * g.c_const)))
    return {
        "w_gate_branch": dense_init(gen, d, w, dt, device),
        "w_rec_branch": dense_init(gen, d, w, dt, device),
        "conv_w": (_normal(gen, (g.conv_width, w), device) * 0.1).to(dt),
        "w_r": dense_init(gen, w, w, dt, device),
        "w_i": dense_init(gen, w, w, dt, device),
        "lambda_raw": lam,
        "w_out": dense_init(gen, w, d, dt, device),
    }


def _gates(p, x, cfg: ModelConfig):
    """-> (a, sqrt(1 - a^2) * i), fp32: the decay and the input scale."""
    r = torch.sigmoid((x @ p["w_r"]).to(torch.float32))
    i = torch.sigmoid((x @ p["w_i"]).to(torch.float32))
    log_a = -cfg.rglru.c_const * F.softplus(p["lambda_raw"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i


def rglru_scan(a, bx):
    """h_t = a_t h_{t-1} + bx_t (h_{-1} = 0) along dim 1 of (B, S, W):
    a Hillis-Steele doubling scan, each step composing every position
    with the one ``shift`` before it, (a2, b2) o (a1, b1) = (a2 a1, a2 b1
    + b2), the reference's combine."""
    s = a.shape[1]
    shift = 1
    while shift < s:
        b_prev = F.pad(bx[:, :-shift], (0, 0, shift, 0))
        a_prev = F.pad(a[:, :-shift], (0, 0, shift, 0), value=1.0)
        bx = a * b_prev + bx
        a = a * a_prev
        shift *= 2
    return bx


def rglru_apply_full(p, x, cfg: ModelConfig, h0=None):
    """x: (B, S, D) -> (out (B, S, D), the decode cache {conv (the last
    W-1 pre-conv inputs), h (B, W) fp32}); ``h0`` (B, W), an incoming
    state, is folded into the first step."""
    g = cfg.rglru
    gate = F.silu(x @ p["w_gate_branch"])
    u_pre = x @ p["w_rec_branch"]
    u = causal_dwconv(u_pre, p["conv_w"])
    a, scale = _gates(p, u, cfg)
    bx = scale * u.to(torch.float32)
    if h0 is not None:
        bx = torch.cat([bx[:, :1] + (a[:, 0] * h0)[:, None], bx[:, 1:]],
                       dim=1)
    h = rglru_scan(a, bx)
    out = (h.to(x.dtype) * gate) @ p["w_out"]
    conv_tail = u_pre[:, -(g.conv_width - 1):].to(cfg.compute_dtype)
    return out, {"conv": conv_tail, "h": h[:, -1]}


def rglru_apply_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, 1, D); ``cache`` {conv (B, W-1, Wd), h (B, Wd)} is updated
    in place and returned."""
    x_t = x[:, 0]
    gate = F.silu(x_t @ p["w_gate_branch"])
    u, conv_state = causal_dwconv_step(x_t @ p["w_rec_branch"],
                                       cache["conv"], p["conv_w"])
    a, scale = _gates(p, u, cfg)
    h = a * cache["h"] + scale * u.to(torch.float32)
    out = ((h.to(x.dtype) * gate) @ p["w_out"])[:, None]
    _store(cache, {"conv": conv_state, "h": h})
    return out, cache


def rglru_cache_init(cfg: ModelConfig, batch: int, device):
    g = cfg.rglru
    w = g.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, g.conv_width - 1, w),
                                dtype=cfg.compute_dtype, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32, device=device)}
