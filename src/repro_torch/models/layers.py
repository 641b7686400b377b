"""Core layers of the char-LM in PyTorch (functional: init_* / apply pairs
on nested dicts of tensors, as ``repro.models.layers``).

Ported: the init helpers, layer norm, RoPE, the tanh-GELU MLP, and
full-sequence causal attention computed as the dense branch of the
reference's ``_attend_block`` (plain matmuls and a softmax over the whole
causal prefix, masked with -1e30). The RMS norm, the gated MLPs, MLA,
attention windows and softcaps, the decode caches and the kv-chunked
online-softmax scan are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ---------------------------------------------------------------------------
# init helpers (random draws on the CPU generator, then moved, so a seed
# gives the same weights on every device)
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_normal(gen, (in_dim, out_dim), device) * scale).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device):
    return (_normal(gen, (vocab, dim), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, device):
    return {"scale": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                                device=device),
            "bias": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                device=device)}


def norm_apply(p, x):
    """Layer norm with the population variance and rsqrt(var + 1e-6)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + 1e-6)
    out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """x: (..., S, H, D) with D even; positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq    # (..., S, half)
    ang = ang[..., None, :]                                   # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, cfg: ModelConfig, device):
    dm, d_ff, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {"w_up": dense_init(gen, dm, d_ff, dt, device),
            "b_up": torch.zeros((d_ff,), dtype=dt, device=device),
            "w_down": dense_init(gen, d_ff, dm, dt, device),
            "b_down": torch.zeros((dm,), dtype=dt, device=device)}


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x):
    h = gelu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# causal attention
# ---------------------------------------------------------------------------


def _attend_block(q, k, v, qpos, kpos, scale):
    """q: (B,Cq,H,D) k/v: (B,L,KVH,D) -> (B,Cq,H,D): full scores over the
    kv prefix, causal mask filled with -1e30, fp32 softmax."""
    b, cq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, cq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,blkd->bkgql", qg, k).to(torch.float32) * scale
    mask = kpos[None, :] <= qpos[:, None]
    scores = scores.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgql,blkd->bqkgd", w, v)
    return out.reshape(b, cq, h, v.shape[-1])


def blockwise_attention(q, k, v, *, q_chunk: int):
    """Causal attention over q chunks, each chunk attending to its exact
    causal kv prefix. q: (B, S, H, D), k/v: (B, S, KVH, D)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c = min(q_chunk, s)
    outs = []
    for q0 in range(0, s, c):
        q1 = min(q0 + c, s)
        qpos = torch.arange(q0, q1, device=q.device)
        kpos = torch.arange(0, q1, device=q.device)
        outs.append(_attend_block(q[:, q0:q1], k[:, :q1], v[:, :q1], qpos,
                                  kpos, scale))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attn_init(gen, cfg: ModelConfig, device):
    dm = cfg.d_model
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    return {"wq": dense_init(gen, dm, h * hd, dt, device),
            "wk": dense_init(gen, dm, kvh * hd, dt, device),
            "wv": dense_init(gen, dm, kvh * hd, dt, device),
            "wo": dense_init(gen, h * hd, dm, dt, device)}


def attn_apply_full(p, x, positions, cfg: ModelConfig):
    """Training forward over the full sequence."""
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    # RoPE runs unconditionally, on top of the learned positions
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    out = blockwise_attention(q, k, v, q_chunk=cfg.q_chunk)
    return out.reshape(b, s, -1) @ p["wo"]
