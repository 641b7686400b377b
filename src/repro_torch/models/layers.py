"""Core layers in PyTorch (functional: init_* / apply pairs on nested dicts
of tensors, as ``repro.models.layers``).

Ported: the init helpers, layer norm and the Gemma-style RMS norm
(``1 + scale``), RoPE, the tanh-GELU MLP and the gated GeGLU MLP, GQA
attention with a sliding window and a tanh softcap, and the decode
caches (rolling buffers, single-token decode attention).

Attention over a full sequence takes one of two routes. Without a
gradient (``torch.is_grad_enabled()`` false: the eval, prefill) it goes
to ``kernels.ops.flash_attention``, the CUDA flash kernel on the card
and its plain twin on the CPU. With a gradient it is the dense branch of
the reference's ``_attend_block`` (plain matmuls and a softmax over each
q chunk's kv range, masked with -1e30), since the kernel has no
backward. Decode attention stays plain torch: the JAX package has no
kernel for it. SwiGLU / squared-ReLU MLPs, q/k/v biases, MLA and the
kv-chunked online-softmax scan are not ported (ROADMAP queue 1 item
11).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# init helpers (random draws on the generator's device, then moved, so a
# CPU generator gives the same weights on every device; a "meta" device
# draws nothing and gives shapes only)
# ---------------------------------------------------------------------------


def _normal(gen: Optional[torch.Generator], shape,
            device: torch.device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device).to(device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_normal(gen, (in_dim, out_dim), device) * scale).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device):
    return (_normal(gen, (vocab, dim), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, device):
    """Layer norm (scale 1, bias 0) or the Gemma RMS norm (scale 0,
    applied as ``1 + scale``), by ``cfg.norm_type``."""
    dim, dt = cfg.d_model, cfg.param_dtype
    if cfg.norm_type == "layer":
        return {"scale": torch.ones((dim,), dtype=dt, device=device),
                "bias": torch.zeros((dim,), dtype=dt, device=device)}
    if cfg.norm_type == "rms":
        return {"scale": torch.zeros((dim,), dtype=dt, device=device)}
    raise ValueError(f"unknown norm_type {cfg.norm_type!r}")


def norm_apply(p, x):
    """Layer norm (population variance, rsqrt(var + 1e-6)) when ``p`` has
    a bias, else the RMS norm ``x * rsqrt(mean(x^2) + 1e-6) * (1 +
    scale)``; fp32 math, ``x.dtype`` out."""
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-6)
        out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6)
        out = out * (1.0 + p["scale"].to(torch.float32))
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
    if cfg.mlp_type == "geglu":
        return {"w_gate": dense_init(gen, dm, d_ff, dt, device),
                "w_up": dense_init(gen, dm, d_ff, dt, device),
                "w_down": dense_init(gen, d_ff, dm, dt, device)}
    if cfg.mlp_type == "gelu":
        return {"w_up": dense_init(gen, dm, d_ff, dt, device),
                "b_up": torch.zeros((d_ff,), dtype=dt, device=device),
                "w_down": dense_init(gen, d_ff, dm, dt, device),
                "b_down": torch.zeros((dm,), dtype=dt, device=device)}
    raise NotImplementedError(f"mlp_type {cfg.mlp_type!r} is not ported "
                              f"yet (ROADMAP queue 1 item 11)")


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x):
    """GeGLU (tanh GELU) when ``p`` has a gate, else the biased GELU
    MLP."""
    if "w_gate" in p:
        return (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    h = gelu(x @ p["w_up"] + p["b_up"])
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _scores_mask(qpos, kpos, window: Optional[int]):
    """Causal mask with an optional sliding window: (Cq, L) bool."""
    mask = kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def _attend_block(q, k, v, qpos, kpos, scale, softcap, window):
    """q: (B,Cq,H,D) k/v: (B,L,KVH,D) -> (B,Cq,H,D): full scores over the
    kv range, softcapped, masked with -1e30, fp32 softmax."""
    b, cq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, cq, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,blkd->bkgql", qg, k).to(torch.float32) * scale
    scores = _softcap(scores, softcap)
    mask = _scores_mask(qpos, kpos, window)
    scores = scores.masked_fill(~mask[None, None, None], -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgql,blkd->bqkgd", w, v)
    return out.reshape(b, cq, h, v.shape[-1])


def blockwise_attention(q, k, v, *, q_chunk: int,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Causal (optionally windowed) attention over q chunks, each chunk
    attending to its exact kv range. q: (B, S, H, D), k/v: (B, S, KVH,
    D)."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    c = min(q_chunk, s)
    outs = []
    for q0 in range(0, s, c):
        q1 = min(q0 + c, s)
        k0 = 0 if window is None else max(0, q1 - window - (q1 - q0))
        qpos = torch.arange(q0, q1, device=q.device)
        kpos = torch.arange(k0, q1, device=q.device)
        outs.append(_attend_block(q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], qpos,
                                  kpos, scale, softcap, window))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def decode_attention(q, k_cache, v_cache, index, *, window: Optional[int],
                     softcap: Optional[float]):
    """Single-token attention over a (possibly rolling) cache.

    q: (B, 1, H, D); caches: (B, S_buf, KVH, D); ``index``: 0-dim int
    tensor, the number of tokens written so far (absolute). The newest
    token sits in slot ``(index - 1) % S_buf``; a slot is valid when its
    age is below ``min(index, S_buf)`` and, with a window, below it."""
    b, _, h, d = q.shape
    s_buf, kvh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, d)
    scores = torch.einsum("bqkgd,blkd->bkgql", qg,
                          k_cache).to(torch.float32) * (1.0 / math.sqrt(d))
    scores = _softcap(scores, softcap)
    slot = torch.arange(s_buf, device=q.device)
    age = ((index - 1) % s_buf - slot) % s_buf           # 0 = newest
    valid = age < torch.clamp(index, max=s_buf)
    if window is not None:
        valid &= age < window
    scores = scores.masked_fill(~valid, -1e30)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgql,blkd->bqkgd", w, v_cache)
    return out.reshape(b, 1, h, -1)


def attn_init(gen, cfg: ModelConfig, device):
    dm = cfg.d_model
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.param_dtype
    if cfg.qkv_bias:
        raise NotImplementedError("q/k/v biases are not ported yet (ROADMAP "
                                  "queue 1 item 11)")
    return {"wq": dense_init(gen, dm, h * hd, dt, device),
            "wk": dense_init(gen, dm, kvh * hd, dt, device),
            "wv": dense_init(gen, dm, kvh * hd, dt, device),
            "wo": dense_init(gen, h * hd, dm, dt, device)}


def _qkv(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    return (q.reshape(b, s, cfg.num_heads, cfg.head_dim),
            k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))


def attn_apply_full(p, x, positions, cfg: ModelConfig, *,
                    window: Optional[int] = None):
    """Training / eval / prefill forward over the full sequence ->
    (out, (k, v)), with k after RoPE (the prefill cache)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    # RoPE runs unconditionally, on top of any learned positions
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if torch.is_grad_enabled():
        out = blockwise_attention(q, k, v, window=window,
                                  softcap=cfg.attn_softcap,
                                  q_chunk=cfg.q_chunk)
    else:
        out = ops.flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.attn_softcap)
    return out.reshape(b, s, -1) @ p["wo"], (k, v)


def attn_apply_decode(p, x, cache, cfg: ModelConfig, *,
                      window: Optional[int] = None):
    """One-token decode. ``cache`` = {"k", "v": (B, S_buf, KVH, D),
    "index": 0-dim int32}; updated in place (the new k/v written into
    slot ``index % S_buf``, the index advanced) and returned. All on the
    device: no host sync per step."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    idx = cache["index"]
    pos = idx.expand(b, 1)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    slot = (idx % cache["k"].shape[1]).reshape(1).long()
    cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    idx.add_(1)
    out = decode_attention(q, cache["k"], cache["v"], idx, window=window,
                           softcap=cfg.attn_softcap)
    return out.reshape(b, 1, -1) @ p["wo"], cache


def attn_cache_init(cfg: ModelConfig, batch: int, s_buf: int, device):
    shape = (batch, s_buf, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.compute_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def attn_cache_from_full(k, v, s_buf: int):
    """A decode cache from prefill K/V (B, S, KVH, D): the trailing
    ``s_buf`` tokens, rolled so the newest sits in slot (S-1) % s_buf
    (the rolling-write convention of ``attn_apply_decode``), or the whole
    prefix zero-padded to ``s_buf``."""
    s = k.shape[1]
    index = torch.tensor(s, dtype=torch.int32, device=k.device)
    if s >= s_buf:
        shift = s % s_buf
        return {"k": torch.roll(k[:, s - s_buf:], shift, dims=1),
                "v": torch.roll(v[:, s - s_buf:], shift, dims=1),
                "index": index}
    pad = (0, 0, 0, 0, 0, s_buf - s)
    return {"k": F.pad(k, pad), "v": F.pad(v, pad), "index": index}
