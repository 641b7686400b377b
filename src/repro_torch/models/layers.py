"""Core layers in PyTorch (functional: init_* / apply pairs on nested dicts
of tensors, as ``repro.models.layers``).

Ported: the init helpers, layer norm and the Gemma-style RMS norm
(``1 + scale``), RoPE, the gated MLPs (SwiGLU, tanh-GeGLU) and the
biased ones (tanh-GELU, squared ReLU), GQA attention with q/k/v biases,
a sliding window and a tanh softcap, DeepSeek's multi-head latent
attention (MLA) with its absorbed decode, and the decode caches (rolling
buffers, single-token decode attention).

Attention over a full sequence takes one of two routes. Without a
gradient (``torch.is_grad_enabled()`` false: the eval, prefill) it goes
to ``kernels.ops.flash_attention``, the CUDA flash kernel on the card
and its plain twin on the CPU: causal for the decoders, ``causal=False``
for ``bidir_attention`` (the encoder and the cross-attention, where q
and k may differ in length). With a gradient it is the reference's
``_attend_block`` (plain matmuls and a softmax over each q chunk's kv
range, masked with -1e30; past ``2 * kv_chunk`` keys, its online-softmax
scan over kv chunks, masked with -inf), since the kernel has no
backward. Decode attention stays plain torch: the JAX package has no
kernel for it.
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


def _uniform(gen: Optional[torch.Generator], shape, low: float, high: float,
             device: torch.device) -> torch.Tensor:
    """Uniform fp32 draws in [low, high), as ``_normal`` draws."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    return (u * (high - low) + low).to(device)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_normal(gen, (in_dim, out_dim), device) * scale).to(dtype)


def embed_init(gen, vocab: int, dim: int, dtype, device):
    return (_normal(gen, (vocab, dim), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_init(cfg: ModelConfig, device, dim: Optional[int] = None):
    """Layer norm (scale 1, bias 0) or the Gemma RMS norm (scale 0,
    applied as ``1 + scale``), by ``cfg.norm_type``, over ``dim``
    (default ``d_model``)."""
    dim, dt = dim or cfg.d_model, cfg.param_dtype
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


def mlp_init(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None,
             d_model: Optional[int] = None):
    """The gated MLP (``w_gate``, ``w_up``, ``w_down``) for ``swiglu`` and
    ``geglu``, the biased one (``w_up``, ``b_up``, ``w_down``,
    ``b_down``) for ``gelu`` and ``relu2``; ``d_ff`` / ``d_model``
    override the config's widths (MoE's dense layers and shared
    expert)."""
    d_ff, dm, dt = d_ff or cfg.d_ff, d_model or cfg.d_model, cfg.param_dtype
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, dm, d_ff, dt, device),
                "w_up": dense_init(gen, dm, d_ff, dt, device),
                "w_down": dense_init(gen, d_ff, dm, dt, device)}
    if cfg.mlp_type in ("gelu", "relu2"):
        return {"w_up": dense_init(gen, dm, d_ff, dt, device),
                "b_up": torch.zeros((d_ff,), dtype=dt, device=device),
                "w_down": dense_init(gen, d_ff, dm, dt, device),
                "b_down": torch.zeros((dm,), dtype=dt, device=device)}
    raise ValueError(f"mlp_type {cfg.mlp_type!r} has no MLP")


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ModelConfig):
    """SwiGLU (SiLU gate) or GeGLU (tanh GELU gate); squared ReLU
    (Nemotron) or tanh GELU between the biased projections."""
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        act = F.silu(g) if cfg.mlp_type == "swiglu" else gelu(g)
        return (act * (x @ p["w_up"])) @ p["w_down"]
    h = x @ p["w_up"] + p["b_up"]
    h = torch.square(F.relu(h)) if cfg.mlp_type == "relu2" else gelu(h)
    return h @ p["w_down"] + p["b_down"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _softcap(scores, cap: Optional[float]):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def _scores_mask(qpos, kpos, window: Optional[int], causal: bool = True):
    """(Cq, L) bool: the key slot holds a token (padding slots carry kpos
    -1), at or before the query when causal, inside the window when
    there is one."""
    mask = kpos[None, :] >= 0
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > (qpos[:, None] - window))
    return mask


def _attend_block(q, k, v, qpos, kpos, scale, softcap, window,
                  kv_chunk: int = 2048, causal: bool = True):
    """q: (B,Cq,H,D) k/v: (B,L,KVH,Dv) -> (B,Cq,H,Dv), fp32 softmax.

    Up to ``2 * kv_chunk`` keys: full scores over the kv range,
    softcapped, masked with -1e30. Past that, the reference's
    flash-style scan over kv chunks (keys padded to whole chunks with
    kpos -1): an online softmax with running max ``m`` (masked scores
    -inf; a row that has kept nothing yet subtracts 0, ``m_safe``), the
    probabilities cast to v's dtype before the PV product and the sums
    kept in fp32."""
    b, cq, h, d = q.shape
    kvh, dv = k.shape[2], v.shape[-1]
    g = h // kvh
    qg = q.reshape(b, cq, kvh, g, d)
    length = k.shape[1]

    if length <= 2 * kv_chunk:
        scores = torch.einsum("bqkgd,blkd->bkgql", qg,
                              k).to(torch.float32) * scale
        scores = _softcap(scores, softcap)
        mask = _scores_mask(qpos, kpos, window, causal)
        scores = scores.masked_fill(~mask[None, None, None], -1e30)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgql,blkd->bqkgd", w, v)
        return out.reshape(b, cq, h, dv)

    n = -(-length // kv_chunk)
    pad = n * kv_chunk - length
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = F.pad(kpos, (0, pad), value=-1)
    m = torch.full((b, kvh, g, cq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((b, kvh, g, cq), dtype=torch.float32,
                        device=q.device)
    acc = torch.zeros((b, cq, kvh, g, dv), dtype=torch.float32,
                      device=q.device)
    for i in range(n):
        chunk = slice(i * kv_chunk, (i + 1) * kv_chunk)
        kb, vb = k[:, chunk], v[:, chunk]
        s = torch.einsum("bqkgd,blkd->bkgql", qg, kb).to(torch.float32) * scale
        s = _softcap(s, softcap)
        mask = _scores_mask(qpos, kpos[chunk], window, causal)
        s = s.masked_fill(~mask[None, None, None], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l_sum = l_sum * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgql,blkd->bqkgd", p.to(vb.dtype), vb)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv.to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l_sum, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.to(v.dtype).reshape(b, cq, h, dv)


def bidir_attention(q, k, v, *, softcap: Optional[float] = None,
                    scale: Optional[float] = None, kv_chunk: int = 2048):
    """Full bidirectional attention (the encoder, the cross-attention):
    q (B,Sq,H,D) over k/v (B,Sk,KVH,D), Sq and Sk free; ``scale``
    defaults to 1/sqrt(D). Without a gradient ``ops.flash_attention``
    with ``causal=False``, with one the reference's ``_attend_block``."""
    if not torch.is_grad_enabled():
        return ops.flash_attention(q, k, v, causal=False, softcap=softcap,
                                   scale=scale)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qpos = torch.arange(q.shape[1], device=q.device, dtype=torch.int32)
    kpos = torch.arange(k.shape[1], device=q.device, dtype=torch.int32)
    return _attend_block(q, k, v, qpos, kpos, scale, softcap, None,
                         kv_chunk=kv_chunk, causal=False)


def blockwise_attention(q, k, v, *, q_chunk: int,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """Causal (optionally windowed) attention over q chunks, each chunk
    attending to its exact kv range. q: (B, S, H, Dq), k: (B, S, KVH,
    Dq), v: (B, S, KVH, Dv); ``scale`` defaults to 1/sqrt(Dq)."""
    b, s, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    c = min(q_chunk, s)
    outs = []
    for q0 in range(0, s, c):
        q1 = min(q0 + c, s)
        k0 = 0 if window is None else max(0, q1 - window - (q1 - q0))
        qpos = torch.arange(q0, q1, device=q.device, dtype=torch.int32)
        kpos = torch.arange(k0, q1, device=q.device, dtype=torch.int32)
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
    slot = torch.arange(s_buf, device=q.device, dtype=torch.int32)
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
    p = {"wq": dense_init(gen, dm, h * hd, dt, device),
         "wk": dense_init(gen, dm, kvh * hd, dt, device),
         "wv": dense_init(gen, dm, kvh * hd, dt, device),
         "wo": dense_init(gen, h * hd, dm, dt, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kvh * hd),
                            ("bv", kvh * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    return p


def _qkv(p, x, cfg: ModelConfig):
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
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


def _buffer_from_full(t, s_buf: int):
    """One prefill tensor (B, S, ...) -> its ``s_buf``-slot decode buffer:
    the trailing ``s_buf`` tokens rolled so the newest sits in slot
    (S-1) % s_buf (the rolling-write convention of the decode steps), or
    the whole prefix zero-padded to ``s_buf``."""
    s = t.shape[1]
    if s >= s_buf:
        return torch.roll(t[:, s - s_buf:], s % s_buf, dims=1)
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, s_buf - s))


def attn_cache_from_full(k, v, s_buf: int):
    """A decode cache from prefill K/V (B, S, KVH, D), see
    ``_buffer_from_full``."""
    return {"k": _buffer_from_full(k, s_buf), "v": _buffer_from_full(v, s_buf),
            "index": torch.tensor(k.shape[1], dtype=torch.int32,
                                  device=k.device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_init(gen, cfg: ModelConfig, device):
    m, h, dm, dt = cfg.mla, cfg.num_heads, cfg.d_model, cfg.param_dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, dm, m.q_lora_rank, dt, device),
        "q_norm": norm_init(cfg, device, m.q_lora_rank),
        "w_uq": dense_init(gen, m.q_lora_rank, h * qk_head, dt, device),
        "w_dkv": dense_init(gen, dm, m.kv_lora_rank, dt, device),
        "kv_norm": norm_init(cfg, device, m.kv_lora_rank),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, dt,
                           device),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dt, device),
        "w_kr": dense_init(gen, dm, m.qk_rope_head_dim, dt, device),
        "wo": dense_init(gen, h * m.v_head_dim, dm, dt, device),
    }


def _mla_q(p, x, positions, cfg: ModelConfig):
    m = cfg.mla
    b, s, _ = x.shape
    q_lat = norm_apply(p["q_norm"], x @ p["w_dq"])
    q = (q_lat @ p["w_uq"]).reshape(b, s, cfg.num_heads,
                                    m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _mla_scale(m) -> float:
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def mla_apply_full(p, x, positions, cfg: ModelConfig):
    """Train / eval / prefill: the latents expanded to per-head k (nope
    and the shared RoPE key) and v, causal attention at scale
    1/sqrt(qk_nope + qk_rope) -> (out, (c_kv, k_rope)), the decode
    cache's two latents.

    Without a gradient the attention is the flash kernel, whose contract
    has one head width for q, k and v: v (``v_head_dim``, 128 in
    DeepSeek-V3) is zero-padded to the q/k width (192) and the output
    cut back. The padded columns of v only ever add exact zeros, so the
    kept columns are the same function."""
    m, h = cfg.mla, cfg.num_heads
    b, s, _ = x.shape
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv = norm_apply(p["kv_norm"], x @ p["w_dkv"])           # (B,S,r_kv)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, m.qk_nope_head_dim)
    vv = (c_kv @ p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    k_rope = rope((x @ p["w_kr"])[:, :, None, :], positions, cfg.rope_theta)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, m.qk_rope_head_dim)],
                  dim=-1)
    scale = _mla_scale(m)
    if torch.is_grad_enabled():
        out = blockwise_attention(q, k, vv, softcap=cfg.attn_softcap,
                                  q_chunk=cfg.q_chunk, scale=scale)
    else:
        pad = q.shape[-1] - m.v_head_dim
        if pad < 0:
            raise NotImplementedError("MLA with v_head_dim wider than "
                                      "qk_nope + qk_rope")
        out = ops.flash_attention(q, k, F.pad(vv, (0, pad)), causal=True,
                                  softcap=cfg.attn_softcap,
                                  scale=scale)[..., :m.v_head_dim]
    return out.reshape(b, s, -1) @ p["wo"], (c_kv, k_rope[:, :, 0, :])


def mla_apply_decode(p, x, cache, cfg: ModelConfig):
    """Absorbed-matmul MLA decode: W_UK folds into the query and W_UV
    into the output, so scores and context live in the latent space and
    the cache holds only ``c_kv`` (r_kv) and ``k_rope`` per token.
    ``cache`` = {"c_kv": (B, S_buf, r_kv), "k_rope": (B, S_buf, d_rope),
    "index": 0-dim int32}, updated in place as ``attn_apply_decode``
    updates its own."""
    m, h = cfg.mla, cfg.num_heads
    b = x.shape[0]
    idx = cache["index"]
    pos = idx.expand(b, 1)
    q_nope, q_rope = _mla_q(p, x, pos, cfg)                   # (B,1,H,*)
    c_new = norm_apply(p["kv_norm"], x @ p["w_dkv"])          # (B,1,r)
    kr_new = rope((x @ p["w_kr"])[:, :, None, :], pos,
                  cfg.rope_theta)[:, :, 0, :]
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    s_buf = c_kv.shape[1]
    slot = (idx % s_buf).reshape(1).long()
    c_kv.index_copy_(1, slot, c_new.to(c_kv.dtype))
    k_rope.index_copy_(1, slot, kr_new.to(k_rope.dtype))
    idx.add_(1)
    w_uk = p["w_uk"].reshape(m.kv_lora_rank, h, m.qk_nope_head_dim)
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)      # absorb W_UK
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope)
              ).to(torch.float32) * _mla_scale(m)
    scores = _softcap(scores, cfg.attn_softcap)
    slot = torch.arange(s_buf, device=x.device, dtype=torch.int32)
    age = ((idx - 1) % s_buf - slot) % s_buf
    scores = scores.masked_fill(~(age < torch.clamp(idx, max=s_buf)), -1e30)
    w = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    ctx_lat = torch.einsum("bhqs,bsr->bqhr", w, c_kv)          # (B,1,H,r)
    w_uv = p["w_uv"].reshape(m.kv_lora_rank, h, m.v_head_dim)
    ctx = torch.einsum("bqhr,rhd->bqhd", ctx_lat, w_uv)       # absorb W_UV
    return ctx.reshape(b, 1, -1) @ p["wo"], cache


def mla_cache_init(cfg: ModelConfig, batch: int, s_buf: int, device):
    m, dt = cfg.mla, cfg.compute_dtype
    return {"c_kv": torch.zeros((batch, s_buf, m.kv_lora_rank), dtype=dt,
                                device=device),
            "k_rope": torch.zeros((batch, s_buf, m.qk_rope_head_dim),
                                  dtype=dt, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def mla_cache_from_full(c_kv, k_rope, s_buf: int):
    """The decode cache from prefill's latents (B, S, r_kv) and RoPE keys
    (B, S, d_rope), see ``_buffer_from_full``."""
    return {"c_kv": _buffer_from_full(c_kv, s_buf),
            "k_rope": _buffer_from_full(k_rope, s_buf),
            "index": torch.tensor(c_kv.shape[1], dtype=torch.int32,
                                  device=c_kv.device)}
