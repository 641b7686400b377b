"""The char-LM (the paper's §5 model) in plain PyTorch, for C clients at
once: every parameter carries a leading client axis, and the loss of
each client is its own mean cross-entropy.

The model, as the configuration states it: learned token and position
embeddings (tied unembedding), ``num_layers`` pre-norm blocks of causal
multi-head attention (RoPE on q and k on top of the learned positions,
scale 1/sqrt(head_dim)) and a GELU (tanh) MLP with biases, layer norms
(population variance, eps 1e-6), a final layer norm; fp32 throughout,
softmax in fp32. Stacked parameters hold one slice per layer, as the
program's do.

``adamw_step`` is AdamW as the configuration's optimizer states it
(b1 0.9, b2 0.999, eps 1e-8, bias-corrected, weight decay on the leaves
of two or more axes in the stacked layout, the step scaled by -lr), with
a freezing mask on gradients and updates.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

Tensors = Dict[str, torch.Tensor]
UNIT = "stack.units.b0."


def layer_norm(x, scale, bias):
    """x (C, ..., D); scale, bias (C, D)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    shape = (scale.shape[0],) + (1,) * (x.ndim - 2) + (scale.shape[-1],)
    return ((x - mu) * torch.rsqrt(var + 1e-6) * scale.reshape(shape)
            + bias.reshape(shape))


def rope(x, theta: float):
    """x (..., S, H, D): rotary embedding of positions 0..S-1, the two
    halves of each head rotated together."""
    s, d = x.shape[-3], x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mm(x, w):
    """x (C, ..., K) @ w (C, K, N)."""
    c = x.shape[0]
    lead = x.shape[1:-1]
    out = torch.bmm(x.reshape(c, -1, x.shape[-1]), w)
    return out.reshape((c,) + lead + (w.shape[-1],))


def losses(p: Tensors, tokens, targets, cfg: Dict):
    """p: the client-stacked parameters; tokens / targets (C, B, S) ->
    each client's mean cross-entropy (C,)."""
    c, b, s = tokens.shape
    h, hd, v = cfg["num_heads"], cfg["head_dim"], cfg["vocab_size"]
    emb = p["io.embed"]                                     # (C, V, D)
    d = emb.shape[-1]
    idx = tokens + torch.arange(c, device=tokens.device)[:, None, None] * v
    x = emb.reshape(c * v, d)[idx.reshape(-1)].reshape(c, b, s, d)
    x = x + p["io.pos_embed"][:, None, :s]
    mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    for u in range(cfg["num_layers"]):
        w = {k[len(UNIT):]: t[:, u] for k, t in p.items()
             if k.startswith(UNIT)}
        y = layer_norm(x, w["ln1.scale"], w["ln1.bias"])
        q = rope(_mm(y, w["attn.wq"]).reshape(c, b, s, h, hd),
                 cfg["rope_theta"])
        k = rope(_mm(y, w["attn.wk"]).reshape(c, b, s, h, hd),
                 cfg["rope_theta"])
        vv = _mm(y, w["attn.wv"]).reshape(c, b, s, h, hd)
        sc = torch.einsum("cbqhd,cbkhd->cbhqk", q, k) / math.sqrt(hd)
        sc = sc.masked_fill(~mask, -1e30)
        o = torch.einsum("cbhqk,cbkhd->cbqhd", torch.softmax(sc, dim=-1), vv)
        x = x + _mm(o.reshape(c, b, s, h * hd), w["attn.wo"])
        y = layer_norm(x, w["ln2.scale"], w["ln2.bias"])
        y = F.gelu(_mm(y, w["ffn.w_up"]) + w["ffn.b_up"][:, None, None],
                   approximate="tanh")
        x = x + _mm(y, w["ffn.w_down"]) + w["ffn.b_down"][:, None, None]
    x = layer_norm(x, p["io.final_norm.scale"], p["io.final_norm.bias"])
    logits = _mm(x, emb.transpose(1, 2))                    # (C, B, S, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (lse - ll).mean(dim=(1, 2))


def trainable(name: str, k: int, cfg: Dict) -> torch.Tensor:
    """The freezing mask of leaf ``name`` at ``k`` unfrozen top layers: a
    (L,) 0/1 vector over a stacked leaf's layers, else a 0-d 0/1. The
    token and position embeddings freeze whenever a layer does."""
    layers = cfg["num_layers"]
    k = max(1, min(k, layers))
    if name.startswith(UNIT):
        return (torch.arange(layers) >= layers - k).to(torch.float32)
    frozen = name in ("io.embed", "io.pos_embed") and k < layers
    return torch.tensor(0.0 if frozen else 1.0)


def adamw_step(p: Tensors, g: Tensors, state, mask: Tensors, cfg_opt: Dict
               ) -> Tensors:
    """One masked AdamW step on client-stacked leaves (in place on the
    state, new parameters out). ``state``: {"mu", "nu", "count"};
    ``mask[name]``: per-layer (L,) or 0-d, broadcast over the client
    axis. The decay rule reads each leaf's axes without the client's."""
    lr, wd = cfg_opt["lr"], cfg_opt["weight_decay"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    state["count"] += 1
    t = state["count"]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    out = {}
    for name, w in p.items():
        m = mask[name].to(w.device)
        m = m.reshape((1,) + tuple(m.shape) + (1,) * (w.ndim - 1 - m.ndim))
        gg = g[name] * m
        mu = state["mu"][name].mul_(b1).add_((1 - b1) * gg)
        nu = state["nu"][name].mul_(b2).add_((1 - b2) * gg * gg)
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        if wd and w.ndim - 1 >= 2:
            step = step + wd * w
        out[name] = w + (-lr * step) * m
    return out


def wire_round_trip(x: torch.Tensor, bits: int, block: int = 256):
    """A leaf through the wire format: zero-padded to whole blocks of
    ``block``, each block's absmax scaled to the largest code (L - 1,
    L = 2^(bits-1)), codes rint(x / scale) clipped to +-(L - 1) (an
    all-zero block keeps scale 0), decoded as code x scale; fp32
    subnormals flush to zero as the wire format defines."""
    shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    flat = F.pad(flat, (0, pad)).reshape(-1, block)
    tiny = torch.finfo(torch.float32).tiny
    flat = torch.where(flat.abs() < tiny, flat * 0, flat)
    top = 2 ** (bits - 1) - 1
    scale = flat.abs().amax(dim=1, keepdim=True) * (1.0 / top)
    scale = torch.where(scale.abs() < tiny, scale * 0, scale)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(flat / safe), -top, top)
    out = (codes * scale).reshape(-1)
    return out[:x.numel()].reshape(shape)
