"""xLSTM blocks (arXiv:2405.04517) in PyTorch, as ``repro.models.ssm``:
the chunkwise-parallel mLSTM and the sequential sLSTM.

The mLSTM runs the stabilized matrix-memory recurrence

    C_t = f_t C_{t-1} + i_t v_t k_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t q_t) / max(|n_t . q_t|, exp(-m_t))

in chunkwise-parallel form: within a chunk of ``chunk_size`` steps a
quadratic, causally decayed score matrix; across chunks a loop over the
recurrent state (the reference's ``lax.scan``), so memory stays O(S x
chunk). The sLSTM feeds its block-diagonal recurrent weights into the
gates, so it steps once per token (the reference's ``lax.scan``; here a
Python loop, one step per token per layer).

Dtypes follow the reference cast for cast: the projections run in the
parameters' dtype; the gates (``w_i``, ``w_f``, ``b_*`` are fp32
leaves), the recurrent states and the chunk sums are fp32. Decode
updates its cache in place, as the attention caches are.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, dense_init, gelu

# ---------------------------------------------------------------------------
# causal depthwise conv (the width-4 prenet of the recurrent blocks)
# ---------------------------------------------------------------------------


def causal_dwconv(x, w):
    """x: (B, S, D); w: (W, D) depthwise causal conv, the taps added in
    the reference's order."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i]
    return out


def causal_dwconv_step(x_t, conv_state, w):
    """x_t: (B, D); conv_state: (B, W-1, D), oldest to newest -> (out (B,
    D), new state (B, W-1, D)).

    The reference contracts the window in one einsum; here the taps are
    added one at a time in the input's dtype, in ``causal_dwconv``'s
    order, so that a decode step rounds as the full conv does at that
    position. The function is the same; in bf16 the einsum's single
    rounding would part decode from prefill by a rounding of every
    channel each step, which xLSTM's 48 recurrent blocks amplify."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)    # (B,W,D)
    out = torch.zeros_like(x_t)
    for i in range(w.shape[0]):
        out = out + window[:, i] * w[i]
    return out, (window[:, 1:] if w.shape[0] > 1 else conv_state)


def _conv_init(gen, width: int, dim: int, dtype, device):
    return (_normal(gen, (width, dim), device) * 0.1).to(dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_inner(cfg: ModelConfig) -> int:
    """The mLSTM's inner width (its heads are ``inner // num_heads``
    wide, not ``head_dim``)."""
    return int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)


def mlstm_init(gen, cfg: ModelConfig, device):
    xc, d, h = cfg.xlstm, cfg.d_model, cfg.num_heads
    di, dt, f32 = mlstm_inner(cfg), cfg.param_dtype, torch.float32
    return {
        "w_up": dense_init(gen, d, 2 * di, dt, device),
        "conv_w": _conv_init(gen, xc.conv_width, di, dt, device),
        "wq": dense_init(gen, di, di, dt, device),
        "wk": dense_init(gen, di, di, dt, device),
        "wv": dense_init(gen, di, di, dt, device),
        "w_i": dense_init(gen, di, h, f32, device),
        "b_i": torch.zeros((h,), dtype=f32, device=device),
        "w_f": dense_init(gen, di, h, f32, device),
        # forget bias 3: long memory from the start
        "b_f": torch.full((h,), 3.0, dtype=f32, device=device),
        "skip_scale": torch.ones((di,), dtype=dt, device=device),
        "gn_scale": torch.ones((di,), dtype=dt, device=device),
        "w_down": dense_init(gen, di, d, dt, device),
    }


def _mlstm_gates(p, x_conv):
    """The fp32 log input and log forget gates from the conv branch."""
    xf = x_conv.to(torch.float32)
    li = xf @ p["w_i"] + p["b_i"]
    lf = F.logsigmoid(xf @ p["w_f"] + p["b_f"])
    return li, lf


def _mlstm_heads(p, x_conv, x_up, cfg: ModelConfig):
    """-> q, k (scaled by 1/sqrt(dh) in the compute dtype), v as (B, S,
    H, dh), and the gates li, lf (B, S, H) in fp32."""
    b, s, di = x_conv.shape
    h = cfg.num_heads
    dh = di // h
    q = (x_conv @ p["wq"]).reshape(b, s, h, dh)
    k = (x_conv @ p["wk"]).reshape(b, s, h, dh) / math.sqrt(dh)
    v = (x_up @ p["wv"]).reshape(b, s, h, dh)
    li, lf = _mlstm_gates(p, x_conv)
    return q, k, v, li, lf


def _groupnorm_heads(x, scale, num_heads: int):
    """Per-head group norm over the head dim (population variance, eps
    1e-6) in fp32, times ``scale``; x: (B, S, DI), ``x.dtype`` out."""
    b, s, di = x.shape
    xh = x.reshape(b, s, num_heads, di // num_heads).to(torch.float32)
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, unbiased=False)
    xh = (xh - mu) * torch.rsqrt(var + 1e-6)
    return (xh.reshape(b, s, di) * scale.to(torch.float32)).to(x.dtype)


def _mlstm_chunk(C, n, m, qb, kb, vb, lib, lfb):
    """One chunk of the stabilized mLSTM from state (C, n, m): q, k, v
    (B, L, H, dh), gates (B, L, H) -> (h (B, L, H, dh) in q's dtype, the
    state at the chunk's end)."""
    length = qb.shape[1]
    qf, kf, vf = (t.to(torch.float32) for t in (qb, kb, vb))
    cum = torch.cumsum(lfb, dim=1)                        # inclusive (B,L,H)
    # stabilizer per query position t
    run_max = torch.cummax(lib - cum, dim=1).values       # max_{s<=t}
    m_t = cum + torch.maximum(m[:, None, :], run_max)     # (B,L,H)
    # intra-chunk decay (B,H,L,L): t rows, s columns
    dmat = (cum[:, :, None, :] - cum[:, None, :, :]
            + lib[:, None, :, :]) - m_t[:, :, None, :]
    causal = torch.ones((length, length), dtype=torch.bool,
                        device=qb.device).tril()
    dmat = dmat.permute(0, 3, 1, 2).masked_fill(~causal, -math.inf)
    scores = torch.einsum("blhd,bshd->bhls", qf, kf) * torch.exp(dmat)
    # the incoming state's contribution
    inter_w = torch.exp(cum + m[:, None, :] - m_t)        # (B,L,H)
    h_inter = torch.einsum("blhd,bhde->blhe", qf, C)
    n_inter = torch.einsum("blhd,bhd->blh", qf, n)
    num = (torch.einsum("bhls,bshd->blhd", scores, vf)
           + h_inter * inter_w[..., None])
    den = scores.sum(dim=-1).transpose(1, 2) + n_inter * inter_w
    den = torch.maximum(den.abs(), torch.exp(-m_t))
    h_out = (num / den[..., None]).to(qb.dtype)
    # the state at the chunk's end
    cum_end = cum[:, -1, :]                               # (B,H)
    m_new = cum_end + torch.maximum(m, run_max[:, -1, :])
    w_old = torch.exp(cum_end + m - m_new)                # (B,H)
    w_s = torch.exp(cum_end[:, None] - cum + lib - m_new[:, None])
    C_new = (C * w_old[..., None, None]
             + torch.einsum("blhd,blhe->bhde", w_s[..., None] * kf, vf))
    n_new = n * w_old[..., None] + torch.einsum("blh,blhd->bhd", w_s, kf)
    return h_out, (C_new, n_new, m_new)


def mlstm_chunkwise(q, k, v, li, lf, chunk: int, state=None):
    """The stabilized chunkwise mLSTM.

    q, k, v: (B, S, H, dh); li, lf: (B, S, H) log input / forget gates;
    ``state``: optional (C (B,H,dh,dh), n (B,H,dh), m (B,H)), else the
    empty state (m = -1e30). A sequence that is not a whole number of
    chunks is padded with state-neutral steps (li -1e30, lf 0: i = 0, f
    = 1). -> (h (B, S, H, dh), the final state)."""
    b, s0, nh, dh = q.shape
    length = min(chunk, s0)
    pad = (-s0) % length
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad), value=0.0)
    if state is None:
        f32, dev = torch.float32, q.device
        C = torch.zeros((b, nh, dh, dh), dtype=f32, device=dev)
        n = torch.zeros((b, nh, dh), dtype=f32, device=dev)
        m = torch.full((b, nh), -1e30, dtype=f32, device=dev)
    else:
        C, n, m = state
    outs = []
    for c0 in range(0, s0 + pad, length):
        c = slice(c0, c0 + length)
        h_c, (C, n, m) = _mlstm_chunk(C, n, m, q[:, c], k[:, c], v[:, c],
                                      li[:, c], lf[:, c])
        outs.append(h_c)
    return torch.cat(outs, dim=1)[:, :s0], (C, n, m)


def mlstm_step(q, k, v, li, lf, state):
    """One decode step: q, k, v (B, H, dh); li, lf (B, H) -> (h (B, H,
    dh), new state)."""
    C, n, m = state
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    C = (C * fp[..., None, None]
         + ip[..., None, None] * kf[..., :, None] * vf[..., None, :])
    n = n * fp[..., None] + ip[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n).abs(),
                        torch.exp(-m_new))
    return (num / den[..., None]).to(q.dtype), (C, n, m_new)


def mlstm_apply_full(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D) -> (out (B, S, D), the decode cache {conv, C, n,
    m})."""
    xc = cfg.xlstm
    up = x @ p["w_up"]
    di = up.shape[-1] // 2
    x_up, z_gate = up[..., :di], up[..., di:]
    x_conv = F.silu(causal_dwconv(x_up, p["conv_w"]))
    q, k, v, li, lf = _mlstm_heads(p, x_conv, x_up, cfg)
    h, (C, n, m) = mlstm_chunkwise(q, k, v, li, lf, xc.chunk_size, state)
    h = _groupnorm_heads(h.reshape(x.shape[0], x.shape[1], di),
                         p["gn_scale"], cfg.num_heads)
    h = h + p["skip_scale"] * x_conv
    out = (h * F.silu(z_gate)) @ p["w_down"]
    conv_tail = x_up[:, -(xc.conv_width - 1):].to(cfg.compute_dtype)
    return out, {"conv": conv_tail, "C": C, "n": n, "m": m}


def _store(cache, new) -> None:
    """Write a block's new decode state into its cache in place."""
    for name, t in new.items():
        cache[name].copy_(t)


def mlstm_apply_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, 1, D); ``cache`` {conv, C, n, m} is updated in place and
    returned."""
    b = x.shape[0]
    up = x[:, 0] @ p["w_up"]
    di = up.shape[-1] // 2
    x_up, z_gate = up[..., :di], up[..., di:]
    xc_t, conv_state = causal_dwconv_step(x_up, cache["conv"], p["conv_w"])
    x_conv = F.silu(xc_t)
    h = cfg.num_heads
    dh = di // h
    q = (x_conv @ p["wq"]).reshape(b, h, dh)
    k = (x_conv @ p["wk"]).reshape(b, h, dh) / math.sqrt(dh)
    v = (x_up @ p["wv"]).reshape(b, h, dh)
    li, lf = _mlstm_gates(p, x_conv)
    hv, (C, n, m) = mlstm_step(q, k, v, li, lf,
                               (cache["C"], cache["n"], cache["m"]))
    hv = _groupnorm_heads(hv.reshape(b, 1, di), p["gn_scale"], h)
    hv = hv + p["skip_scale"] * x_conv[:, None]
    out = (hv * F.silu(z_gate)[:, None]) @ p["w_down"]
    _store(cache, {"conv": conv_state, "C": C, "n": n, "m": m})
    return out, cache


def mlstm_cache_init(cfg: ModelConfig, batch: int, device):
    xc, h = cfg.xlstm, cfg.num_heads
    di = mlstm_inner(cfg)
    dh, f32 = di // h, torch.float32
    return {"conv": torch.zeros((batch, xc.conv_width - 1, di),
                                dtype=cfg.compute_dtype, device=device),
            "C": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(gen, cfg: ModelConfig, device):
    d, h, dt, f32 = cfg.d_model, cfg.num_heads, cfg.param_dtype, torch.float32
    dh = d // h
    up = int(cfg.xlstm.proj_factor_slstm * d)
    # input projections of the 4 gates (z, i, f, o), forget bias 3, and
    # the block-diagonal recurrent weights
    b_in = torch.cat([torch.zeros((2 * d,), dtype=f32, device=device),
                      torch.full((d,), 3.0, dtype=f32, device=device),
                      torch.zeros((d,), dtype=f32, device=device)])
    return {
        "w_in": dense_init(gen, d, 4 * d, dt, device),
        "b_in": b_in,
        "r_blocks": (_normal(gen, (4, h, dh, dh), device)
                     / math.sqrt(dh)).to(dt),
        "gn_scale": torch.ones((d,), dtype=dt, device=device),
        "w_up": dense_init(gen, d, up * 2, dt, device),
        "w_down": dense_init(gen, up, d, dt, device),
    }


def _slstm_cell(p, x_gates, hcnm, num_heads: int):
    """One sLSTM step: x_gates (B, 4D), the input part of the gates; the
    recurrent part is added here in fp32 -> the new (h, c, n, m)."""
    h_prev, c_prev, n_prev, m_prev = hcnm
    b, d = h_prev.shape
    hh = h_prev.reshape(b, num_heads, d // num_heads)
    rec = torch.einsum("bhd,ghde->gbhe", hh.to(torch.float32),
                       p["r_blocks"].to(torch.float32)).reshape(4, b, d)
    g = x_gates.to(torch.float32).reshape(b, 4, d).transpose(0, 1) + rec
    z, li, f_raw, o_raw = g[0], g[1], g[2], g[3]
    z = torch.tanh(z)
    o = torch.sigmoid(o_raw)
    lf = F.logsigmoid(f_raw)
    m_new = torch.maximum(lf + m_prev, li)
    ip = torch.exp(li - m_new)
    fp = torch.exp(lf + m_prev - m_new)
    c_new = fp * c_prev + ip * z
    n_new = fp * n_prev + ip
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new, c_new, n_new, m_new


def _slstm_out(p, h, cfg: ModelConfig):
    """Group norm, then the tanh-GELU-gated up / down projection."""
    h = _groupnorm_heads(h, p["gn_scale"], cfg.num_heads)
    up = h @ p["w_up"]
    dff = up.shape[-1] // 2
    return (gelu(up[..., :dff]) * up[..., dff:]) @ p["w_down"]


def slstm_apply_full(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D) -> (out (B, S, D), the final state (h, c, n, m)):
    one cell step per token."""
    b, s, d = x.shape
    x_gates = x @ p["w_in"] + p["b_in"].to(x.dtype)
    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, torch.full((b, d), -1e30,
                                                 dtype=torch.float32,
                                                 device=x.device))
    # the recurrent weights in fp32 once, not once a step
    cell_p = {"r_blocks": p["r_blocks"].to(torch.float32)}
    hs = []
    for t in range(s):
        state = _slstm_cell(cell_p, x_gates[:, t], state, cfg.num_heads)
        hs.append(state[0])
    h = torch.stack(hs, dim=1).to(x.dtype)                   # (B,S,D)
    return _slstm_out(p, h, cfg), state


def slstm_apply_decode(p, x, cache, cfg: ModelConfig):
    """x: (B, 1, D); ``cache`` {h, c, n, m} is updated in place and
    returned."""
    x_gates = x[:, 0] @ p["w_in"] + p["b_in"].to(x.dtype)
    state = _slstm_cell(p, x_gates, (cache["h"], cache["c"], cache["n"],
                                     cache["m"]), cfg.num_heads)
    out = _slstm_out(p, state[0][:, None].to(x.dtype), cfg)
    _store(cache, dict(zip("hcnm", state)))
    return out, cache


def slstm_cache_init(cfg: ModelConfig, batch: int, device):
    def full(value):
        return torch.full((batch, cfg.d_model), value, dtype=torch.float32,
                          device=device)

    return {"h": full(0.0), "c": full(0.0), "n": full(0.0),
            "m": full(-1e30)}
