"""Plain PyTorch versions of the kernels (the correctness reference).

The masked-sum versions (``masked_sum_ref`` on limbs,
``masked_sum_u64_ref`` on uint64 bits) are integer arithmetic and exact
by construction; the flash-attention version
(``flash_attention_ref``) is the naive O(S^2) fp32 oracle of
``repro.kernels.ref.flash_attention_ref``, held to the kernel within a
stated tolerance. The AdamW step (``adamw_update_ref``, with the
arithmetic ``optim.optimizers`` builds on) is the optimizer's own, eager
op for op, which ``csrc/optim_kernels.cu`` repeats bit for bit. The
quantizers' notes follow.

Each function repeats the arithmetic of its twin in ``repro.kernels.ref``
and of the CUDA kernel in ``csrc/wire_kernels.cu`` operation for
operation, so the three agree bit for bit: the scale is a multiply by the
fp32 reciprocal ``float32(1/(L-1))``, never a division; the division
``x / safe`` is a correctly rounded fp32 division; ``torch.round`` rounds
half to even like ``jnp.rint``.

They also follow XLA on values no healthy delta holds. XLA flushes fp32
subnormals to zero, inputs and results alike (on the CPU as on the TPU),
so the quantizers flush each subnormal input to a zero of its sign
before the absmax, the division and the top-k magnitudes, and flush a
subnormal scale (``flush_subnormals``). A NaN propagates through the
absmax, so a block holding one gets scale NaN; its NaN codes are 0 (the
reference's cast), and the top-k rank never counts a NaN ahead of
another value, so every NaN is kept on top of k.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

_TINY = torch.finfo(torch.float32).tiny

#: rows of the pairwise top-k rank computed at once (bounds the
#: (rows, block, block) comparison tensor to 32 Mi elements at block 256)
_TOPK_ROWS_PER_CHUNK = 512


def inv_levels(bits: int) -> float:
    """fp32 ``1/(L-1)`` with ``L = 2^(bits-1)``, as a Python float that is
    exactly the fp32 value (what the kernels multiply by)."""
    L = 2 ** (bits - 1)
    return float(np.float32(1.0 / (L - 1)))


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """fp32 subnormals -> zeros of the same sign (XLA's flush); every
    other value, NaN and inf included, as it is."""
    return torch.where(x.abs() < _TINY, x * 0, x)


def quantize_blocks_ref(x2d: torch.Tensor, bits: int):
    """x2d: (n_blocks, block) fp -> (codes int8, scales fp32).

    Zero-preserving mid-tread quantizer: scale = absmax * f32(1/(L-1));
    code = clip(rint(x / safe), -(L-1), L-1), safe = scale or 1 for an
    all-zero row (or a NaN scale); subnormal inputs and scales flush to
    zero, and a NaN code is 0."""
    L = 2 ** (bits - 1)
    x = flush_subnormals(x2d.to(torch.float32))
    absmax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    scale = flush_subnormals(absmax * inv_levels(bits))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(x / safe), -(L - 1), L - 1)
    # the cast of a NaN to an integer is left undefined by C++: make the
    # reference's 0 explicit
    codes = torch.nan_to_num(codes, nan=0.0)
    return codes.to(torch.int8), scale[:, 0]


def dequantize_blocks_ref(codes: torch.Tensor, scales: torch.Tensor):
    # code 0 -> exactly 0.0; all-zero blocks (scale 0) stay zero for free
    return codes.to(torch.float32) * scales[:, None]


def topk_mask_ref(absx: torch.Tensor, k: int) -> torch.Tensor:
    """absx: (n_blocks, block) -> bool mask keeping exactly ``k`` per row:
    rank_i = #{j: a_j > a_i} + #{j < i: a_j == a_i}; keep rank < k."""
    rows, block = absx.shape
    if k >= block:
        return torch.ones((rows, block), dtype=torch.bool, device=absx.device)
    idx = torch.arange(block, device=absx.device)
    lower = idx[None, :] < idx[:, None]                 # (i, j): j < i
    out = []
    for r0 in range(0, rows, _TOPK_ROWS_PER_CHUNK):
        a = absx[r0:r0 + _TOPK_ROWS_PER_CHUNK]
        a_i = a[:, :, None]
        a_j = a[:, None, :]
        ahead = (a_j > a_i) | ((a_j == a_i) & lower[None])
        out.append(ahead.sum(dim=2) < k)
    if not out:
        return torch.zeros((0, block), dtype=torch.bool, device=absx.device)
    return torch.cat(out, dim=0)


def quantize_topk_blocks_ref(x2d: torch.Tensor, bits: int, k: int):
    """Fused quantize + per-block top-k: (n_blocks, block) fp ->
    (codes int8, scales f32, mask int8). The scale is the dense absmax;
    dropped coordinates get code 0. Subnormal magnitudes tie with zero;
    a NaN is never ranked ahead of another value and is always kept."""
    x = flush_subnormals(x2d.to(torch.float32))
    codes, scales = quantize_blocks_ref(x, bits)
    keep = topk_mask_ref(torch.abs(x), k)
    codes = torch.where(keep, codes, torch.zeros_like(codes))
    return codes, scales, keep.to(torch.int8)


def quantize_dequantize_ref(x: torch.Tensor, bits: int, block: int = 256,
                            topk: Optional[int] = None) -> torch.Tensor:
    """Arbitrary-shape tensor -> wire round trip, same shape and dtype."""
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    if topk is not None and topk < block:
        codes, scales, _ = quantize_topk_blocks_ref(blocks, bits, topk)
    else:
        codes, scales = quantize_blocks_ref(blocks, bits)
    deq = dequantize_blocks_ref(codes, scales)
    return deq.reshape(-1)[:n].reshape(shape).to(dtype)


#: column sums of 16-bit digits stay exact in uint32 up to this many
#: clients per fold (sum <= C * 0xffff < 2^32): the reference's guard,
#: kept so both packages refuse the same cohorts
MASKED_SUM_MAX_CLIENTS = 1 << 16

_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF


def _limbs_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 limbs (or an int32 view of them) -> int64 holding the same
    32-bit patterns, since torch on the CPU has no uint32 arithmetic."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    elif x.dtype != torch.int32:
        raise ValueError(f"limbs must be uint32 or int32, got {x.dtype}")
    return x.to(torch.int64) & _MASK32


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> uint32 with the same bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32).view(
        torch.uint32)


def _fold_digits(h: torch.Tensor, l_: torch.Tensor):
    """(C, n) int64 limbs in [0, 2^32) -> ((n,), (n,)) int64 in [0, 2^32),
    the limbs of the column sums mod 2^64: the reference's radix-2^16
    digit sums (each below C * 2^16, exact in int64) and ripple carry."""
    s0 = torch.sum(l_ & _MASK16, dim=0)
    s1 = torch.sum(l_ >> 16, dim=0)
    s2 = torch.sum(h & _MASK16, dim=0)
    s3 = torch.sum(h >> 16, dim=0)
    d0 = s0 & _MASK16
    t1 = s1 + (s0 >> 16)
    d1 = t1 & _MASK16
    t2 = s2 + (t1 >> 16)
    d2 = t2 & _MASK16
    t3 = s3 + (t2 >> 16)          # carry past bit 64 drops: mod 2^64
    d3 = t3 & _MASK16
    return d2 | (d3 << 16), d0 | (d1 << 16)


def _check_clients(c: int) -> None:
    if c > MASKED_SUM_MAX_CLIENTS:
        raise ValueError(f"at most {MASKED_SUM_MAX_CLIENTS} clients per "
                         f"fold, got {c}")


def masked_sum_ref(hi: torch.Tensor, lo: torch.Tensor):
    """(C, n) uint32 limb pairs -> ((n,), (n,)) uint32, the cohort's sum
    mod 2^64: the reference's radix-2^16 digit sums and ripple carry,
    carried in int64 and masked back to 32 bits at the boundary."""
    if hi.shape != lo.shape or hi.ndim != 2:
        raise ValueError(f"limbs must be two (C, n) tensors of one shape, "
                         f"got {tuple(hi.shape)} and {tuple(lo.shape)}")
    _check_clients(hi.shape[0])
    h32, l32 = _fold_digits(_limbs_i64(hi), _limbs_i64(lo))
    return _u32(h32), _u32(l32)


def masked_sum_u64_ref(vals: torch.Tensor) -> torch.Tensor:
    """(C, n) int64 holding the bits of uint64 values -> (n,) int64 holding
    the bits of their column sums mod 2^64. Exact with no int64 overflow
    anywhere: the values are split into 32-bit limbs (``>> 32`` and
    ``& 0xFFFFFFFF`` of the bit pattern), folded as ``masked_sum_ref``
    folds them, and merged as signed(hi) * 2^32 + lo, which lies in
    int64's range."""
    if vals.dtype != torch.int64 or vals.ndim != 2:
        raise ValueError(f"vals must be a (C, n) int64 tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)}")
    _check_clients(vals.shape[0])
    h32, l32 = _fold_digits((vals >> 32) & _MASK32, vals & _MASK32)
    return torch.where(h32 >= 2 ** 31, h32 - 2 ** 32, h32) * 2 ** 32 + l32


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Sk,KVH,D) -> (B,Sq,H,D) in ``q.dtype``.

    fp32 math; the softcap ``c * tanh(s / c)`` comes before the mask;
    masked scores are -1e30; GQA maps query head ``h`` to kv head
    ``h // (H // KVH)``. Positions count from 0 in both q and k."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, sq, kvh, g, d).to(torch.float32)
    # in place after the first product: at S = 8192 each (B,KVH,G,S,S)
    # fp32 temporary is 4 GiB
    s = torch.einsum("bqkgd,blkd->bkgql", qg, k.to(torch.float32)).mul_(scale)
    if softcap is not None:
        s = s.div_(softcap).tanh_().mul_(softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    w = torch.softmax(s.masked_fill_(~mask, -1e30), dim=-1)
    out = torch.einsum("bkgql,blkd->bqkgd", w, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# AdamW (optim.optimizers.adamw): its arithmetic, and its in-place step a
# piece of a parameter at a time (the twin of the fused CUDA step)
# ---------------------------------------------------------------------------


def adamw_moments(mu: torch.Tensor, nu: torch.Tensor, g: torch.Tensor,
                  b1: float, b2: float, moment_dtype: torch.dtype):
    """The new moments in ``moment_dtype``, computed in fp32."""
    g = g.to(torch.float32)
    return ((b1 * mu.to(torch.float32) + (1 - b1) * g).to(moment_dtype),
            (b2 * nu.to(torch.float32) + (1 - b2) * torch.square(g)
             ).to(moment_dtype))


def adamw_corrections(count: torch.Tensor, b1: float, b2: float):
    """The bias corrections ``1 - b ** count`` in fp32."""
    cf = count.to(torch.float32)
    return 1 - b1 ** cf, 1 - b2 ** cf


def adamw_step(mu: torch.Tensor, nu: torch.Tensor, p: torch.Tensor,
               bc1, bc2, lr: float, eps: float,
               weight_decay: float) -> torch.Tensor:
    """The update of ``p`` from the new moments, in ``p``'s dtype:
    ``-lr * ((mu / bc1) / (sqrt(nu / bc2) + eps) + weight_decay * p)``,
    the decay on matrices (``ndim >= 2``) only."""
    m = mu.to(torch.float32)
    v = nu.to(torch.float32)
    step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    if weight_decay and p.ndim >= 2:   # decay matrices only
        step = step + weight_decay * p.to(torch.float32)
    return (-lr * step).to(p.dtype)


def pieces(t: torch.Tensor, size: int):
    """Index ranges along dim 0 of at most ~``size`` elements (the whole
    tensor when it is 0-dim)."""
    if t.ndim == 0:
        yield ...
        return
    rows = max(1, size // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


def update_pieces_(grad: torch.Tensor, param: torch.Tensor,
                   mask: Optional[torch.Tensor], piece_update,
                   size: int) -> None:
    """An optimizer's plain in-place step of one parameter, a piece of
    ``size`` elements along dim 0 at a time (``pieces``), so that its
    fp32 temporaries stay small: the mask (0-d, or broadcast against the
    leading dims) multiplies the piece's gradient in its buffer, then
    ``piece_update(rows, g, p)``'s update, which is cast to the
    parameter's dtype and added into it."""
    for rows in pieces(param, size):
        g, p = grad[rows], param[rows]
        m = mask if mask is None or mask.ndim == 0 else mask[rows]
        if m is not None:
            g.mul_(m.to(g.dtype))
        u = piece_update(rows, g, p)
        if m is not None:
            u = u * m.to(u.dtype)
        p.add_(u.to(p.dtype))


def adamw_update_ref(grad: torch.Tensor, param: torch.Tensor,
                     mu: torch.Tensor, nu: torch.Tensor,
                     mask: Optional[torch.Tensor], count: torch.Tensor, *,
                     lr: float, b1: float, b2: float, eps: float,
                     weight_decay: float, piece: int) -> None:
    """One AdamW step of one parameter in place, ``update_pieces_``'s
    pieces of eager ops: each piece's moments written into ``mu`` and
    ``nu`` (in their dtype), its bias corrections worked out from the
    state's ``count`` (already advanced), its update added into
    ``param``. The gradient is masked in its own buffer."""
    def piece_update(rows, g, p):
        mu_r, nu_r = mu[rows], nu[rows]
        m, v = adamw_moments(mu_r, nu_r, g, b1, b2, mu.dtype)
        mu_r.copy_(m)
        nu_r.copy_(v)
        return adamw_step(m, v, p, *adamw_corrections(count, b1, b2), lr,
                          eps, weight_decay)

    update_pieces_(grad, param, mask, piece_update, piece)
