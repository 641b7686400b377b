"""Plain PyTorch versions of the wire kernels (the correctness reference).

Each function repeats the arithmetic of its twin in ``repro.kernels.ref``
and of the CUDA kernel in ``csrc/wire_kernels.cu`` operation for
operation, so the three agree bit for bit: the scale is a multiply by the
fp32 reciprocal ``float32(1/(L-1))``, never a division; the division
``x / safe`` is a correctly rounded fp32 division; ``torch.round`` rounds
half to even like ``jnp.rint``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: rows of the pairwise top-k rank computed at once (bounds the
#: (rows, block, block) comparison tensor to 32 Mi elements at block 256)
_TOPK_ROWS_PER_CHUNK = 512


def inv_levels(bits: int) -> float:
    """fp32 ``1/(L-1)`` with ``L = 2^(bits-1)``, as a Python float that is
    exactly the fp32 value (what the kernels multiply by)."""
    L = 2 ** (bits - 1)
    return float(np.float32(1.0 / (L - 1)))


def quantize_blocks_ref(x2d: torch.Tensor, bits: int):
    """x2d: (n_blocks, block) fp -> (codes int8, scales fp32).

    Zero-preserving mid-tread quantizer: scale = absmax * f32(1/(L-1));
    code = clip(rint(x / safe), -(L-1), L-1), safe = scale or 1 for an
    all-zero row."""
    L = 2 ** (bits - 1)
    x = x2d.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    scale = absmax * inv_levels(bits)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    codes = torch.clamp(torch.round(x / safe), -(L - 1), L - 1)
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
    dropped coordinates get code 0."""
    x = x2d.to(torch.float32)
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
