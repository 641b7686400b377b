"""CUDA wire kernels of ``repro/kernels/wire.py``: the fused quantize +
per-block top-k kernel (the sparse wire format) and the masked-sum cohort
fold.

``quantize_topk_blocks`` launches the kernel of ``csrc/wire_kernels.cu``
that replaces the Pallas kernel of ``repro/kernels/wire.py``: blockwise
mid-tread quantization plus exactly-k magnitude selection per block
(ties to the lower index), emitting ``(codes int8, scales f32, mask
int8)``. Dropped coordinates get code 0, so ``quantize.dequantize_blocks``
serves the sparse format too. CUDA tensors only; ``kernels/ops.py``
dispatches CPU tensors to ``ref.quantize_topk_blocks_ref``.

``masked_sum_limbs`` sums a cohort's (C, n) uint64 values, carried as
(hi, lo) uint32 limbs, mod 2^64 (``MaskedSumAggregator``'s fold). Hopper
adds 64-bit integers natively, so the kernel adds in uint64 where the TPU
kernel needed radix-2^16 digits; ``ops.masked_sum`` dispatches CPU
tensors to ``ref.masked_sum_ref`` and keeps the cohort-size guard.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.quantize import (check_bits, check_block,
                                          dequantize_blocks)  # noqa: F401
from repro_torch.kernels.ref import inv_levels


def quantize_topk_blocks(x2d: torch.Tensor, bits: int, k: int):
    """x2d: (n_blocks, block) f32 CUDA, 0 < k < block ->
    (codes int8, scales f32, mask int8)."""
    cuda_lib.check_cuda_tensor(x2d, torch.float32, 2,
                               "quantize_topk_blocks x2d")
    check_bits(bits)
    n_blocks, block = x2d.shape
    check_block(block)
    if not 0 < k < block:
        raise ValueError(f"k must be in 1..{block - 1}, got {k}")
    codes = torch.empty((n_blocks, block), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=x2d.device)
    mask = torch.empty((n_blocks, block), dtype=torch.int8, device=x2d.device)
    if n_blocks == 0:
        return codes, scales, mask
    err = cuda_lib.launch_on(
        x2d.get_device(), "quantize_topk_blocks_launch", x2d.data_ptr(),
        codes.data_ptr(), scales.data_ptr(), mask.data_ptr(), n_blocks,
        block, bits, inv_levels(bits), k)
    cuda_lib.check_launch(err, "quantize_topk_blocks")
    cuda_lib.LAUNCHES["quantize_topk_blocks"] += 1
    return codes, scales, mask


_LIMB_DTYPES = (torch.uint32, torch.int32)


def masked_sum_limbs(hi: torch.Tensor, lo: torch.Tensor):
    """(C, n) uint32 limbs on the card (or int32 views of them) ->
    ((n,), (n,)) limbs of the column sums mod 2^64, in the inputs' dtype."""
    for t, what in ((hi, "hi"), (lo, "lo")):
        if t.dtype not in _LIMB_DTYPES:
            raise ValueError(f"masked_sum_limbs {what}: expected uint32 or "
                             f"int32, got {t.dtype}")
        cuda_lib.check_cuda_tensor(t, t.dtype, 2, f"masked_sum_limbs {what}")
    if hi.shape != lo.shape or hi.dtype != lo.dtype or hi.device != lo.device:
        raise ValueError(f"masked_sum_limbs: hi {tuple(hi.shape)} {hi.dtype} "
                         f"on {hi.device} does not match lo {tuple(lo.shape)} "
                         f"{lo.dtype} on {lo.device}")
    rows, n = hi.shape
    hi_out = torch.empty((n,), dtype=hi.dtype, device=hi.device)
    lo_out = torch.empty((n,), dtype=hi.dtype, device=hi.device)
    if n == 0:
        return hi_out, lo_out
    err = cuda_lib.launch_on(
        hi.get_device(), "masked_sum_limbs_launch", hi.data_ptr(),
        lo.data_ptr(), hi_out.data_ptr(), lo_out.data_ptr(), rows, n)
    cuda_lib.check_launch(err, "masked_sum_limbs")
    cuda_lib.LAUNCHES["masked_sum_limbs"] += 1
    return hi_out, lo_out
