"""CUDA wire kernels of ``repro/kernels/wire.py``: the fused quantize +
per-block top-k kernel (the sparse wire format) and the masked-sum cohort
fold.

``quantize_topk_blocks`` launches the kernel of ``csrc/wire_kernels.cu``
that replaces the Pallas kernel of ``repro/kernels/wire.py``: blockwise
mid-tread quantization plus exactly-k magnitude selection per block
(ties to the lower index), emitting ``(codes int8, scales f32, mask
int8)``. Dropped coordinates get code 0, so ``quantize.dequantize_blocks``
serves the sparse format too. Rows of a multiple of 128 values on a
16-byte aligned base take one warp per block, which finds the k-th
largest magnitude's bit pattern MSB first (one warp-wide count a bit)
and ranks the ties at it in index order; any other row takes one CTA
and the pairwise rank. Both follow the reference on values no healthy
delta holds: subnormals flush to zero (so they tie with zeros), a NaN
makes its block's scale NaN, gets code 0 and is kept on top of k (it is
never ranked ahead of another value). CUDA tensors only;
``kernels/ops.py`` dispatches CPU tensors to
``ref.quantize_topk_blocks_ref``.

``masked_sum_u64`` sums a cohort's (C, n) uint64 values mod 2^64 (the
fold of ``MaskedSumAggregator``, through ``ops.masked_sum_u64``): the
values travel as the int64 tensor of their bits and are added in uint64
on the card, where the TPU kernel needed (hi, lo) uint32 limbs and
radix-2^16 digits. ``masked_sum_limbs`` takes those limbs, for callers
of the TPU function's contract (``ops.masked_sum``); it adds in uint64
too. ``ops`` dispatches CPU tensors to the plain versions in ``ref`` and
keeps the cohort-size guard.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.quantize import (INV, MAX_BLOCK, check_bits,
                                          check_block,
                                          dequantize_blocks)  # noqa: F401


def _refuse_topk(x2d, bits, k) -> None:
    """Raise the fault of ``quantize_topk_blocks``'s inputs (the slow path
    of its check)."""
    cuda_lib.check_cuda_tensor(x2d, torch.float32, 2,
                               "quantize_topk_blocks x2d")
    check_bits(bits)
    check_block(x2d.shape[1])
    raise ValueError(f"k must be in 1..{x2d.shape[1] - 1}, got {k}")


def quantize_topk_blocks(x2d: torch.Tensor, bits: int, k: int):
    """x2d: (n_blocks, block) f32 CUDA, 0 < k < block ->
    (codes int8, scales f32, mask int8). Rows of a multiple of 128 values
    on a 16-byte aligned base take the warp-per-block kernel, any other
    the CTA-per-row one (``cuda_lib.TOPK_VARIANTS`` counts each)."""
    index = x2d.get_device()
    shape = x2d.shape
    if (index < 0 or x2d.dtype != torch.float32 or len(shape) != 2
            or not x2d.is_contiguous() or not 0 < shape[1] <= MAX_BLOCK
            or bits not in INV or not 0 < k < shape[1]):
        _refuse_topk(x2d, bits, k)
    n_blocks, block = shape
    codes = torch.empty_like(x2d, dtype=torch.int8)
    scales = x2d.new_empty(n_blocks)
    mask = torch.empty_like(codes)
    if n_blocks == 0:
        return codes, scales, mask
    ptr = x2d.data_ptr()
    warp = block % 128 == 0 and ptr % 16 == 0
    err = cuda_lib.launch_on(index, "quantize_topk_blocks_launch", ptr,
                             codes.data_ptr(), scales.data_ptr(),
                             mask.data_ptr(), n_blocks, block, bits,
                             INV[bits], k, warp)
    cuda_lib.check_launch(err, "quantize_topk_blocks")
    cuda_lib.LAUNCHES["quantize_topk_blocks"] += 1
    cuda_lib.TOPK_VARIANTS["warp" if warp else "cta"] += 1
    return codes, scales, mask


_LIMB_DTYPES = (torch.uint32, torch.int32)


def _refuse_limbs(hi, lo) -> None:
    """Raise the fault of ``masked_sum_limbs``'s inputs (the slow path of
    its check)."""
    for t, what in ((hi, "hi"), (lo, "lo")):
        if t.dtype not in _LIMB_DTYPES:
            raise ValueError(f"masked_sum_limbs {what}: expected uint32 or "
                             f"int32, got {t.dtype}")
        cuda_lib.check_cuda_tensor(t, t.dtype, 2, f"masked_sum_limbs {what}")
    raise ValueError(f"masked_sum_limbs: hi {tuple(hi.shape)} {hi.dtype} "
                     f"on {hi.device} does not match lo {tuple(lo.shape)} "
                     f"{lo.dtype} on {lo.device}")


def masked_sum_limbs(hi: torch.Tensor, lo: torch.Tensor):
    """(C, n) uint32 limbs on the card (or int32 views of them) ->
    ((n,), (n,)) limbs of the column sums mod 2^64, in the inputs' dtype."""
    index = hi.get_device()
    if (index < 0 or hi.dtype not in _LIMB_DTYPES or hi.dim() != 2
            or not hi.is_contiguous() or lo.get_device() != index
            or lo.dtype != hi.dtype or lo.shape != hi.shape
            or not lo.is_contiguous()):
        _refuse_limbs(hi, lo)
    rows, n = hi.shape
    hi_out = hi.new_empty(n)
    lo_out = hi.new_empty(n)
    if n == 0:
        return hi_out, lo_out
    err = cuda_lib.launch_on(index, "masked_sum_limbs_launch", hi.data_ptr(),
                             lo.data_ptr(), hi_out.data_ptr(),
                             lo_out.data_ptr(), rows, n)
    cuda_lib.check_launch(err, "masked_sum_limbs")
    cuda_lib.LAUNCHES["masked_sum_limbs"] += 1
    return hi_out, lo_out


def _refuse_u64(vals) -> None:
    """Raise the fault of ``masked_sum_u64``'s input (the slow path of its
    check): the type, then the layout, then the device."""
    if vals.dtype != torch.int64:
        raise ValueError(f"masked_sum_u64 vals: expected torch.int64 (the "
                         f"bits of uint64 values), got {vals.dtype}")
    if vals.dim() != 2:
        raise ValueError(f"masked_sum_u64 vals: expected (C, n), got shape "
                         f"{tuple(vals.shape)}")
    if not vals.is_contiguous():
        raise ValueError("masked_sum_u64 vals: expected a contiguous tensor")
    raise ValueError(f"masked_sum_u64 vals: expected a CUDA tensor, got "
                     f"{vals.device}")


def masked_sum_u64(vals: torch.Tensor) -> torch.Tensor:
    """(C, n) int64 on the card, the bits of uint64 values -> (n,) int64,
    the bits of their column sums mod 2^64."""
    index = vals.get_device()
    if (index < 0 or vals.dtype != torch.int64 or vals.dim() != 2
            or not vals.is_contiguous()):
        _refuse_u64(vals)
    rows, n = vals.shape
    out = vals.new_empty(n)
    if n == 0:
        return out
    err = cuda_lib.launch_on(index, "masked_sum_u64_launch", vals.data_ptr(),
                             out.data_ptr(), rows, n)
    cuda_lib.check_launch(err, "masked_sum_u64")
    cuda_lib.LAUNCHES["masked_sum_u64"] += 1
    return out
