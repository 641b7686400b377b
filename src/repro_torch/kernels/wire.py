"""CUDA fused quantize + per-block top-k kernel: the sparse wire format.

``quantize_topk_blocks`` launches the kernel of ``csrc/wire_kernels.cu``
that replaces the Pallas kernel of ``repro/kernels/wire.py``: blockwise
mid-tread quantization plus exactly-k magnitude selection per block
(ties to the lower index), emitting ``(codes int8, scales f32, mask
int8)``. Dropped coordinates get code 0, so ``quantize.dequantize_blocks``
serves the sparse format too. CUDA tensors only; ``kernels/ops.py``
dispatches CPU tensors to ``ref.quantize_topk_blocks_ref``.

The masked-sum kernel of ``repro/kernels/wire.py`` is not ported yet.
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
    lib = cuda_lib.load_library()
    with torch.cuda.device(x2d.device):
        err = lib.quantize_topk_blocks_launch(
            x2d.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            mask.data_ptr(), n_blocks, block, bits, inv_levels(bits), k,
            cuda_lib.stream_of(x2d))
    cuda_lib.check_launch(err, "quantize_topk_blocks")
    cuda_lib.LAUNCHES["quantize_topk_blocks"] += 1
    return codes, scales, mask
