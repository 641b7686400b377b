"""CUDA blockwise quantization kernels: the wire format of every client
delta at q > 0.

``quantize_blocks`` and ``dequantize_blocks`` launch the kernels of
``csrc/wire_kernels.cu`` (which replace the Pallas kernels of
``repro/kernels/quantize.py``) on CUDA tensors only; the plain versions
are ``kernels/ref.py``'s twins, and ``kernels/ops.py`` dispatches between
the two by the tensor's device. Unlike the TPU kernels there is no
``ROWS_PER_TILE`` padding: any number of rows launches as is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import inv_levels

#: widest row the kernels take (one thread per value of a row)
MAX_BLOCK = 1024


def check_block(block: int) -> None:
    if not 0 < block <= MAX_BLOCK:
        raise ValueError(f"block must be in 1..{MAX_BLOCK}, got {block}")


def check_bits(bits: int) -> None:
    if bits not in (2, 8):
        raise ValueError(f"bits must be 8 or 2, got {bits}")


def quantize_blocks(x2d: torch.Tensor, bits: int):
    """x2d: (n_blocks, block) f32 CUDA -> (codes int8, scales f32)."""
    cuda_lib.check_cuda_tensor(x2d, torch.float32, 2, "quantize_blocks x2d")
    check_bits(bits)
    n_blocks, block = x2d.shape
    check_block(block)
    codes = torch.empty((n_blocks, block), dtype=torch.int8, device=x2d.device)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=x2d.device)
    if n_blocks == 0:
        return codes, scales
    lib = cuda_lib.load_library()
    with torch.cuda.device(x2d.device):
        err = lib.quantize_blocks_launch(
            x2d.data_ptr(), codes.data_ptr(), scales.data_ptr(), n_blocks,
            block, bits, inv_levels(bits), cuda_lib.stream_of(x2d))
    cuda_lib.check_launch(err, "quantize_blocks")
    cuda_lib.LAUNCHES["quantize_blocks"] += 1
    return codes, scales


def dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor):
    """codes (n_blocks, block) int8, scales (n_blocks,) f32, both CUDA ->
    (n_blocks, block) f32 (code 0 -> exactly 0.0)."""
    cuda_lib.check_cuda_tensor(codes, torch.int8, 2, "dequantize_blocks codes")
    cuda_lib.check_cuda_tensor(scales, torch.float32, 1,
                               "dequantize_blocks scales")
    n_blocks, block = codes.shape
    check_block(block)
    if scales.shape[0] != n_blocks or scales.device != codes.device:
        raise ValueError(f"scales {tuple(scales.shape)} on {scales.device} "
                         f"do not match codes {tuple(codes.shape)} on "
                         f"{codes.device}")
    out = torch.empty((n_blocks, block), dtype=torch.float32,
                      device=codes.device)
    if n_blocks == 0:
        return out
    lib = cuda_lib.load_library()
    with torch.cuda.device(codes.device):
        err = lib.dequantize_blocks_launch(
            codes.data_ptr(), scales.data_ptr(), out.data_ptr(), n_blocks,
            block, cuda_lib.stream_of(codes))
    cuda_lib.check_launch(err, "dequantize_blocks")
    cuda_lib.LAUNCHES["dequantize_blocks"] += 1
    return out
