"""CUDA blockwise quantization kernels: the wire format of every client
delta at q > 0.

``quantize_blocks`` and ``dequantize_blocks`` launch the kernels of
``csrc/wire_kernels.cu`` (which replace the Pallas kernels of
``repro/kernels/quantize.py``) on CUDA tensors only; the plain versions
are ``kernels/ref.py``'s twins, and ``kernels/ops.py`` dispatches between
the two by the tensor's device. Unlike the TPU kernels there is no
``ROWS_PER_TILE`` padding: any number of rows launches as is. Like the
reference under XLA, the quantizer flushes subnormal inputs and scales
to zero, and a NaN makes its block's scale NaN and takes code 0.
"""
from __future__ import annotations

from typing import Optional

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


#: the kernels' fp32 1/(L-1) by bits (``ref.inv_levels``), computed once
INV = {bits: inv_levels(bits) for bits in (2, 8)}


def _refuse_quantize(x2d, bits) -> None:
    """Raise the fault of ``quantize_blocks``'s inputs (the slow path of
    its check)."""
    cuda_lib.check_cuda_tensor(x2d, torch.float32, 2, "quantize_blocks x2d")
    check_bits(bits)
    check_block(x2d.shape[1])
    raise ValueError(f"quantize_blocks: bits {bits} and x2d "
                     f"{tuple(x2d.shape)} on {x2d.device}")


def quantize_blocks(x2d: torch.Tensor, bits: int):
    """x2d: (n_blocks, block) f32 CUDA -> (codes int8, scales f32). Rows
    of a multiple of 128 values on a 16-byte aligned base take the
    warp-per-block kernel, any other the CTA-per-row one."""
    index = x2d.get_device()
    shape = x2d.shape
    if (index < 0 or x2d.dtype != torch.float32 or len(shape) != 2
            or not x2d.is_contiguous() or not 0 < shape[1] <= MAX_BLOCK
            or bits not in INV):
        _refuse_quantize(x2d, bits)
    n_blocks, block = shape
    codes = torch.empty_like(x2d, dtype=torch.int8)
    scales = x2d.new_empty(n_blocks)
    if n_blocks == 0:
        return codes, scales
    err = cuda_lib.launch_on(index, "quantize_blocks_launch", x2d.data_ptr(),
                             codes.data_ptr(), scales.data_ptr(), n_blocks,
                             block, bits, INV[bits])
    cuda_lib.check_launch(err, "quantize_blocks")
    cuda_lib.LAUNCHES["quantize_blocks"] += 1
    return codes, scales


def _refuse_dequantize(codes, scales) -> None:
    """Raise the fault of ``dequantize_blocks``'s inputs (the slow path
    of its check)."""
    cuda_lib.check_cuda_tensor(codes, torch.int8, 2, "dequantize_blocks codes")
    cuda_lib.check_cuda_tensor(scales, torch.float32, 1,
                               "dequantize_blocks scales")
    check_block(codes.shape[1])
    raise ValueError(f"scales {tuple(scales.shape)} on {scales.device} "
                     f"do not match codes {tuple(codes.shape)} on "
                     f"{codes.device}")


def dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor,
                      out: Optional[torch.Tensor] = None):
    """codes (n_blocks, block) int8, scales (n_blocks,) f32, both CUDA ->
    (n_blocks, block) f32 (code 0 -> exactly 0.0), written into ``out``
    when given (contiguous f32 of the codes' shape on the same card). One
    launch decodes any number of blocks: a whole client delta staged by
    ``core.compression.compress_decompress``."""
    index = codes.get_device()
    shape = codes.shape
    if (index < 0 or codes.dtype != torch.int8 or len(shape) != 2
            or not codes.is_contiguous() or scales.get_device() != index
            or scales.dtype != torch.float32 or scales.shape != shape[:1]
            or not scales.is_contiguous() or not 0 < shape[1] <= MAX_BLOCK):
        _refuse_dequantize(codes, scales)
    if out is None:
        out = torch.empty_like(codes, dtype=torch.float32)
    elif (out.get_device() != index or out.dtype != torch.float32
          or out.shape != shape or not out.is_contiguous()):
        cuda_lib.check_cuda_tensor(out, torch.float32, 2,
                                   "dequantize_blocks out")
        raise ValueError(f"out {tuple(out.shape)} on {out.device} does "
                         f"not match codes {tuple(shape)} on {codes.device}")
    n_blocks, block = shape
    if n_blocks == 0:
        return out
    err = cuda_lib.launch_on(index, "dequantize_blocks_launch",
                             codes.data_ptr(), scales.data_ptr(),
                             out.data_ptr(), n_blocks, block)
    cuda_lib.check_launch(err, "dequantize_blocks")
    cuda_lib.LAUNCHES["dequantize_blocks"] += 1
    return out
