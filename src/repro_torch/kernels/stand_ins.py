"""Opaque stand-ins of the CUDA kernels, for traces on fake tensors.

A trace on fake tensors (``launch.dryrun``, ``analysis.trace``) cannot
launch a kernel: the wrappers of ``kernels/quantize.py``, ``wire.py`` and
``flash_attention.py`` pass data pointers to the library. Each kernel
therefore has a ``torch.library.custom_op`` here whose fake
implementation gives the kernel's outputs (shapes and dtypes, nothing
else), so a trace records it as one aten-level node, as the card runs it
as one launch: no twin's temporaries (the top-k twin's pairwise ranks,
the CPU folds' int64 limbs) enter the trace. Called on real tensors an
op raises.

``kernel_stand_ins()`` swaps the wrappers that ``kernels/ops.py`` calls
for these ops while a trace runs, and makes ``ops`` take a ``meta``
tensor for one on the card: a trace runs on fake ``meta`` tensors,
because a CPU-only torch cannot run autograd or indexing on fake CUDA
tensors (both ask for CUDA's device guard), and the port branches on
the device only in ``ops``. ``STAND_IN_FLOPS`` prices each op for
``analysis.trace.cost``: the flash op by the products its mask admits
(``flash_flops``), the folds as reductions over their inputs, the
quantizers by their outputs' elements.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import wire as wk

Tensor = torch.Tensor


def _fake_only(*_args, **_kw):
    raise RuntimeError("a kernel stand-in runs on fake tensors only")


@torch.library.custom_op("repro_torch::quantize_blocks", mutates_args=())
def quantize_blocks(x2d: Tensor, bits: int) -> Tuple[Tensor, Tensor]:
    """The quantizer: (n_blocks, block) f32 -> codes int8, scales f32."""
    _fake_only()


@quantize_blocks.register_fake
def _(x2d, bits):
    return (torch.empty_like(x2d, dtype=torch.int8),
            x2d.new_empty(x2d.shape[:1]))


@torch.library.custom_op("repro_torch::dequantize_blocks", mutates_args=())
def dequantize_blocks(codes: Tensor, scales: Tensor) -> Tensor:
    """The dequantizer into a new f32 tensor of the codes' shape."""
    _fake_only()


@dequantize_blocks.register_fake
def _(codes, scales):
    return torch.empty_like(codes, dtype=torch.float32)


@torch.library.custom_op("repro_torch::dequantize_blocks_into",
                         mutates_args=("out",))
def dequantize_blocks_into(codes: Tensor, scales: Tensor, out: Tensor) -> None:
    """The dequantizer writing into ``out`` (``compress_decompress``
    decodes into the staged buffer)."""
    _fake_only()


@dequantize_blocks_into.register_fake
def _(codes, scales, out):
    return None


@torch.library.custom_op("repro_torch::quantize_topk_blocks", mutates_args=())
def quantize_topk_blocks(x2d: Tensor, bits: int,
                         k: int) -> Tuple[Tensor, Tensor, Tensor]:
    """The top-k quantizer: -> codes int8, scales f32, mask int8."""
    _fake_only()


@quantize_topk_blocks.register_fake
def _(x2d, bits, k):
    return (torch.empty_like(x2d, dtype=torch.int8),
            x2d.new_empty(x2d.shape[:1]),
            torch.empty_like(x2d, dtype=torch.int8))


@torch.library.custom_op("repro_torch::masked_sum_u64", mutates_args=())
def masked_sum_u64(vals: Tensor) -> Tensor:
    """The uint64 fold: (C, n) int64 bits -> (n,) int64 bits."""
    _fake_only()


@masked_sum_u64.register_fake
def _(vals):
    return vals.new_empty(vals.shape[1:])


@torch.library.custom_op("repro_torch::masked_sum_limbs", mutates_args=())
def masked_sum_limbs(hi: Tensor, lo: Tensor) -> Tuple[Tensor, Tensor]:
    """The limb fold: (C, n) x 2 -> (n,) x 2 in the inputs' dtype."""
    _fake_only()


@masked_sum_limbs.register_fake
def _(hi, lo):
    return hi.new_empty(hi.shape[1:]), lo.new_empty(lo.shape[1:])


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    window: Optional[int]) -> Tensor:
    """The flash kernel: an opaque op with its output's shape
    (B, Sq, H, Dv) and no workspace, as the kernel holds its tiles on
    chip; the plain twin would hold the (Sq, Sk) scores."""
    _fake_only()


@flash_attention.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(tuple(q.shape[:-1]) + (v.shape[-1],))


def attended_pairs(sq: int, sk: int, causal: bool,
                   window: Optional[int]) -> int:
    """(query, key) pairs the flash kernel's mask admits: every pair
    without ``causal``; else query i (top-left aligned) sees keys
    max(0, i - window + 1) .. i."""
    if not causal:
        return sq * sk
    seen = np.minimum(np.arange(1, sq + 1), sk)
    if window is not None:
        seen = np.minimum(seen, window)
    return int(seen.sum())


def flash_flops(q_shape, k_shape, v_shape, causal, window, out_shape=None):
    """The flash kernel's products: 2 (Dq + Dv) per admitted pair and
    head (the signature ``FlopCounterMode``'s custom mapping calls)."""
    b, sq, h, dq = q_shape
    return 2 * b * h * attended_pairs(sq, k_shape[1], causal, window) * (
        dq + v_shape[-1])


def _numel(t) -> int:
    return int(math.prod(t.shape)) if isinstance(t, Tensor) else 0


def _outputs(out) -> int:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(_numel(t) for t in outs)


#: each stand-in's operations from its (fake) arguments and outputs
STAND_IN_FLOPS: Dict[object, Callable[..., int]] = {
    torch.ops.repro_torch.quantize_blocks: lambda args, out: _outputs(out),
    torch.ops.repro_torch.dequantize_blocks: lambda args, out: _outputs(out),
    torch.ops.repro_torch.dequantize_blocks_into:
        lambda args, out: _numel(args[2]),
    torch.ops.repro_torch.quantize_topk_blocks:
        lambda args, out: _outputs(out),
    torch.ops.repro_torch.masked_sum_u64: lambda args, out: _numel(args[0]),
    torch.ops.repro_torch.masked_sum_limbs:
        lambda args, out: _numel(args[0]) + _numel(args[1]),
    torch.ops.repro_torch.flash_attention:
        lambda args, out: flash_flops(*(a.shape for a in args[:3]),
                                      *args[3:5]),
}


def _dequantize(codes, scales, out=None):
    if out is None:
        return dequantize_blocks(codes, scales)
    dequantize_blocks_into(codes, scales, out)
    return out


def _flash(q, k, v, *, causal=True, window=None, softcap=None, scale=None):
    return flash_attention(q, k, v, causal, window)


_on_card = ops._on_card


def _meta_on_card(x: Tensor) -> bool:
    return x.device.type == "meta" or _on_card(x)


_SWAPS = ((ops, "_on_card", _meta_on_card),
          (qk, "quantize_blocks", quantize_blocks),
          (qk, "dequantize_blocks", _dequantize),
          (wk, "quantize_topk_blocks", quantize_topk_blocks),
          (wk, "masked_sum_u64", masked_sum_u64),
          (wk, "masked_sum_limbs", masked_sum_limbs),
          (fak, "flash_attention_bshd", _flash))


@contextlib.contextmanager
def kernel_stand_ins() -> Iterator[None]:
    """While open, ``kernels/ops.py`` sends CUDA and ``meta`` tensors to
    the stand-ins (the wrappers are restored on exit, also on error)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _SWAPS]
    try:
        for mod, name, fn in _SWAPS:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
