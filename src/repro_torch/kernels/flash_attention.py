"""CUDA flash attention: the forward attention of every no-grad path
(Gemma2 prefill, the char-LM eval).

``flash_attention_bhsd`` launches the kernel of
``csrc/flash_attention.cu``, which replaces the Pallas kernel of
``repro/kernels/flash_attention.py``: causal / sliding-window / tanh
softcap, GQA, fp32 online softmax, f32 or bf16 in and the input's dtype
out. CUDA tensors only; ``kernels/ops.py`` dispatches CPU tensors to
``ref.flash_attention_ref``. The kernel addresses each tensor through
its strides (the last dim contiguous), so ``ops.flash_attention`` hands
it the model's (B, S, H, D) tensors as (B, H, S, D) views without a
copy. It has no backward: the training path keeps the differentiable
plain attention of ``models/layers.py``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib

MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{what}: expected (B, heads, S, D), got shape "
                         f"{tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{what}: the last dim must be contiguous")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k, v: (B,KVH,Sk,D), on the card, f32 or bf16 ->
    (B,H,Sq,D) in ``q.dtype`` (written into ``out`` when given, any
    strides with the last dim contiguous)."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bhsd: expected float32 or "
                         f"bfloat16, got {q.dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, f"flash_attention_bhsd {what}", q.dtype)
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or v.shape != k.shape
            or len({q.device, k.device, v.device}) != 1):
        raise ValueError(f"flash_attention_bhsd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match (or lie on different devices)")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in 1..{MAX_HEAD_DIM}, got {d}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _check(out, "flash_attention_bhsd out", q.dtype)
    if out.shape != q.shape or out.device != q.device:
        raise ValueError(f"out {tuple(out.shape)} does not match q")
    if q.numel() == 0:
        return out
    if sk == 0:
        return out.zero_()        # no key: every row keeps nothing
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in (0, 1, 2)))
    lib = cuda_lib.load_library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bhsd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, h, kvh, sq, sk, d, strides, scale,
            int(causal), int(window or 0), float(softcap or 0.0),
            cuda_lib.stream_of(q))
    cuda_lib.check_launch(err, "flash_attention_bhsd")
    cuda_lib.LAUNCHES["flash_attention_bhsd"] += 1
    return out
