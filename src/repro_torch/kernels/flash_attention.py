"""CUDA flash attention: the forward attention of every no-grad path
(Gemma2 prefill, the char-LM eval).

``flash_attention_bhsd`` (tensors as (B, H, S, D)) and
``flash_attention_bshd`` (the model's own (B, S, H, D)) launch the
kernel of ``csrc/flash_attention.cu``, which replaces the Pallas kernel
of ``repro/kernels/flash_attention.py``: causal / sliding-window / tanh
softcap, GQA, fp32 online softmax, f32 or bf16 in and the input's dtype
out. CUDA tensors only; ``kernels/ops.py`` dispatches CPU tensors to
``ref.flash_attention_ref``. The kernel addresses each tensor through its
(batch, head, seq) strides with the last dim contiguous, so neither
layout is copied. It has no backward: the training path keeps the
differentiable plain attention of ``models/layers.py``.

The variant is chosen from the dtype and the head width alone
(``variant``): bf16 runs on the tensor cores (``mma_bf16``), f32 with
D <= 32 one thread per query row (``rows_f32``, the char-LM eval), f32
with a wider head the register-tiled CUDA-core kernel (``tiled_f32``).
``cuda_lib.LAUNCHES["flash_attention_bhsd"]`` counts every launch and
``cuda_lib.FLASH_VARIANTS`` each variant's.
"""
from __future__ import annotations

import math
import struct
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib

MAX_HEAD_DIM = 256
#: widest head the one-thread-per-row f32 variant takes
ROWS_MAX_HEAD_DIM = 32
VARIANTS = ("mma_bf16", "rows_f32", "tiled_f32")
#: each variant's CUDA kernel (the name a profiler shows, with template
#: arguments after it)
KERNELS = {name: f"flash_{name}_kernel" for name in VARIANTS}
_DTYPES = (torch.float32, torch.bfloat16)
#: the C side's FlashArgs: pointers, variant, sizes, 12 strides, causal,
#: window (int64 each), then scale and softcap (float64)
_ARGS = struct.Struct("<25q2d")


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel variant a call of this dtype and head width runs."""
    if dtype == torch.bfloat16:
        return "mma_bf16"
    return "rows_f32" if d <= ROWS_MAX_HEAD_DIM else "tiled_f32"


#: the (batch, head, seq) dims of each layout
_BHSD = (0, 1, 2)
_BSHD = (0, 2, 1)


def _refuse(q, k, v, out) -> None:
    """Raise the first fault of the four tensors (the slow path of
    ``_launch``'s check)."""
    dtype = q.dtype if isinstance(q, torch.Tensor) else None
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention_bhsd: expected float32 or "
                         f"bfloat16, got {dtype}")
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        what = f"flash_attention_bhsd {what}"
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{what}: expected a CUDA tensor, got "
                             f"{getattr(t, 'device', type(t))}")
        if t.dtype != dtype:
            raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    raise ValueError("flash_attention_bhsd: q, k, v and out lie on "
                     "different devices")


def _launch(q, k, v, out, axes, causal, window, softcap, scale) -> None:
    """Check the four tensors (on one card, of one dtype, of matching 4-D
    shapes, the last dim contiguous) and launch the variant for ``q``'s
    dtype and head width. ``axes`` names the (batch, head, seq) dims."""
    index = q.get_device()
    dtype = q.dtype
    if (index < 0 or dtype not in _DTYPES or k.get_device() != index
            or v.get_device() != index or out.get_device() != index
            or k.dtype != dtype or v.dtype != dtype or out.dtype != dtype):
        _refuse(q, k, v, out)
    qs, ks = q.shape, k.shape
    if (len(qs) != 4 or len(ks) != 4 or ks[0] != qs[0] or ks[3] != qs[3]
            or v.shape != ks or out.shape != qs):
        raise ValueError(f"flash_attention_bhsd: q {tuple(qs)}, k "
                         f"{tuple(ks)}, v {tuple(v.shape)} and out "
                         f"{tuple(out.shape)} do not match as "
                         f"{'(B,H,S,D)' if axes == _BHSD else '(B,S,H,D)'}")
    qt, kt, vt, ot = q.stride(), k.stride(), v.stride(), out.stride()
    if qt[3] != 1 or kt[3] != 1 or vt[3] != 1 or ot[3] != 1:
        raise ValueError("flash_attention_bhsd: the last dim of q, k, v "
                         "and out must be contiguous")
    a, hd, sd = axes
    b, h, sq, d = qs[a], qs[hd], qs[sd], qs[3]
    kvh, sk = ks[hd], ks[sd]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in 1..{MAX_HEAD_DIM}, got {d}")
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if b * h * sq == 0:
        return
    if sk == 0:
        out.zero_()               # no key: every row keeps nothing
        return
    name = variant(dtype, d)
    args = _ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        VARIANTS.index(name), b, h, kvh, sq, sk, d,
        qt[a], qt[hd], qt[sd], kt[a], kt[hd], kt[sd],
        vt[a], vt[hd], vt[sd], ot[a], ot[hd], ot[sd],
        int(causal), int(window or 0),
        1.0 / math.sqrt(d) if scale is None else float(scale),
        float(softcap or 0.0))
    err = cuda_lib.launch_on(index, "flash_attention_bhsd_launch", args)
    cuda_lib.check_launch(err, "flash_attention_bhsd")
    cuda_lib.LAUNCHES["flash_attention_bhsd"] += 1
    cuda_lib.FLASH_VARIANTS[name] += 1


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k, v: (B,KVH,Sk,D), on the card, f32 or bf16 ->
    (B,H,Sq,D) in ``q.dtype`` (written into ``out`` when given, any
    strides with the last dim contiguous)."""
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(q, k, v, out, _BHSD, causal, window, softcap, scale)
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The model's layout: q (B,Sq,H,D), k/v (B,Sk,KVH,D) on the card ->
    a new (B,Sq,H,D) tensor in ``q.dtype`` (laid out as q is). The
    strides go to the kernel as (batch, head, seq), so nothing is
    transposed or copied."""
    out = torch.empty_like(q)
    _launch(q, k, v, out, _BSHD, causal, window, softcap, scale)
    return out
