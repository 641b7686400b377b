"""CUDA AdamW step: ``adamw_update`` launches ``csrc/optim_kernels.cu``
on CUDA tensors only, one launch per parameter, writing the parameter
and both moments in place in one pass (see the source's header).

Its plain twin is ``kernels/ref.py``'s ``adamw_update_ref`` (the
optimizer's piece arithmetic), and ``kernels/ops.py``'s
``adamw_update_`` dispatches between the two by the parameter's device.
The kernel equals the twin bit for bit. It takes fp32 or bf16
parameters, gradients and moments (both moments of one dtype) and a
mask broadcast over the parameter's leading dims or 0-d
(``mask_layout``); a layout it cannot read directly is copied into one
it can before the launch (a non-contiguous tensor, a mask broadcast
otherwise).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib

#: the kernel's dtype codes (``adamw_update_launch``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mask_layout(mask: torch.Tensor, shape) -> Tuple[torch.Tensor, int]:
    """A mask broadcast against a parameter of ``shape`` as the kernel
    reads it -> (flat contiguous fp32 values, inner): element ``i`` of
    the parameter (row-major) takes value ``i // inner``. A mask of one
    value reads as one row; one over the leading dims (``(n, 1, ...)``,
    ``core.freezing.mask_tree``'s stacked leaves) as one value per slice
    along them; any other broadcast is expanded to the parameter's shape
    (inner 1)."""
    n = math.prod(shape)
    flat = mask.reshape(-1).to(torch.float32)
    if mask.numel() == 1:
        return flat, max(n, 1)
    dims = (1,) * (len(shape) - mask.ndim) + tuple(mask.shape)
    lead = len(dims)
    while lead and dims[lead - 1] == 1:
        lead -= 1
    if len(dims) == len(shape) and dims[:lead] == tuple(shape[:lead]):
        return flat.contiguous(), max(math.prod(shape[lead:]), 1)
    full = torch.broadcast_to(mask, tuple(shape))
    return full.reshape(-1).to(torch.float32).contiguous(), 1


def _card(g, p, mu, nu, mask, bc1, bc2) -> int:
    """The card index of ``adamw_update``'s inputs; raises on any input
    the kernel cannot take."""
    index = p.get_device()
    if index < 0:
        raise ValueError(f"adamw_update: expected a CUDA parameter, got "
                         f"{p.device}")
    for what, t in (("gradient", g), ("parameter", p), ("mu", mu),
                    ("nu", nu)):
        if t.dtype not in DTYPES:
            raise ValueError(f"adamw_update: {what} in {t.dtype}; the "
                             f"kernel takes {list(DTYPES)}")
        if t.get_device() != index or t.shape != p.shape:
            raise ValueError(f"adamw_update: {what} {tuple(t.shape)} on "
                             f"{t.device} against a parameter "
                             f"{tuple(p.shape)} on {p.device}")
    if mu.dtype != nu.dtype:
        raise ValueError(f"adamw_update: moments in {mu.dtype} and "
                         f"{nu.dtype}")
    for what, t in (("bc1", bc1), ("bc2", bc2)):
        if (t.get_device() != index or t.dtype != torch.float32
                or t.numel() != 1):
            raise ValueError(f"adamw_update: {what} must be one fp32 value "
                             f"on {p.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if mask is not None and mask.get_device() != index:
        raise ValueError(f"adamw_update: a mask on {mask.device} for a "
                         f"parameter on {p.device}")
    return index


def adamw_update(g: torch.Tensor, p: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, mask: Optional[torch.Tensor],
                 bc1: torch.Tensor, bc2: torch.Tensor, *, lr: float,
                 b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step of one parameter on its card, in place: ``p``,
    ``mu`` and ``nu`` are written, ``g`` is read (masked as the twin
    masks it, without writing it back); ``bc1``, ``bc2``: the step's
    bias corrections, 0-d fp32 on the card. Decay applies to parameters
    of ``ndim >= 2``, as in the twin. An empty parameter launches
    nothing."""
    index = _card(g, p, mu, nu, mask, bc1, bc2)
    n = p.numel()
    if n == 0:
        return
    m, inner = (None, 0) if mask is None else mask_layout(mask, p.shape)
    outs = [t if t.is_contiguous() else t.contiguous() for t in (p, mu, nu)]
    gc = g if g.is_contiguous() else g.contiguous()
    err = cuda_lib.launch_on(
        index, "adamw_update_launch", gc.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(),
        None if m is None else m.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
        n, inner, DTYPES[g.dtype], DTYPES[p.dtype], DTYPES[mu.dtype], b1,
        1 - b1, b2, 1 - b2, eps, weight_decay, -lr,
        int(bool(weight_decay) and p.ndim >= 2))
    cuda_lib.check_launch(err, "adamw_update")
    cuda_lib.LAUNCHES["adamw_update"] += 1
    for t, out in zip((p, mu, nu), outs):
        if out is not t:
            t.copy_(out)
