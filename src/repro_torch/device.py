"""Where the port's entry points run.

Every entry point takes ``device=None`` to mean ``"cuda"``. Without a
CUDA device that raises: nothing moves to the CPU on its own, so a run
that asked for the card never silently measures the host. Pass
``device="cpu"`` to run on the CPU (the tests do). ``device="meta"``
gives shapes and dtypes without storage (the dry-run's specs).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without CUDA raises; starting on
    the card also turns TF32 off for matmuls and cuDNN, so fp32 stays
    full fp32 like the reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
