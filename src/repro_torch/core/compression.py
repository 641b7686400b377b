"""Update compression for the communication knob ``q``.

q=0: fp32 (4 B/param) — no-op.
q=1: blockwise int8 absmax quantization (1 B/param + fp32 scale / block).
q=2: blockwise 2-bit quantization (0.25 B/param + fp32 scale / block).

``topk`` adds the sparse wire format on top of either quantized level:
only the ``topk`` largest-magnitude codes per block ship, as (packed
codes, 1-bit/coordinate keep-bitmask, per-block fp32 scale).

A tree is one tensor or the port's parameter dict (names -> tensors).
Each leaf is quantized on its own: its tail block is
zero-padded within itself, so blocks never straddle two leaves.
``kernels.ops`` runs the CUDA kernels for CUDA leaves and the plain
versions for CPU leaves.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops


def _leaves(tree: Any) -> List[Any]:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def compress_decompress(tree: Any, q: int, block: int = 256,
                        topk: Optional[int] = None) -> Any:
    if q == 0:
        return tree
    bits = 8 if q == 1 else 2
    if isinstance(tree, dict):
        return {name: ops.quantize_dequantize(leaf, bits=bits, block=block,
                                              topk=topk)
                for name, leaf in tree.items()}
    return ops.quantize_dequantize(tree, bits=bits, block=block, topk=topk)


#: dyadic scale-out factor: integer *bit* counts -> bytes; exact in
#: float (power of two)
_BYTES_PER_BIT = 0.125


def to_mb(bytes_: float) -> float:
    """The one float-division reporting edge for byte counts (exact
    integer accounting everywhere upstream)."""
    return bytes_ / 1e6


def wire_bytes(tree: Any, q: int, block: int = 256,
               topk: Optional[int] = None) -> float:
    """Exact bytes of the shipped wire tuple, leaf by leaf as
    ``kernels.ops.quantize_wire`` emits it: ``ceil(n / block)`` blocks per
    leaf. Dense format: ``block`` codes at ``bits`` each + one fp32 scale
    per block. Top-k format: ``topk`` packed codes + a 1-bit/coordinate
    keep-bitmask + the scale. Counted in integer bits, scaled out once."""
    leaves = _leaves(tree)
    n = sum(int(np.prod(l.shape)) for l in leaves)
    if q == 0:
        return n * 32 * _BYTES_PER_BIT
    bits = 8 if q == 1 else 2
    n_blocks = sum(-(-int(np.prod(l.shape)) // block) for l in leaves)
    if topk is not None and topk < block:
        code_bits = n_blocks * (topk * bits + block)
    else:
        code_bits = n_blocks * block * bits
    return (code_bits + 32 * n_blocks) * _BYTES_PER_BIT


def wire_mb(tree: Any, q: int, block: int = 256,
            topk: Optional[int] = None) -> float:
    return to_mb(wire_bytes(tree, q, block, topk))


def compression_error(tree: Any, q: int, block: int = 256,
                      topk: Optional[int] = None) -> Dict[str, float]:
    """Relative L2 error introduced by the wire format (diagnostics)."""
    if q == 0:
        return {"rel_l2": 0.0}
    deq = compress_decompress(tree, q, block, topk)
    num = 0.0
    den = 0.0
    for a, b in zip(_leaves(tree), _leaves(deq)):
        a = torch.as_tensor(a).detach().to("cpu", torch.float32).numpy()
        b = torch.as_tensor(b).detach().to("cpu", torch.float32).numpy()
        num += float(np.sum((a - b) ** 2))
        den += float(np.sum(a ** 2))
    return {"rel_l2": float(np.sqrt(num / max(den, 1e-30)))}
