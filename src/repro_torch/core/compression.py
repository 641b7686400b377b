"""Update compression for the communication knob ``q``.

q=0: fp32 (4 B/param) — no-op.
q=1: blockwise int8 absmax quantization (1 B/param + fp32 scale / block).
q=2: blockwise 2-bit quantization (0.25 B/param + fp32 scale / block).

``topk`` adds the sparse wire format on top of either quantized level:
only the ``topk`` largest-magnitude codes per block ship, as (packed
codes, 1-bit/coordinate keep-bitmask, per-block fp32 scale).

A tree is one tensor or the port's parameter dict (names -> tensors).
Each leaf is quantized on its own blocks: its tail block is zero-padded
within itself, so blocks never straddle two leaves. The round trip
stages every leaf of the tree into one zeroed buffer of
``sum(ceil(n_i / block))`` blocks, each leaf starting on a block
boundary, and quantizes and decodes that buffer with one call each:
one launch of each wire kernel per client delta on the card, where a
call per leaf took 16. The results are the per-leaf path's, bit for bit,
and ``wire_bytes`` prices the same blocks. ``kernels.ops`` runs the CUDA
kernels for CUDA leaves and the plain versions for CPU leaves.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels import ops


def _leaves(tree: Any) -> List[Any]:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def stage_blocks(leaves: List[torch.Tensor], block: int = 256):
    """Leaves -> (a zeroed (sum ceil(n_i / block), block) f32 buffer
    holding each leaf's values from its own first block on, the offset
    of each leaf's first value in the flattened buffer)."""
    device = leaves[0].device if leaves else torch.device("cpu")
    if any(leaf.device != device for leaf in leaves):
        raise ValueError("stage_blocks: the leaves lie on more than "
                         "one device")
    offsets, dst, src = [], [], []
    total = 0
    for leaf in leaves:
        n = leaf.numel()
        offsets.append(total)
        total += -(-n // block) * block
    buf = torch.zeros((total // block, block), dtype=torch.float32,
                      device=device)
    flat = buf.view(-1)
    for leaf, off in zip(leaves, offsets):
        if leaf.numel():
            dst.append(flat[off:off + leaf.numel()])
            src.append(leaf.reshape(-1).to(torch.float32))
    if dst:
        torch._foreach_copy_(dst, src)
    return buf, offsets


def compress_decompress(tree: Any, q: int, block: int = 256,
                        topk: Optional[int] = None) -> Any:
    if q == 0:
        return tree
    bits = 8 if q == 1 else 2
    leaves = [ops.as_tensor(leaf) for leaf in _leaves(tree)]
    with torch.no_grad():
        buf, offsets = stage_blocks(leaves, block)
        codes, scales, _, _ = ops.quantize_wire(buf, bits=bits, block=block,
                                                topk=topk)
        # decoded in place: the staged values are spent once quantized
        flat = ops.dequantize_blocks(codes, scales, out=buf).view(-1)
    out = [flat[off:off + leaf.numel()].view(leaf.shape).to(leaf.dtype)
           for leaf, off in zip(leaves, offsets)]
    if isinstance(tree, dict):
        return dict(zip(tree, out))
    return out[0]


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
