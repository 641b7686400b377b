"""Public wire-path, masked-sum and attention wrappers, dispatched by the
tensor's device.

A CUDA tensor goes to the hand-written kernels (``kernels/quantize.py``,
``kernels/wire.py``, ``kernels/flash_attention.py``), which launch or
raise; a CPU tensor goes to the
plain versions in ``kernels/ref.py``. There is no switch and no
fallback: the device of the data decides. A non-tensor input is placed
on ``device`` first, and ``device=None`` means ``"cuda"``.

``LAUNCHES`` counts each kernel's launches (see ``cuda_lib``).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import flash_attention as fak
from repro_torch.kernels import quantize as qk
from repro_torch.kernels import ref
from repro_torch.kernels import wire as wk
from repro_torch.kernels.cuda_lib import LAUNCHES, reset_launches  # noqa: F401


def as_tensor(x, device: DeviceLike = None) -> torch.Tensor:
    """A tensor stays where it is (unless ``device`` is given); anything
    else goes to ``device`` (``None`` -> the card)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def _blocks(x: torch.Tensor, block: int):
    """Flatten to f32 and zero-pad the tail within its own block ->
    ((ceil(n/block), block) contiguous, n)."""
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, block).contiguous(), n


def quantize_dequantize(x, *, bits: int, block: int = 256,
                        topk: Optional[int] = None,
                        device: DeviceLike = None) -> torch.Tensor:
    """Wire round trip (quantize then dequantize), any shape; ``topk``
    keeps the k largest-magnitude codes per block (dropped coordinates
    come back exactly 0.0)."""
    x = as_tensor(x, device)
    if not _on_card(x):
        return ref.quantize_dequantize_ref(x, bits, block, topk=topk)
    shape, dtype = x.shape, x.dtype
    blocks, n = _blocks(x, block)
    if n == 0:
        return torch.empty(shape, dtype=dtype, device=x.device)
    if topk is not None and topk < block:
        codes, scales, _ = wk.quantize_topk_blocks(blocks, bits, topk)
    else:
        codes, scales = qk.quantize_blocks(blocks, bits)
    deq = qk.dequantize_blocks(codes, scales)
    return deq.reshape(-1)[:n].reshape(shape).to(dtype)


def dequantize_blocks(codes, scales, *, out: Optional[torch.Tensor] = None,
                      device: DeviceLike = None):
    """Decode wire blocks: (n_blocks, block) int8 codes x per-block f32
    scales -> (n_blocks, block) f32 (code 0 -> exactly 0.0), written into
    ``out`` when given (an f32 tensor of the codes' shape)."""
    codes = as_tensor(codes, device)
    scales = as_tensor(scales, device)
    if not _on_card(codes):
        deq = ref.dequantize_blocks_ref(codes, scales)
        return deq if out is None else out.copy_(deq)
    return qk.dequantize_blocks(codes.contiguous(), scales.contiguous(),
                                out=out)


def quantize_wire(x, *, bits: int, block: int = 256,
                  topk: Optional[int] = None, device: DeviceLike = None):
    """Quantize a tensor into the wire tuple actually shipped:
    ``(codes int8 (n_blocks, block), scales f32 (n_blocks,),
    mask int8 (n_blocks, block) | None, n_valid)`` with exactly
    ``n_blocks = ceil(n / block)``, so ``core.compression.wire_bytes``
    prices this tuple. ``mask`` is None for the dense format and for
    ``topk >= block``."""
    x = as_tensor(x, device)
    card = _on_card(x)
    if topk is not None and topk >= block:
        topk = None
    blocks, n = _blocks(x, block)
    if n == 0:
        empty = torch.zeros((0, block), dtype=torch.int8, device=x.device)
        return (empty, torch.zeros((0,), dtype=torch.float32, device=x.device),
                None if topk is None else empty.clone(), 0)
    if topk is not None:
        if card:
            codes, scales, mask = wk.quantize_topk_blocks(blocks, bits, topk)
        else:
            codes, scales, mask = ref.quantize_topk_blocks_ref(blocks, bits,
                                                               topk)
        return codes, scales, mask, n
    if card:
        codes, scales = qk.quantize_blocks(blocks, bits)
    else:
        codes, scales = ref.quantize_blocks_ref(blocks, bits)
    return codes, scales, None, n


# ---------------------------------------------------------------------------
# fixed-point masked sum (secure-aggregation cohort fold)
# ---------------------------------------------------------------------------

MASKED_SUM_MAX_CLIENTS = ref.MASKED_SUM_MAX_CLIENTS


def split_limbs(u64: np.ndarray):
    """NumPy uint64 (C, n) -> ((C, n) hi, (C, n) lo) uint32 limb pairs."""
    u64 = np.ascontiguousarray(u64, dtype=np.uint64)
    return ((u64 >> np.uint64(32)).astype(np.uint32),
            (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def merge_limbs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 -> NumPy uint64, elementwise."""
    return ((np.asarray(hi, dtype=np.uint64) << np.uint64(32))
            | np.asarray(lo, dtype=np.uint64))


def _check_cohort(c: int) -> None:
    if c > MASKED_SUM_MAX_CLIENTS:
        raise ValueError(
            f"masked_sum supports at most {MASKED_SUM_MAX_CLIENTS} clients "
            f"per fold, got {c}")


def masked_sum(hi, lo, *, device: DeviceLike = None):
    """Sum C clients' uint64 vectors mod 2^64, carried as uint32 limbs:
    (C, n) hi/lo -> ((n,) hi, (n,) lo) uint32. The card runs
    ``wire.masked_sum_limbs``; the CPU its plain version. Bit-exact
    either way (integer arithmetic)."""
    hi = as_tensor(hi, device)
    lo = as_tensor(lo, device)
    _check_cohort(hi.shape[0])
    if not _on_card(hi):
        return ref.masked_sum_ref(hi, lo)
    return wk.masked_sum_limbs(hi.contiguous(), lo.contiguous())


def masked_sum_u64(vals: np.ndarray, *, device: DeviceLike = None
                   ) -> np.ndarray:
    """Host-level cohort fold: NumPy (C, n) uint64 -> (n,) sum mod 2^64.

    The ``MaskedSumAggregator`` flush path: the values' bits go to
    ``device`` (``None`` -> ``"cuda"``) as one int64 tensor, are summed
    there in uint64 (``wire.masked_sum_u64``; its plain version on the
    CPU) and come back as uint64. No limbs are split or merged. There is
    no CPU shortcut on a card: asked for the card, it launches the
    kernel or raises."""
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    bits = torch.from_numpy(vals.view(np.int64)).to(resolve_device(device))
    return fold_u64_bits(bits).cpu().numpy().view(np.uint64)


def fold_u64_bits(bits: torch.Tensor) -> torch.Tensor:
    """``masked_sum_u64``'s fold on the device: (C, n) int64, the bits
    of uint64 values -> (n,) int64, the bits of their column sums mod
    2^64. The card runs ``wire.masked_sum_u64``; the CPU its plain
    version."""
    _check_cohort(bits.shape[0])
    if _on_card(bits):
        return wk.masked_sum_u64(bits)
    return ref.masked_sum_u64_ref(bits)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (B,S,H,D), k/v (B,S,KVH,D) -> (B,S,H,D) in
    ``q.dtype``. The card runs the flash kernel on these tensors through
    their strides (``flash_attention_bshd``); the CPU runs
    ``ref.flash_attention_ref``. Forward only. DTensors (a mesh's step)
    go through ``attention_local``: each rank runs the same route on its
    own heads."""
    if _is_dtensor(q):
        return attention_local(flash_attention, q, k, v, causal=causal,
                               window=window, softcap=softcap, scale=scale)
    if not _on_card(q):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    return fak.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def attention_local(fn, q, k, v, **kw):
    """Attention of DTensors q (B,S,H,D), k/v (B,S,KVH,D) as ``fn`` (an
    attention of local tensors in the same layout) on each rank's share:
    the batch stays split as it is, the query heads too; the sequence
    is gathered (a causal or windowed mask is aligned on whole
    sequences). KV heads split over the same mesh dims as the query
    heads stay split when their count divides as the query's does;
    otherwise (GQA: Gemma2's 8 KV heads under 16 query heads on a
    16-way axis) k/v are gathered over those dims and each rank slices
    the KV heads its own query heads read, from its coordinate on them:
    the kernel's ``ih // g`` on a local head index would read KV head 0
    on every rank. Runs through ``local_map``, so gradients flow."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.models.layers import redistribute_at
    mesh = q.device_mesh
    qp = tuple(pl if pl.is_shard() and pl.dim in (0, 2) else Replicate()
               for pl in q.placements)
    heads_on = [i for i, pl in enumerate(qp) if pl.is_shard(2)]
    n_split = math.prod(mesh.shape[i] for i in heads_on)
    h, kvh = q.shape[2], k.shape[2]
    kv_split = kvh % n_split == 0
    kp = tuple(Shard(2) if i in heads_on and kv_split
               else pl if pl.is_shard(0) else Replicate()
               for i, pl in enumerate(qp))
    q = redistribute_at("attention", q, qp)
    k = redistribute_at("attention", k, kp)
    v = redistribute_at("attention", v, kp)
    g, h_loc = h // kvh, h // n_split
    lo = hi = None
    if not kv_split:
        if h_loc % g and g % h_loc:
            raise ValueError(f"{h_loc} local query heads of {h} do not "
                             f"group over {kvh} KV heads")
        coord = mesh.get_coordinate()
        rank = 0
        for i in heads_on:                   # mesh order: major to minor
            rank = rank * mesh.shape[i] + coord[i]
        lo = rank * h_loc // g
        hi = lo + max(1, h_loc // g)

    def local(ql, kl, vl):
        if lo is not None:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl, **kw)

    # a k/v gathered over the query's head split feeds each rank's own
    # heads: its gradient there is the sum over the ranks
    from torch.distributed.tensor import Partial
    kg = tuple(Partial() if i in heads_on and not kv_split else pl
               for i, pl in enumerate(kp))
    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg),
                     device_mesh=mesh)(q, k, v)


# ---------------------------------------------------------------------------
# trace-analysis entry points (repro_torch.analysis.trace)
# ---------------------------------------------------------------------------


def _wire_build(bits: int, topk: Optional[int]):
    def build():
        x = torch.randn(1 << 16, generator=torch.Generator().manual_seed(4))

        def fn(t):
            return quantize_wire(t, bits=bits, topk=topk)

        return fn, (x,)
    return build


def _masked_sum_build():
    gen = torch.Generator().manual_seed(5)
    bits = torch.randint(-(1 << 63), (1 << 63) - 1, (8, 4096), generator=gen,
                         dtype=torch.int64)
    return fold_u64_bits, (bits,)


def trace_entry_points() -> list:
    """Declared traceable surfaces: the wire pipeline at both formats and
    the secure-aggregation cohort fold, traced through the kernels'
    stand-ins (f32 and int8 on the wire; the fold
    takes uint64 bits in and gives them out, so TRACE001 sees no
    promotion)."""
    from repro_torch.analysis.trace.registry import EntryPoint, anchor
    wire = anchor(quantize_wire)
    return [
        EntryPoint(name="kernels.wire_dense", **wire,
                   build=_wire_build(8, None),
                   note="dense int8 wire tuple, 64k params"),
        EntryPoint(name="kernels.wire_topk", **wire,
                   build=_wire_build(2, 64),
                   note="2-bit top-64 sparse wire tuple, 64k params"),
        EntryPoint(name="kernels.masked_sum", **anchor(fold_u64_bits),
                   build=_masked_sum_build,
                   note="uint64 cohort fold (masked_sum_u64), C=8, n=4096"),
    ]
