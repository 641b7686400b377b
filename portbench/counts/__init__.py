"""What MFU and the rooflines divide by: operations and bytes from shapes.

Kept with the benchmark, so that a change to the program cannot change
what a share is divided by. Model FLOPs count the matrix products of
the model (2 per multiply-add) and causal attention over the query-key
pairs the mask admits, with no recomputation:

- forward: every layer and the unembedding;
- backward, under a freezing mask: every layer from the lowest
  trainable one up passes its input gradient on (2x its matrix
  forward) and takes attention's backward (2x its forward); a trainable
  layer also gets its weight gradients (2x); a frozen layer below every
  trainable one gets nothing, as no gradient has to reach it. The
  unembedding passes its input gradient on when a layer trains, and
  gets its weight gradient when it trains itself.

An MoE layer counts the experts a token is routed to (top-k of E), not
the capacity buffer the program fills. Peaks are one H100 SXM's data
sheet: 989 TFLOP/s bf16 dense, 67 TFLOP/s fp32 (no tensor cores; the
port turns TF32 off), 3.35 TB/s HBM3.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12


def causal_pairs(seq: int) -> int:
    """Query-key pairs a causal mask admits over ``seq`` positions."""
    return seq * (seq + 1) // 2


def attention_flops(seq: int, heads: int, head_dim: int) -> int:
    """Forward FLOPs of causal attention for one sequence and one layer:
    QK^T and PV over the admitted pairs, 2 FLOPs a multiply-add each."""
    return 4 * head_dim * heads * causal_pairs(seq)


def layer_matmul_params(cfg: Dict) -> Dict[str, int]:
    """Weights a token multiplies in one layer: attention projections and
    the MLP, or the routed experts (top-k) and the router for an MoE
    layer; ``head``: the unembedding."""
    d, h, kvh, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                     cfg["head_dim"])
    attn = d * (h * hd + 2 * kvh * hd) + h * hd * d
    if cfg.get("num_experts"):
        mlp = (cfg["top_k"] * 3 * d * cfg["d_ff_expert"]
               + d * cfg["num_experts"])
    elif cfg.get("mlp_type", "swiglu") in ("swiglu", "geglu"):
        mlp = 3 * d * cfg["d_ff"]
    else:
        mlp = 2 * d * cfg["d_ff"]
    return {"attn": attn, "mlp": mlp, "head": d * cfg["vocab_size"]}


def forward_flops(cfg: Dict, batch: int, seq: int) -> int:
    """Forward FLOPs of ``batch`` sequences of ``seq`` tokens."""
    p = layer_matmul_params(cfg)
    tokens = batch * seq
    per_layer = 2 * tokens * (p["attn"] + p["mlp"]) + batch * attention_flops(
        seq, cfg["num_heads"], cfg["head_dim"])
    return cfg["num_layers"] * per_layer + 2 * tokens * p["head"]


def train_flops(cfg: Dict, batch: int, seq: int,
                trainable: Sequence[bool], head_trainable: bool = True) -> int:
    """Forward and backward FLOPs of one pass of ``batch`` x ``seq``
    tokens with layer ``i`` trainable where ``trainable[i]`` (the
    embedding's gradient is a gather and counts nothing)."""
    p = layer_matmul_params(cfg)
    tokens = batch * seq
    mm = 2 * tokens * (p["attn"] + p["mlp"])
    att = batch * attention_flops(seq, cfg["num_heads"], cfg["head_dim"])
    total = forward_flops(cfg, batch, seq)
    # the unembedding: its input gradient when a layer trains, its
    # weight gradient when it trains itself
    head = 2 * tokens * p["head"]
    lowest = next((i for i, t in enumerate(trainable) if t), None)
    if lowest is not None:
        total += head
    if head_trainable:
        total += head
    for i, t in enumerate(trainable):
        if lowest is None or i < lowest:
            continue                   # nothing below needs a gradient
        total += mm + 2 * att          # input gradients and attention's
        if t:
            total += mm                # weight gradients
    return total


def wire_bytes(leaf_sizes: List[int], block: int = 256) -> Dict[str, int]:
    """Bytes the wire kernels need for one client delta, each input byte
    read once and each output byte written once: the quantizer reads the
    fp32 blocks and writes int8 codes and an fp32 scale a block; the
    dequantizer reads those and writes fp32 blocks. Each leaf starts on
    a block boundary (its tail block zero-padded)."""
    blocks = sum(-(-n // block) for n in leaf_sizes)
    values = blocks * block
    quant = values * 4 + values + blocks * 4
    dequant = values + blocks * 4 + values * 4
    return {"blocks": blocks, "quantize": quant, "dequantize": dequant}


def flash_bound_seconds(seq: int, heads: int, kv_heads: int, head_dim: int,
                        itemsize: int = 2, peak: float = PEAK_BF16) -> float:
    """Least time one causal flash call could take on the card: the
    larger of its admitted-pair FLOPs over the peak and its bytes (q, k,
    v read once, the output written once) over HBM bandwidth."""
    flops = attention_flops(seq, heads, head_dim)
    nbytes = itemsize * seq * head_dim * (2 * heads + 2 * kv_heads)
    return max(flops / peak, nbytes / PEAK_HBM)


#: the port's wire and flash kernels, by the names the profiler gives them
WIRE_KERNELS = ("quantize_blocks", "dequantize_blocks")
FLASH_KERNELS = ("flash_mma_bf16_kernel", "flash_rows_f32_kernel",
                 "flash_tiled_f32_kernel")


#: matrix-multiply kernels, by name parts the profiler gives cuBLAS's and
#: CUTLASS's kernels on the card
GEMM_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "wgmma")


def kernel_seconds(ops, names) -> float:
    """Device seconds of the operations whose name contains one of
    ``names`` (and not ``topk``, which is not the dense quantizer)."""
    total = 0
    for name, s, t in ops:
        if any(n in name for n in names) and "topk" not in name:
            total += t - s
    return total * 1e-9
