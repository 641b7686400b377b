"""Qwen2-72B [arXiv:2407.10671]: dense GQA with q/k/v biases.

The same numbers as ``repro.configs.qwen2_72b``.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    qkv_bias=True,
    mlp_type="swiglu",
    norm_type="rms",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    decode_window=8192,
    source="arXiv:2407.10671 (Qwen2)",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=512,
                       param_dtype=torch.float32, compute_dtype=torch.float32)
