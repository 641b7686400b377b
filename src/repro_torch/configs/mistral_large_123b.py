"""Mistral-Large-2407 (123B) [hf:mistralai/Mistral-Large-Instruct-2407].

The same numbers as ``repro.configs.mistral_large_123b``.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32_768,
    mlp_type="swiglu",
    norm_type="rms",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    decode_window=8192,
    source="hf:mistralai/Mistral-Large-Instruct-2407",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=512,
                       param_dtype=torch.float32, compute_dtype=torch.float32)
