"""Minitron-8B [arXiv:2407.14679]: width/depth-pruned Nemotron-4.

Squared-ReLU MLP (the Nemotron family), layer norm, GQA kv=8, untied
embeddings. The same numbers as ``repro.configs.minitron_8b``.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256_000,
    mlp_type="relu2",
    norm_type="layer",
    tie_embeddings=False,
    rope_theta=10_000.0,
    decode_window=8192,
    source="arXiv:2407.14679 (Minitron, pruned Nemotron)",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=512,
                       param_dtype=torch.float32, compute_dtype=torch.float32)
