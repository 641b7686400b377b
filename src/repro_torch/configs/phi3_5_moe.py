"""Phi-3.5-MoE (42B total / 6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct].

16 experts, top-2 routing, SwiGLU experts with d_ff 6400, GQA kv=8,
layer norm. The same numbers as ``repro.configs.phi3_5_moe``.
"""
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32_064,
    mlp_type="swiglu",
    norm_type="layer",
    tie_embeddings=False,
    rope_theta=10_000.0,
    decode_window=8192,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                  capacity_factor=1.25, group_size=2048),
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=512,
                       moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256,
                                     group_size=64),
                       param_dtype=torch.float32, compute_dtype=torch.float32)
