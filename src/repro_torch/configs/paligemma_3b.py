"""PaliGemma-3B language backbone [arXiv:2407.07726].

The SigLIP vision tower is a stub frontend: the batch carries (B, 256,
1152) patch embeddings; the model owns the linear projector and the
18-layer Gemma decoder (MQA, kv = 1). The same numbers as
``repro.configs.paligemma_3b``.
"""
import torch

from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257_216,
    attn_pattern=("global",),
    mlp_type="geglu",
    norm_type="rms",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    decode_window=8192,     # sub-quadratic long_500k variant (sliding window)
    frontend=FrontendConfig(kind="vision", embed_dim=1152,
                            num_prefix_tokens=256),
    source="arXiv:2407.07726 (SigLIP + Gemma)",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
                       head_dim=32, d_ff=256, vocab_size=512,
                       frontend=FrontendConfig(kind="vision", embed_dim=64,
                                               num_prefix_tokens=8),
                       param_dtype=torch.float32, compute_dtype=torch.float32)
