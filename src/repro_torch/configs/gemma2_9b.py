"""Gemma2-9B [arXiv:2408.00118]: local/global alternating attention,
logit softcapping, post-norms, GeGLU.

The same numbers as ``repro.configs.gemma2_9b``. long_500k runs the
arch's own sliding-window mechanism: local layers keep window 4096;
global layers are windowed by ``decode_window``.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    attn_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    mlp_type="geglu",
    norm_type="rms",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    decode_window=8192,
    source="arXiv:2408.00118 (Gemma 2)",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=512, window=32,
                       param_dtype=torch.float32, compute_dtype=torch.float32)
