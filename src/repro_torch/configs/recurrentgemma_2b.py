"""RecurrentGemma-2B [arXiv:2402.19427]: Griffin, RG-LRU recurrent blocks
and local attention at 2:1.

26 layers in the repeating pattern (rec, rec, attn): 8 stacked units and
a (rec, rec) suffix. Local attention window 2048, MQA (10 heads over 1).
The same numbers as ``repro.configs.recurrentgemma_2b``.
"""
import torch

from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=("rec", "rec", "attn"),
    attn_pattern=("local",),
    window=2048,
    mlp_type="geglu",
    norm_type="rms",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
    decode_window=None,     # local attention + recurrence: sub-quadratic
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, c_const=8.0),
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
)

SMOKE = CONFIG.replace(num_layers=5, d_model=128, num_heads=4, num_kv_heads=1,
                       head_dim=32, d_ff=256, vocab_size=512, window=32,
                       rglru=RGLRUConfig(lru_width=128, conv_width=4),
                       param_dtype=torch.float32, compute_dtype=torch.float32)
