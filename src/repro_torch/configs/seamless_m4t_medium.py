"""SeamlessM4T-medium [arXiv:2308.11596]: the encoder-decoder backbone.

The speech frontend (mel features and the conformer feature extractor)
is a stub, as in the reference: the batch carries ``src_embeds``, (B,
S_src, 1024) frame embeddings, projected into a 12-layer encoder; a
12-layer decoder with cross-attention reads its output. Positions are
RoPE (the original is sinusoidal), as the reference has them. The same
numbers as ``repro.configs.seamless_m4t_medium``.
"""
import torch

from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,          # decoder layers
    enc_layers=12,
    encdec=True,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    mlp_type="gelu",
    norm_type="layer",
    tie_embeddings=True,
    rope_theta=10_000.0,
    decode_window=8192,
    frontend=FrontendConfig(kind="audio", embed_dim=1024, num_prefix_tokens=0),
    source="arXiv:2308.11596 (SeamlessM4T)",
)

SMOKE = CONFIG.replace(num_layers=2, enc_layers=2, d_model=128, num_heads=4,
                       num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
                       frontend=FrontendConfig(kind="audio", embed_dim=64,
                                               num_prefix_tokens=0),
                       param_dtype=torch.float32, compute_dtype=torch.float32)
