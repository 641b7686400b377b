"""xLSTM-1.3B [arXiv:2405.04517]: mLSTM and sLSTM blocks at 7:1.

48 blocks = 6 stacked units of (7 x mLSTM, 1 x sLSTM). No FFN (d_ff 0):
the xLSTM blocks carry their own up and down projections, and there is
no KV cache (the decode state is O(1) per block). The same numbers as
``repro.configs.xlstm_1_3b``.
"""
import torch

from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    mlp_type="none",
    norm_type="layer",
    tie_embeddings=False,
    decode_window=None,
    xlstm=XLSTMConfig(mlstm_per_unit=7, slstm_per_unit=1, chunk_size=64,
                      proj_factor_mlstm=2.0, proj_factor_slstm=1.3334),
    source="arXiv:2405.04517 (xLSTM)",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
                       head_dim=32, vocab_size=512,
                       block_pattern=("mlstm", "slstm"),
                       xlstm=XLSTMConfig(chunk_size=16),
                       param_dtype=torch.float32, compute_dtype=torch.float32)
