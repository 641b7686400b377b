"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437].

MLA (multi-head latent attention: kv_lora_rank 512 plus a 64-wide
shared RoPE key), 1 shared + 256 routed experts top-8, the first 3
layers dense (d_ff 18432). Decode takes the absorbed-matmul MLA path, so
the per-token cache is 512 + 64 values a layer whatever the head count.
Multi-token prediction is a training objective the reference does not
reproduce either. The same numbers as ``repro.configs.deepseek_v3_671b``.
"""
import torch

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129_280,
    mlp_type="swiglu",
    norm_type="rms",
    tie_embeddings=False,
    rope_theta=10_000.0,
    decode_window=8192,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, capacity_factor=1.25,
                  first_dense_layers=3, d_ff_dense=18432, group_size=1024),
    source="arXiv:2412.19437 (DeepSeek-V3)",
)

SMOKE = CONFIG.replace(num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
                       head_dim=32, d_ff=64, vocab_size=512,
                       mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16),
                       moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                                     num_shared_experts=1, first_dense_layers=1,
                                     d_ff_dense=128, group_size=64),
                       param_dtype=torch.float32, compute_dtype=torch.float32)
