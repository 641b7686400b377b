"""The paper's own evaluation model (§5): GPT-style char-level transformer,
6 layers, 8 heads, learned positions, on Tiny Shakespeare.

The same numbers as ``repro.configs.charlm_shakespeare``: d=192, d_ff=2d
(~1.9M parameters, the count the resource proxies depend on), 6L/8H,
seq_len=32, fp32 parameters and compute.
"""
import torch

from repro_torch.configs.base import Budgets, DualConfig, FLConfig, ModelConfig

CONFIG = ModelConfig(
    name="charlm-shakespeare",
    family="dense",
    num_layers=6,
    d_model=192,
    num_heads=8,
    num_kv_heads=8,
    head_dim=24,
    d_ff=384,
    vocab_size=128,          # rounded up; actual char vocab set by the dataset
    mlp_type="gelu",
    norm_type="layer",
    tie_embeddings=True,
    learned_pos_emb=512,
    decode_window=None,
    max_seq_len=512,
    param_dtype=torch.float32,
    compute_dtype=torch.float32,
    q_chunk=512,
    source="paper §5 (Karpathy char-LM setting)",
)

SMOKE = CONFIG.replace(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
                       head_dim=16, d_ff=128)

# Paper §5 federated setting: N=16 clients, 6 per round; k/s/b baselines
# 6/40/32; budgets are the paper's Table 1 "Budget Limit" row.
FL = FLConfig(
    num_clients=16,
    clients_per_round=6,
    rounds=25,
    k_base=6,
    s_base=40,
    b_base=32,
    seq_len=32,
    lr=1e-3,
    eval_batches=4,
    eval_batch_size=64,
    budgets=Budgets(energy=1.2e6, comm_mb=0.60, memory=0.26, temp=1.00),
    duals=DualConfig(),
)
