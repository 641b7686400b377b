"""Config dataclasses for the PyTorch port.

The fields of ``repro.configs.base`` that the char-LM client round
reads, with the same defaults; dtypes are ``torch`` dtypes. The port's
model is the char-LM's architecture (layer norm, tanh-GELU MLP, tied
embeddings, learned positions plus RoPE, global causal attention), so
the reference's switches between architectures are not fields here.
``FLConfig`` carries the engine's one choice that has two ported values,
the aggregator; the reference's other engine fields (executor, server
optimizer, constraint stack, dual overrides, time mode, horizon) name
pieces the port has one value of or none yet (ROADMAP queues 7 and 8),
so they are not fields here. ``InputShape`` and the MoE / MLA / RG-LRU /
xLSTM / frontend configs are not ported yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    learned_pos_emb: int              # rows of the learned position table
    rope_theta: float = 10000.0
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 2048               # queries per attention chunk
    source: str = ""                  # citation

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Budgets:
    """Per-round resource budgets  B = (E_b, C_b, M_b, T_b)  (paper Eq. 2)."""
    energy: float = 1.2e6
    comm_mb: float = 0.60
    memory: float = 0.26
    temp: float = 1.00


@dataclass(frozen=True)
class DualConfig:
    """Lagrangian dual optimization (paper Eq. 4)."""
    eta: float = 0.35                 # dual learning rate
    deadzone: float = 0.05            # |u/b - 1| <= dz  ->  no update
    lambda_max: float = 10.0
    # policy coefficients (paper Eq. 5-7)
    alpha_k: float = 1.0
    beta_s: float = 0.12
    gamma_b: float = 0.25
    # floors (paper: k>=1, s>=10, b>=8)
    k_min: int = 1
    s_min: int = 10
    b_min: int = 8


@dataclass(frozen=True)
class FLConfig:
    """Federated-learning experiment configuration (paper §5)."""
    num_clients: int = 16
    clients_per_round: int = 6
    rounds: int = 60
    # baseline knobs (k_base, s_base, b_base): the paper does not publish
    # them; chosen so FedAvg violates comm ~5x and memory ~1.1x (Fig. 2)
    k_base: int = 6                   # all layers unfrozen
    s_base: int = 40
    b_base: int = 32
    seq_len: int = 128
    lr: float = 1e-3
    optimizer: str = "adamw"
    weight_decay: float = 0.01
    seed: int = 0
    method: str = "cafl"              # cafl | fedavg
    budgets: Budgets = field(default_factory=Budgets)
    duals: DualConfig = field(default_factory=DualConfig)
    eval_batches: int = 8
    eval_batch_size: int = 64
    # non-IID partition strength (0 = IID shards)
    noniid_alpha: float = 0.0
    # ablation: disable Eq. 8 token-budget preservation (grad_accum = 1)
    token_budget: bool = True
    # Eq. 8 rounding: "ceil" (paper) | "clamped" (floor, >= 1)
    token_preservation: str = "ceil"
    # sparse wire format: keep the k largest-magnitude codes per
    # 256-value block (None = dense; only active at q > 0)
    wire_topk: Any = None
    # server-update policy (repro_torch.fl): "sync" (round barrier) |
    # "masked" (secure-aggregation simulation)
    aggregator: str = "sync"

    def replace(self, **kw) -> "FLConfig":
        return dataclasses.replace(self, **kw)
