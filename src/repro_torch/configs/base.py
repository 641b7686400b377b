"""Config dataclasses for the PyTorch port.

The fields of ``repro.configs.base`` that the ported models read, with
the same defaults; dtypes are ``torch`` dtypes. ``ModelConfig`` carries
the switches of the attention-based decoders (attention pattern and
window, softcaps, q/k/v biases, norm and MLP types, post-norms,
embedding options), the block pattern of the recurrent stacks, the
encoder-decoder fields, and the ``MoEConfig``, ``MLAConfig``,
``RGLRUConfig``, ``XLSTMConfig`` and ``FrontendConfig`` sub-configs, as
the reference has them. ``FLConfig`` carries every field of the
reference's, engine choices included (executor, aggregator, server
optimizer, constraint stack, dual overrides, time mode, horizon).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0       # leading layers that use a dense MLP
    d_ff_dense: int = 0               # d_ff of those dense layers / shared expert
    group_size: int = 2048            # tokens per dispatch group (GShard-style)
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RGLRUConfig:
    """Griffin/RecurrentGemma recurrent block."""
    lru_width: int = 0                # 0 -> d_model
    conv_width: int = 4
    c_const: float = 8.0              # the fixed `c` in a_t = exp(-c softplus(Λ) σ(r))


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack (mLSTM-dominant with interleaved sLSTM)."""
    mlstm_per_unit: int = 7           # xLSTM[7:1]
    slstm_per_unit: int = 1
    chunk_size: int = 64              # chunkwise-parallel mLSTM chunk
    proj_factor_mlstm: float = 2.0    # up-projection factor (pre-LSTM)
    proj_factor_slstm: float = 1.3334
    conv_width: int = 4


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: the batch carries precomputed embeddings."""
    kind: str                         # "vision" | "audio"
    embed_dim: int                    # SigLIP 1152 / speech-encoder 1024
    num_prefix_tokens: int = 256      # vision: patch tokens prepended


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int                   # decoder layers (enc-dec: of the decoder)
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    attn_pattern: Tuple[str, ...] = ("global",)   # per-layer unit, cycled
    window: int = 4096                # local-attention window
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # decode-time sliding window for long-context shapes (None -> full
    # cache)
    decode_window: Optional[int] = 8192
    # --- specials ---
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    rglru: Optional[RGLRUConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # block kinds cycled over layers ("attn" | "rec" | "mlstm" | "slstm");
    # empty -> every layer is attention
    block_pattern: Tuple[str, ...] = ()
    # --- enc-dec ---
    encdec: bool = False
    enc_layers: int = 0
    # --- frontend stub ---
    frontend: Optional[FrontendConfig] = None
    # --- misc ---
    mlp_type: str = "swiglu"          # swiglu | geglu | gelu | relu2 | none
    norm_type: str = "rms"            # rms | layer
    post_norms: bool = False          # gemma2-style post-attn/post-ffn norms
    tie_embeddings: bool = True
    embed_scale: bool = False         # gemma multiplies embeddings by sqrt(d)
    learned_pos_emb: int = 0          # >0: rows of the learned position table
    max_seq_len: int = 524_288
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 2048               # queries per attention chunk
    source: str = ""                  # citation

    def layer_kind(self, i: int) -> str:
        if self.block_pattern:
            return self.block_pattern[i % len(self.block_pattern)]
        return "attn"

    def attn_type(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Budgets:
    """Per-round resource budgets  B = (E_b, C_b, M_b, T_b)  (paper Eq. 2)."""
    energy: float = 1.2e6
    comm_mb: float = 0.60
    memory: float = 0.26
    temp: float = 1.00

    def scaled(self, factor: float = 1.0, *, energy: float = 1.0,
               comm: float = 1.0, memory: float = 1.0, temp: float = 1.0
               ) -> "Budgets":
        """Device-class budgets: ``scaled(0.5)`` is a fleet tier with half
        the allowance on every resource; keyword factors scale one axis."""
        return Budgets(energy=self.energy * factor * energy,
                       comm_mb=self.comm_mb * factor * comm,
                       memory=self.memory * factor * memory,
                       temp=self.temp * factor * temp)


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
    # --- engine (repro_torch.fl) ---
    # client execution backend: "sequential" | "batched" (vmapped clients)
    executor: str = "sequential"
    # server-update policy: "sync" (round barrier) | "fedbuff" (buffered
    # async) | "staleness" (late reports discounted, not discarded) |
    # "masked" (secure-aggregation simulation)
    aggregator: str = "sync"
    # server-side optimizer on the aggregated pseudo-gradient
    # ("" = plain averaging; "adam" / "momentum" = FedAdam / FedAvgM)
    server_opt: str = ""
    server_lr: float = 0.1
    # sparse wire format: keep the k largest-magnitude codes per
    # 256-value block (None = dense; only active at q > 0)
    wire_topk: Any = None
    # --- constraint stack (repro_torch.constraints), CAFLL only ---
    # which resources are budgeted: "paper" | "paper+wire_mb" style
    # registry specs | a sequence of names / Constraint instances | a
    # ConstraintSet
    constraints: Any = "paper"
    # dual-ascent law per constraint: "deadzone" (paper Eq. 4) |
    # "adaptive" | "pi" | a DualController
    dual_controller: Any = "deadzone"
    # duals -> knobs mapping: "paper" (Eq. 5-7) | "deadline_aware" | a
    # KnobPolicy instance
    knob_policy: Any = "paper"
    # per-constraint DualConfig overrides, e.g. {"latency": {"eta": 1.0}}
    # (None / {} = every constraint shares ``duals``)
    dual_overrides: Any = None
    # --- virtual wall clock (repro_torch.fl.clock) ---
    # "rounds": abstract rounds, the clock is accounting only;
    # "wall_clock": rounds begin when the previous barrier or buffer
    # event completes and late reports land at their arrival time
    time_mode: str = "rounds"
    # simulated-seconds budget for wall-clock runs (None = round count)
    horizon_seconds: Optional[float] = None

    def replace(self, **kw) -> "FLConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",   524_288, 1,   "decode"),
}
