"""Policy pi(lambda) -> (k, s, b, q)  (paper Eq. 5-7 + compression rule).

    k = max(1,  k_base - floor(alpha_k (lam_C + lam_M + 0.5 lam_T)))
    s = max(10, floor(s_base (1 - beta_s (lam_E + lam_T))))
    b = max(8,  floor(b_base / (1 + gamma_b (lam_T + lam_M))))

q (compression level: 0 = 32-bit, 1 = 8-bit, 2 = 2-bit) is driven by the
communication dual — the paper states the mapping qualitatively; the
thresholds here are the config's ``q_thresholds``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.configs.base import DualConfig, FLConfig
from repro_torch.core.duals import DualState


@dataclass(frozen=True)
class Knobs:
    k: int      # unfrozen (top) layers
    s: int      # local steps
    b: int      # microbatch size
    q: int      # compression level: 0=fp32, 1=int8, 2=2-bit
    grad_accum: int = 1

    def as_dict(self):
        return {"k": self.k, "s": self.s, "b": self.b, "q": self.q,
                "grad_accum": self.grad_accum}


Q_THRESHOLDS = (0.25, 1.0)  # lam_C above these -> q=1, q=2


def policy(duals: DualState, fl: FLConfig) -> Knobs:
    """The paper's Eq. 5-7 mapping over the four canonical dual groups.
    Missing groups read as zero pressure."""
    d: DualConfig = fl.duals
    lam = duals.lam
    lam_e, lam_c, lam_m, lam_t = (lam.get("energy", 0.0), lam.get("comm", 0.0),
                                  lam.get("memory", 0.0), lam.get("temp", 0.0))
    k = max(d.k_min, fl.k_base
            - math.floor(d.alpha_k * (lam_c + lam_m + 0.5 * lam_t)))
    s = max(d.s_min, math.floor(fl.s_base * (1 - d.beta_s * (lam_e + lam_t))))
    b = max(d.b_min, math.floor(fl.b_base / (1 + d.gamma_b * (lam_t + lam_m))))
    if lam_c > Q_THRESHOLDS[1]:
        q = 2
    elif lam_c > Q_THRESHOLDS[0]:
        q = 1
    else:
        q = 0
    accum = token_budget_accum(fl, s, b)
    return Knobs(k=k, s=s, b=b, q=q, grad_accum=accum)


def token_budget_accum(fl: FLConfig, s: int, b: int) -> int:
    """Token-budget preservation (paper Eq. 8):
    grad_accum = max(1, ceil(T_target / (s * b))), T_target = s_base*b_base.
    ``fl.token_budget=False`` ablates it (grad_accum = 1).

    ``fl.token_preservation="clamped"`` rounds *down* instead: once the
    duals shrink s and b, the ceil can overshoot the target by up to
    s*b-1 tokens and inflate simulated round time ~1.5x — enough to
    starve a tight straggler deadline (see ROADMAP / the unreliable
    fleet example). Clamped mode never trains past the baseline round
    (s * grad_accum * b <= T_target whenever s*b <= T_target), trading
    a bounded token undershoot for deadline safety."""
    if fl.token_preservation not in ("ceil", "clamped"):
        raise ValueError(
            f"unknown token_preservation {fl.token_preservation!r}; "
            f"options: ceil, clamped")
    if not fl.token_budget:
        return 1
    t_target = fl.s_base * fl.b_base
    if fl.token_preservation == "clamped":
        return max(1, t_target // (s * b))
    return max(1, math.ceil(t_target / (s * b)))


def fedavg_knobs(fl: FLConfig) -> Knobs:
    """The FedAvg baseline: fixed knobs, no compression, no adaptation."""
    return Knobs(k=fl.k_base, s=fl.s_base, b=fl.b_base, q=0, grad_accum=1)
