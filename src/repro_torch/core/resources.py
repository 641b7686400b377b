"""Resource-usage proxies (paper Appendix A.1) + calibration.

    E ~ alpha_E * params_active * s * b
    C ~ sparsity * params_active * bytes_per_param(q)
    M ~ alpha_M * (0.2 + beta_M * params_active * b)
    T ~ alpha_T * (0.35 + gamma_T * s + delta_T * b)

The paper reports *relative units* "derived from these proxies" and says
constants "can be adapted or re-scaled for specific device profiles".
``calibrate`` pins the constants so the FedAvg baseline reproduces the
paper's Table 1 FedAvg row exactly (E 4.52e6, C 5.18 MB, T 0.62, M 0.31)
given *our* model's true active-parameter count — this preserves every
violation ratio the paper reports while staying honest about parameter
counts.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import FLConfig
from repro_torch.core.policy import Knobs

BYTES_PER_PARAM = {0: 4.0, 1: 1.0, 2: 0.25}

# Table 1 "FedAvg" row — calibration targets.
TABLE1_FEDAVG = {"energy": 4.52e6, "comm": 5.18, "temp": 0.62, "memory": 0.31}


@dataclass(frozen=True)
class ResourceModel:
    alpha_e: float
    kappa_c: float          # MB per (param * byte)
    sparsity: float
    alpha_m: float
    beta_m: float
    alpha_t: float
    gamma_t: float
    delta_t: float

    def usage(self, params_active: float, knobs: Knobs,
              include_accum: bool = False) -> Dict[str, float]:
        """Per-client usage for one round. ``include_accum`` is the
        beyond-paper 'true compute' variant: the paper's proxy (A.1)
        deliberately charges energy for s*b only, not the accumulated
        microbatches."""
        s_eff = knobs.s * (knobs.grad_accum if include_accum else 1)
        e = self.alpha_e * params_active * s_eff * knobs.b
        c = self.sparsity * params_active * BYTES_PER_PARAM[knobs.q] * self.kappa_c
        m = self.alpha_m * (0.2 + self.beta_m * params_active * knobs.b)
        t = self.alpha_t * (0.35 + self.gamma_t * s_eff + self.delta_t * knobs.b)
        return {"energy": e, "comm": c, "memory": m, "temp": t}

    def scaled(self, energy: float = 1.0, comm: float = 1.0,
               memory: float = 1.0, temp: float = 1.0) -> "ResourceModel":
        """Per-device-class efficiency variant (>1 = less efficient than
        the calibration device); ``fl.device`` profiles use it."""
        return dataclasses.replace(
            self, alpha_e=self.alpha_e * energy, kappa_c=self.kappa_c * comm,
            alpha_m=self.alpha_m * memory, alpha_t=self.alpha_t * temp)


def calibrate(params_active_base: float, fl: FLConfig) -> ResourceModel:
    """Pin proxy constants to the paper's Table 1 FedAvg row at the
    baseline knobs (k_base: all params active, s_base, b_base, q=0)."""
    s, b = fl.s_base, fl.b_base
    p = float(params_active_base)
    alpha_e = TABLE1_FEDAVG["energy"] / (p * s * b)
    kappa_c = TABLE1_FEDAVG["comm"] / (p * BYTES_PER_PARAM[0])
    # memory: floor 0.2 (activations/runtime) + param*batch term = 0.31
    alpha_m = 1.0
    beta_m = (TABLE1_FEDAVG["memory"] - 0.2) / (p * b)
    # temperature: floor 0.35, remaining 0.27 split evenly between s and b
    alpha_t = 1.0
    rem = TABLE1_FEDAVG["temp"] - 0.35
    gamma_t = (rem / 2) / s
    delta_t = (rem / 2) / b
    return ResourceModel(alpha_e=alpha_e, kappa_c=kappa_c, sparsity=1.0,
                         alpha_m=alpha_m, beta_m=beta_m, alpha_t=alpha_t,
                         gamma_t=gamma_t, delta_t=delta_t)
