"""Lagrangian dual variables and their dead-zone update (paper Eq. 3-4).

    L(w, lambda) = F(w) + sum_j lambda_j * max(0, u_j - b_j)
    lambda_j <- max(0, lambda_j + eta * dz(u_j / b_j))

The dead-zone dz(.) returns 0 inside [1 - delta, 1 + delta] and the signed
excess (u/b - 1) outside. The arithmetic is the reference's, float for
float (``repro.core.duals`` and its default controller,
``DeadzoneSubgradient``), so the duals of the two packages are equal;
that includes the band's edge, where ``1.05 - 1.0`` is
``0.050000000000000044`` and so lies outside a 0.05 band. The update law
itself lives in ``repro_torch.constraints.controllers``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from repro_torch.configs.base import Budgets, DualConfig

RESOURCES = ("energy", "comm", "memory", "temp")


def budgets_dict(budgets: Budgets) -> Dict[str, float]:
    """Budgets dataclass -> the {resource: bound} mapping the dual math
    runs on (``comm_mb`` is the ``comm`` resource)."""
    return {"energy": budgets.energy, "comm": budgets.comm_mb,
            "memory": budgets.memory, "temp": budgets.temp}


@dataclass
class DualState:
    """One multiplier per constraint (the paper's four by default)."""

    lam: Dict[str, float] = field(
        default_factory=lambda: {r: 0.0 for r in RESOURCES})


def deadzone(ratio: float, delta: float) -> float:
    """dz(u/b): signed excess outside the +-delta band around 1."""
    x = ratio - 1.0
    if abs(x) <= delta:
        return 0.0
    return x


def usage_ratios(usage: Dict[str, float], budgets: Budgets) -> Dict[str, float]:
    b = budgets_dict(budgets)
    return {r: usage[r] / b[r] for r in RESOURCES}


def dual_update(state: DualState, usage: Dict[str, float], budgets: Budgets,
                cfg: DualConfig) -> DualState:
    """One server-side dual ascent step (Algorithm 1, line 17) over the
    paper's four resources, by the default ``DeadzoneSubgradient``."""
    from repro_torch.constraints.controllers import DeadzoneSubgradient
    ctrl = DeadzoneSubgradient()
    ratios = usage_ratios(usage, budgets)
    new = {r: ctrl.step(r, state.lam[r], ratios[r], cfg) for r in RESOURCES}
    return DualState(lam=new)


def lagrangian_value(loss: float, usage: Dict[str, float], budgets: Budgets,
                     state: DualState) -> float:
    """Eq. 3 evaluated at (w, lambda), for logging."""
    b = budgets_dict(budgets)
    penalty = sum(state.lam[r] * max(0.0, usage[r] - b[r]) for r in RESOURCES)
    return loss + penalty
