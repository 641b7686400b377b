"""The constraint loop with no network in it: usage comes straight from
the calibrated Appendix-A.1 resource model, so a controller or knob
policy can be rolled forward in milliseconds. Host-only, the
reference's loop float for float.

The measurement source is the resource model's proxy dict, so the
simulated constraint set names proxy resources only (the paper's four);
constraints read from a client report (``wire_mb``, ``latency``) need
the engine.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import FLConfig
from repro_torch.constraints.constraint import ConstraintSpec, make_constraints
from repro_torch.constraints.controllers import (ControllerSpec,
                                                 make_controller,
                                                 resolve_dual_configs)
from repro_torch.constraints.knobs import KnobPolicySpec, make_knob_policy
from repro_torch.core.duals import DualState
from repro_torch.core.policy import Knobs
from repro_torch.core.resources import calibrate

# the active-parameter fit: freezing k of k_base layer groups keeps ~6%
# (embeddings / head) always trainable
ACTIVE_FLOOR = 0.06


def proxy_control_loop(fl: FLConfig, controller: ControllerSpec = "deadzone",
                       rounds: int = 80, p_base: float = 1.9e6,
                       constraints: ConstraintSpec = "paper",
                       knob_policy: KnobPolicySpec = "paper"
                       ) -> List[Tuple[Knobs, Dict[str, float]]]:
    """Roll the duals -> knobs -> usage -> duals loop forward ``rounds``
    steps; -> the per-round ``(knobs, {constraint: ratio})`` history.
    ``fl.dual_overrides`` applies as in ``CAFLL``."""
    cset = make_constraints(constraints)
    ctrl = make_controller(controller)
    pol = make_knob_policy(knob_policy, constraints=cset)
    res = calibrate(p_base, fl)
    cfgs = resolve_dual_configs(fl.duals, fl.dual_overrides, cset.names)
    duals = DualState(lam=cset.init_lam())
    history: List[Tuple[Knobs, Dict[str, float]]] = []
    for _ in range(rounds):
        kn = pol.knobs(duals, fl)
        p_active = p_base * ((1 - ACTIVE_FLOOR) * kn.k / fl.k_base
                             + ACTIVE_FLOOR)
        usage = res.usage(p_active, kn)
        ratios = cset.ratios(usage, fl.budgets)
        duals = DualState(lam={
            c.name: ctrl.step(c.name, duals.lam[c.name], ratios[c.name],
                              cfgs[c.name])
            for c in cset})
        history.append((kn, ratios))
    return history


def rounds_to_band(history: List[Tuple[Knobs, Dict[str, float]]],
                   band: float) -> Optional[int]:
    """First round (1-based) whose worst constraint ratio is <= ``band``,
    or None."""
    for i, (_, ratios) in enumerate(history):
        if max(ratios.values()) <= band:
            return i + 1
    return None


def tail_worst_ratio(history: List[Tuple[Knobs, Dict[str, float]]],
                     tail: int = 10) -> float:
    """Mean worst-constraint ratio over the last ``tail`` rounds."""
    window = history[-tail:]
    return sum(max(r.values()) for _, r in window) / len(window)
