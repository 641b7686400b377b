"""Knob policies: duals -> training knobs.

``PaperKnobPolicy`` is the paper's Eq. 5-7 mapping plus the compression
rule (``core.policy.policy``) over the constraint set's grouped duals.
The reference's ``DeadlineAwareKnobPolicy`` is not ported yet (ROADMAP
queue 8); ``make_knob_policy`` raises for it.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Union

from repro_torch.configs.base import FLConfig
from repro_torch.constraints.constraint import ConstraintSet
from repro_torch.core.duals import DualState
from repro_torch.core.policy import Knobs, policy


class KnobPolicy:
    """Maps the dual state to this round's knobs:
    ``knobs(duals, fl) -> Knobs``; ``observe(plan, reports, dynamics)``
    fires once per round after constraint accounting (default no-op)."""

    name = "base"

    def reset(self) -> None:
        pass

    def knobs(self, duals: DualState, fl: FLConfig) -> Knobs:
        raise NotImplementedError

    def observe(self, plan: Any, reports: Sequence,
                dynamics: Any) -> None:
        pass


class PaperKnobPolicy(KnobPolicy):
    """Eq. 5-7 + the compression rule over the four knob groups
    (per-constraint duals folded by ``Constraint.knob_group``; the
    identity for the paper's set)."""

    name = "paper"

    def __init__(self, constraints: Optional[ConstraintSet] = None):
        self.constraints = constraints

    def knobs(self, duals: DualState, fl: FLConfig) -> Knobs:
        lam = duals.lam
        if self.constraints is not None:
            lam = self.constraints.grouped_lam(lam)
        return policy(DualState(lam=lam), fl)


KnobPolicySpec = Union[str, KnobPolicy, None]


def _thread_constraints(pol: KnobPolicy,
                        constraints: Optional[ConstraintSet]) -> None:
    """Fill an unspecified constraint fold (``PaperKnobPolicy`` built
    with ``constraints=None``) with the strategy's set, recursing into a
    wrapper policy's ``base``; an explicit fold is left alone."""
    if constraints is None:
        return
    if isinstance(pol, PaperKnobPolicy) and pol.constraints is None:
        pol.constraints = constraints
    base = getattr(pol, "base", None)
    if isinstance(base, KnobPolicy):
        _thread_constraints(base, constraints)


def make_knob_policy(spec: KnobPolicySpec = "paper",
                     constraints: Optional[ConstraintSet] = None,
                     **kw: Any) -> KnobPolicy:
    """Resolve a knob-policy spec (``"paper"`` or an instance), threading
    the strategy's constraint set into an unspecified paper fold."""
    if spec is None:
        spec = "paper"
    if isinstance(spec, KnobPolicy):
        _thread_constraints(spec, constraints)
        return spec
    name = spec.lower()
    if name == "paper":
        return PaperKnobPolicy(constraints=constraints, **kw)
    if name in ("deadline_aware", "deadline"):
        raise NotImplementedError(
            f"knob policy {spec!r} is not ported yet (ROADMAP queue 8)")
    raise ValueError(f"unknown knob policy {spec!r}; options: paper")
