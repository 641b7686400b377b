"""Knob policies: duals -> training knobs (and the server deadline).

``PaperKnobPolicy`` is the paper's Eq. 5-7 mapping plus the compression
rule (``core.policy.policy``) over the constraint set's grouped duals.
``DeadlineAwareKnobPolicy`` wraps any base policy and steers the
straggler deadline from each round's telemetry: it widens the deadline
when too few clients report (the dual update starves without reports)
and, with a ``latency`` constraint registered, tightens it from that
constraint's dual. The arithmetic is the reference's, float for float.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Union

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

    def state_snapshot(self) -> Dict[str, Any]:
        return {"name": self.name}


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


class DeadlineAwareKnobPolicy(KnobPolicy):
    """Dual-aware deadline control around a base policy.

    Each round it reads the reported fraction of the sampled cohort.
    Below ``min_report_frac`` it widens the deadline, by at least
    ``widen`` and up to the arrival time the target fraction needed
    (``plan.times``) times ``headroom``, capped at ``max_scale`` x the
    original deadline. When everyone reports it relaxes by ``relax`` a
    round, never below what the slowest arrival needed. With a latency
    dual ``lam > 0`` (``knobs`` records the worst across profiles) and
    enough reports, it pulls the scale toward ``latency_budget /
    base_deadline`` with weight ``min(1, latency_gain * lam)``, floored
    at ``min_scale``; once the pressure is gone a scale below 1 drifts
    back at the ``relax`` rate. The knobs themselves come from ``base``.
    ``reset`` restores the original deadline."""

    name = "deadline_aware"

    def __init__(self, base: Optional[KnobPolicy] = None,
                 min_report_frac: float = 0.5, widen: float = 1.3,
                 max_scale: float = 4.0, relax: float = 0.9,
                 headroom: float = 1.05, latency_name: str = "latency",
                 latency_gain: float = 0.5, latency_budget: float = 1.0,
                 min_scale: float = 0.25):
        if not (0.0 < min_report_frac <= 1.0 and widen > 1.0
                and max_scale >= 1.0 and 0.0 < relax <= 1.0
                and headroom >= 1.0 and latency_gain >= 0.0
                and latency_budget > 0.0 and 0.0 < min_scale <= 1.0):
            raise ValueError("DeadlineAwareKnobPolicy: a setting is out of "
                             "range")
        self.base = base or PaperKnobPolicy()
        self.min_report_frac = min_report_frac
        self.widen = widen
        self.max_scale = max_scale
        self.relax = relax
        self.headroom = headroom
        self.latency_name = latency_name
        self.latency_gain = latency_gain
        self.latency_budget = latency_budget
        self.min_scale = min_scale
        self.scale = 1.0
        self._base_deadline: Optional[float] = None
        self._strag = None              # the straggler model we steer
        self._latency_lam = 0.0         # worst latency dual this round
        self._last_latency_lam = 0.0    # pressure the last observe applied

    def reset(self) -> None:
        self.base.reset()
        if self._strag is not None and self._base_deadline is not None:
            self._strag.deadline = self._base_deadline
        self.scale = 1.0
        self._base_deadline = None
        self._strag = None
        self._latency_lam = 0.0
        self._last_latency_lam = 0.0

    def knobs(self, duals: DualState, fl: FLConfig) -> Knobs:
        self._latency_lam = max(self._latency_lam,
                                duals.lam.get(self.latency_name, 0.0))
        return self.base.knobs(duals, fl)

    def _needed_scale(self, time: float) -> float:
        return time * self.headroom / self._base_deadline

    def observe(self, plan: Any, reports: Sequence,
                dynamics: Any) -> None:
        lam, self._latency_lam = self._latency_lam, 0.0
        self._last_latency_lam = lam
        strag = getattr(dynamics, "stragglers", None)
        deadline = getattr(strag, "deadline", None)
        if deadline is None or not plan.sampled:
            return                      # no deadline to control
        if self._base_deadline is None:
            self._base_deadline = deadline
            self._strag = strag
        frac = len(plan.survivors) / len(plan.sampled)
        if frac < self.min_report_frac:
            scale = self.scale * self.widen
            if plan.times:
                k = max(0, math.ceil(self.min_report_frac
                                     * len(plan.times)) - 1)
                scale = max(scale, self._needed_scale(sorted(plan.times)[k]))
            self.scale = min(self.max_scale, scale)
        elif frac >= 1.0 and self.scale > 1.0:
            floor = max((self._needed_scale(t) for t in plan.times),
                        default=1.0)
            self.scale = min(self.scale,
                             max(1.0, self.scale * self.relax, floor))
        if lam > 0.0 and frac >= self.min_report_frac:
            target = max(self.min_scale,
                         self.latency_budget / self._base_deadline)
            w = min(1.0, self.latency_gain * lam)
            pulled = (1.0 - w) * self.scale + w * target
            self.scale = max(self.min_scale, min(self.scale, pulled))
        elif lam <= 0.0 and self.scale < 1.0 and \
                frac >= self.min_report_frac:
            self.scale = min(1.0, self.scale / self.relax)
        strag.deadline = self._base_deadline * self.scale

    def state_snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "scale": self.scale,
                "base_deadline": self._base_deadline,
                "latency_lam": self._last_latency_lam,
                "base_policy": self.base.state_snapshot()}


KNOB_POLICIES = ("paper", "deadline_aware")

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
    """Resolve a knob-policy spec (``"paper"``, ``"deadline_aware"`` or an
    instance), threading the strategy's constraint set into an
    unspecified paper fold."""
    if spec is None:
        spec = "paper"
    if isinstance(spec, KnobPolicy):
        _thread_constraints(spec, constraints)
        return spec
    name = spec.lower()
    if name == "paper":
        return PaperKnobPolicy(constraints=constraints, **kw)
    if name in ("deadline_aware", "deadline"):
        kw.setdefault("base", PaperKnobPolicy(constraints=constraints))
        return DeadlineAwareKnobPolicy(**kw)
    raise ValueError(f"unknown knob policy {spec!r}; "
                     f"options: {', '.join(KNOB_POLICIES)}")
