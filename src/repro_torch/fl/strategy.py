"""Federated strategies: who trains with what knobs, and how updates merge.

    configure_round(rnd, clients) -> per-client Knobs      (lines 5-8)
    aggregate(deltas, weights)    -> combined delta dict   (line 15)
    update_state(usages, clients) -> per-profile duals     (line 17)

``FedAvg`` fixes the knobs and averages (``fedavg_weighted``: the
|D_i|-weighted mean); ``CAFLL`` runs the paper's Lagrangian loop with one
dual state per device profile over a pluggable constraint stack
(``repro_torch.constraints``; every constraint steps with ``fl.duals``,
the reference's ``fl.dual_overrides`` are not ported). The reference's
``ServerOpt`` (FedAdam, FedAvgM, ``<base>+adam`` / ``+momentum``) is not
ported yet (ROADMAP queue 8); ``make_strategy`` raises for it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import FLConfig
from repro_torch.constraints import (ConstraintReport, make_controller,
                                     make_knob_policy, paper_constraints)
from repro_torch.core import aggregation
from repro_torch.core.duals import DualState
from repro_torch.core.policy import Knobs, fedavg_knobs
from repro_torch.fl.device import DEFAULT_PROFILE, ClientInfo


class FederatedStrategy:
    """Base strategy: plain-mean aggregation, no state."""

    name = "base"

    def reset(self) -> None:
        """Clear per-run control transients; the engine calls this at the
        top of every ``run()``. Duals persist across runs."""

    def configure_round(self, rnd: int, clients: Sequence[ClientInfo]
                        ) -> List[Knobs]:
        raise NotImplementedError

    def aggregate(self, deltas: Sequence, weights: Optional[List[float]] = None):
        """Pure delta combination; the base strategy ignores ``weights``
        (the paper's plain mean)."""
        return aggregation.aggregate(deltas)

    def update_state(self, usages: Sequence[Dict[str, float]],
                     clients: Sequence[ClientInfo]) -> Dict[str, Dict[str, float]]:
        """Consume the round's per-client constraint measurements; returns
        the per-profile dual snapshot ({} for dual-free strategies)."""
        return {}

    def on_dropout(self, dropped: Sequence[ClientInfo]) -> None:
        """Observe clients that were sampled but whose report was lost."""

    def observe_round(self, plan, reports: Sequence, dynamics) -> None:
        """Round telemetry hook, fired after constraint accounting."""

    def duals_snapshot(self) -> Dict[str, Dict[str, float]]:
        return {}

    def constraint_reports(self) -> Dict[str, List[ConstraintReport]]:
        return {}


class FedAvg(FederatedStrategy):
    """The baseline: fixed knobs, no compression, no adaptation.
    ``weighted=True`` gives the |D_i|-weighted variant (Eq. 1)."""

    name = "fedavg"

    def __init__(self, fl: FLConfig, weighted: bool = False):
        self.fl = fl
        self.weighted = weighted

    def configure_round(self, rnd, clients):
        kn = fedavg_knobs(self.fl)
        return [kn] * len(clients)

    def aggregate(self, deltas, weights=None):
        return aggregation.aggregate(deltas, weights if self.weighted else None)


class CAFLL(FederatedStrategy):
    """The paper's constraint-aware loop: one ``DualState`` per device
    profile, updated against that profile's budgets with the mean usage
    of its reporting clients, over the paper's stack: its four
    constraints, the dead-zone law and Eq. 5-7 (the reference's other
    stacks are not ported yet, ROADMAP queue 8)."""

    name = "cafl"

    def __init__(self, fl: FLConfig, init_duals: Optional[DualState] = None):
        self.fl = fl
        self.constraints = paper_constraints()
        self.controller = make_controller("deadzone")
        self.knob_policy = make_knob_policy("paper",
                                            constraints=self.constraints)
        self.duals: Dict[str, DualState] = {}
        self._last_reports: Dict[str, List[ConstraintReport]] = {}
        if init_duals is not None:
            self.duals[DEFAULT_PROFILE] = init_duals

    def reset(self):
        self.controller.reset()
        self.knob_policy.reset()
        self._last_reports = {}

    def duals_for(self, profile_name: str) -> DualState:
        return self.duals.setdefault(
            profile_name, DualState(lam=self.constraints.init_lam()))

    def configure_round(self, rnd, clients):
        per_profile = {}
        for ci in clients:
            name = ci.profile.name
            if name not in per_profile:
                per_profile[name] = self.knob_policy.knobs(
                    self.duals_for(name), self.fl)
        return [per_profile[ci.profile.name] for ci in clients]

    def update_state(self, usages, clients):
        by_profile: Dict[str, list] = {}
        for u, ci in zip(usages, clients):
            by_profile.setdefault(ci.profile.name, []).append((u, ci.profile))
        self._last_reports = {}
        for name, entries in by_profile.items():
            us = [u for u, _ in entries]
            profile = entries[0][1]
            state = self.duals_for(name)
            new_lam = dict(state.lam)
            reports = []
            for c in self.constraints:
                mean = sum(u[c.name] for u in us) / len(us)
                budget = c.budget_of(profile.budgets)
                ratio = mean / budget
                prev = state.lam.get(c.name, 0.0)
                lam = self.controller.step(f"{name}:{c.name}", prev, ratio,
                                           self.fl.duals)
                new_lam[c.name] = lam
                reports.append(ConstraintReport(
                    name=c.name, profile=name, usage=mean, budget=budget,
                    ratio=ratio, lam_prev=prev, lam=lam,
                    violated=ratio > 1.0))
            self.duals[name] = DualState(lam=new_lam)
            self._last_reports[name] = reports
        return self.duals_snapshot()

    def observe_round(self, plan, reports, dynamics):
        self.knob_policy.observe(plan, reports, dynamics)

    def duals_snapshot(self):
        return {name: dict(st.lam) for name, st in self.duals.items()}

    def constraint_reports(self):
        return self._last_reports


def make_strategy(method: str, fl: FLConfig,
                  init_duals: Optional[DualState] = None
                  ) -> FederatedStrategy:
    """Resolve a method string: "fedavg", "fedavg_weighted" or "cafl".
    Server optimizers ("fedadam", "fedavgm", "<base>+adam",
    "<base>+momentum") raise: not ported yet (ROADMAP queue 8)."""
    name = method.lower()
    base_name, _, server = name.partition("+")
    if name in ("fedadam", "fedavgm") or server:
        raise NotImplementedError(
            f"server optimizer {method!r} is not ported yet "
            f"(ROADMAP queue 8)")
    if base_name == "fedavg":
        return FedAvg(fl)
    if base_name == "fedavg_weighted":
        return FedAvg(fl, weighted=True)
    if base_name == "cafl":
        return CAFLL(fl, init_duals=init_duals)
    raise ValueError(f"unknown federated method: {method!r}")
