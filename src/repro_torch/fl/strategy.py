"""Federated strategies: who trains with what knobs, and how updates merge.

    configure_round(rnd, clients) -> per-client Knobs      (lines 5-8)
    aggregate(deltas, weights)    -> combined delta dict   (line 15)
    update_state(usages, clients) -> per-profile duals     (line 17)

``FedAvg`` fixes the knobs and averages (``fedavg_weighted``: the
|D_i|-weighted mean); ``CAFLL`` runs the paper's Lagrangian loop with one
dual state per device profile over a pluggable constraint stack
(``repro_torch.constraints``: constraints, dual controller, knob policy,
and per-constraint ``fl.dual_overrides``); ``ServerOpt`` wraps any
strategy with a FedOpt server optimizer (FedAvgM, FedAdam) on the
aggregated pseudo-gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import FLConfig
from repro_torch.constraints import (ConstraintReport, make_constraints,
                                     make_controller, make_knob_policy,
                                     resolve_dual_configs)
from repro_torch.core import aggregation
from repro_torch.core.duals import DualState
from repro_torch.core.policy import Knobs, fedavg_knobs
from repro_torch.fl.device import DEFAULT_PROFILE, ClientInfo
from repro_torch.optim import adam, make_optimizer


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
    of its reporting clients. The stack comes from ``fl.constraints`` /
    ``fl.dual_controller`` / ``fl.knob_policy`` unless the keyword
    arguments (specs or instances) name one; the default is the paper's
    four constraints, the dead-zone law and Eq. 5-7. Each constraint
    steps with its ``fl.dual_overrides`` config, else ``fl.duals``."""

    name = "cafl"

    def __init__(self, fl: FLConfig, init_duals: Optional[DualState] = None,
                 constraints=None, controller=None, knob_policy=None):
        self.fl = fl
        self.constraints = make_constraints(
            constraints if constraints is not None else fl.constraints)
        self.controller = make_controller(
            controller if controller is not None else fl.dual_controller)
        self.knob_policy = make_knob_policy(
            knob_policy if knob_policy is not None else fl.knob_policy,
            constraints=self.constraints)
        self._dual_cfgs = resolve_dual_configs(fl.duals, fl.dual_overrides,
                                               self.constraints.names)
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
                                           self._dual_cfgs[c.name])
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


class ServerOpt(FederatedStrategy):
    """FedOpt wrapper (Reddi et al., "Adaptive Federated Optimization"):
    the inner strategy's aggregate is the negated pseudo-gradient, and a
    server optimizer steps on it. ``optimizer="momentum"`` is FedAvgM,
    ``"adam"`` FedAdam, with the large adaptivity ``eps`` (0.1) FedAdam
    needs on pseudo-gradients this small."""

    def __init__(self, inner: FederatedStrategy, optimizer: str = "adam",
                 lr: float = 0.1, eps: float = 0.1):
        self.inner = inner
        self.opt = (adam(lr, eps=eps) if optimizer == "adam"
                    else make_optimizer(optimizer, lr))
        self.name = f"{inner.name}+{optimizer}"
        self._state = None

    def configure_round(self, rnd, clients):
        return self.inner.configure_round(rnd, clients)

    def aggregate(self, deltas, weights=None):
        mean = self.inner.aggregate(deltas, weights)
        g = {k: -d for k, d in mean.items()}
        if self._state is None:
            self._state = self.opt.init(g)
        updates, self._state = self.opt.update(g, self._state, g)
        return updates

    def reset(self):
        self.inner.reset()

    def update_state(self, usages, clients):
        return self.inner.update_state(usages, clients)

    def on_dropout(self, dropped):
        self.inner.on_dropout(dropped)

    def observe_round(self, plan, reports, dynamics):
        self.inner.observe_round(plan, reports, dynamics)

    def duals_snapshot(self):
        return self.inner.duals_snapshot()

    def constraint_reports(self):
        return self.inner.constraint_reports()

    @property
    def constraints(self):
        """The inner strategy's constraint set (None for dual-free
        bases): what the engine measures."""
        return getattr(self.inner, "constraints", None)


def make_strategy(method: str, fl: FLConfig,
                  init_duals: Optional[DualState] = None,
                  constraints=None, controller=None,
                  knob_policy=None) -> FederatedStrategy:
    """Resolve a method string: "fedavg", "cafl", "fedavg_weighted",
    "fedadam", "fedavgm", or a base composed as "<base>+adam" /
    "<base>+momentum". ``fl.server_opt`` composes the same wrapper onto a
    plain name; the constraint-stack keywords override ``fl``'s for
    CAFLL bases."""
    name = method.lower()
    aliases = {"fedadam": "fedavg+adam", "fedavgm": "fedavg+momentum"}
    name = aliases.get(name, name)
    base_name, _, server = name.partition("+")
    if base_name == "fedavg":
        base: FederatedStrategy = FedAvg(fl)
    elif base_name == "fedavg_weighted":
        base = FedAvg(fl, weighted=True)
    elif base_name == "cafl":
        base = CAFLL(fl, init_duals=init_duals, constraints=constraints,
                     controller=controller, knob_policy=knob_policy)
    else:
        raise ValueError(f"unknown federated method: {method!r}")
    server = server or fl.server_opt
    if server:
        base = ServerOpt(base, optimizer=server, lr=fl.server_lr)
    return base
