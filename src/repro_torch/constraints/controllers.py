"""Dual controllers: how a constraint's multiplier answers its ratio.

``DeadzoneSubgradient`` is the paper's Eq. 4, float for float the
reference's (including the band's edge: ``abs(ratio - 1.0) <= delta``,
where ``1.05 - 1.0`` lies just outside a 0.05 band). The reference's
``AdaptiveStep`` and ``PIController`` are not ported yet (ROADMAP
queue 8); ``make_controller`` raises for them.
"""
from __future__ import annotations

from typing import Any, Union

from repro_torch.configs.base import DualConfig
from repro_torch.core.duals import deadzone


class DualController:
    """One dual-ascent law, applied independently per constraint:
    ``step(key, lam, ratio, cfg) -> new lambda``. ``key`` names the
    (profile, constraint) stream for stateful laws."""

    name = "base"

    def reset(self) -> None:
        pass

    def step(self, key: str, lam: float, ratio: float,
             cfg: DualConfig) -> float:
        raise NotImplementedError


class DeadzoneSubgradient(DualController):
    """The paper's Eq. 4: lambda <- clip(lambda + eta * dz(u/b)).
    Stateless."""

    name = "deadzone"

    def step(self, key: str, lam: float, ratio: float,
             cfg: DualConfig) -> float:
        lam = lam + cfg.eta * deadzone(ratio, cfg.deadzone)
        return float(min(max(lam, 0.0), cfg.lambda_max))


ControllerSpec = Union[str, DualController, None]


def make_controller(spec: ControllerSpec = "deadzone",
                    **kw: Any) -> DualController:
    """Resolve a controller spec: an instance passes through;
    ``"deadzone"`` names the paper's law."""
    if spec is None:
        return DeadzoneSubgradient()
    if isinstance(spec, DualController):
        return spec
    name = spec.lower()
    if name in ("deadzone", "subgradient"):
        return DeadzoneSubgradient(**kw)
    if name in ("adaptive", "pi"):
        raise NotImplementedError(
            f"dual controller {spec!r} is not ported yet (ROADMAP queue 8)")
    raise ValueError(f"unknown dual controller {spec!r}; options: deadzone")
