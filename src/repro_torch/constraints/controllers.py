"""Dual controllers: how a constraint's multiplier answers its ratio.

A ``DualController`` maps the dead-zoned usage ratio ``dz(u/b)`` to the
next multiplier, for every constraint of every device profile; a
stateful law keys its state by ``"profile:constraint"``. Every law keeps
``0 <= lambda <= lambda_max``.

    DeadzoneSubgradient  the paper's Eq. 4
    AdaptiveStep         the step scaled by the violation's size
    PIController         positional PI on the dead-zoned error, with an
                         anti-windup clamp on the integral

The arithmetic is the reference's, float for float (including the
band's edge: ``abs(ratio - 1.0) <= delta``, where ``1.05 - 1.0`` lies
just outside a 0.05 band), so the duals of the two packages are equal.
``dual_config_for`` / ``resolve_dual_configs`` apply
``fl.dual_overrides``: one constraint's own ``DualConfig``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

import torch

from repro_torch.configs.base import DualConfig
from repro_torch.core.duals import deadzone


def _clip(lam: float, cfg: DualConfig) -> float:
    return float(min(max(lam, 0.0), cfg.lambda_max))


def dual_config_for(base: DualConfig, overrides: Optional[Mapping[str, Any]],
                    name: str) -> DualConfig:
    """Constraint ``name``'s effective DualConfig: ``overrides[name]`` is
    a full ``DualConfig`` or a dict of field overrides on ``base`` (an
    unknown field raises ``TypeError``)."""
    if not overrides or name not in overrides:
        return base
    ov = overrides[name]
    if isinstance(ov, DualConfig):
        return ov
    return dataclasses.replace(base, **dict(ov))


def resolve_dual_configs(base: DualConfig,
                         overrides: Optional[Mapping[str, Any]],
                         names: Iterable[str]) -> Dict[str, DualConfig]:
    """Every constraint's effective DualConfig; an override keyed by a
    name outside ``names`` raises."""
    names = tuple(names)
    unknown = set(overrides or ()) - set(names)
    if unknown:
        raise ValueError(
            f"fl.dual_overrides names unregistered constraints "
            f"{sorted(unknown)}; this stack has {list(names)}")
    return {n: dual_config_for(base, overrides, n) for n in names}


class DualController:
    """One dual-ascent law, applied independently per constraint:
    ``step(key, lam, ratio, cfg) -> new lambda``. ``key`` names the
    (profile, constraint) stream for stateful laws; ``reset`` clears
    their state."""

    name = "base"

    def reset(self) -> None:
        pass

    def step(self, key: str, lam: float, ratio: float,
             cfg: DualConfig) -> float:
        raise NotImplementedError

    def state_snapshot(self) -> Dict[str, Any]:
        return {"name": self.name}


class DeadzoneSubgradient(DualController):
    """The paper's Eq. 4: lambda <- clip(lambda + eta * dz(u/b)).
    Stateless."""

    name = "deadzone"

    def step(self, key: str, lam: float, ratio: float,
             cfg: DualConfig) -> float:
        lam = lam + cfg.eta * deadzone(ratio, cfg.deadzone)
        return float(min(max(lam, 0.0), cfg.lambda_max))


class AdaptiveStep(DualController):
    """Violation-scaled subgradient: the step is
    ``eta * min(1 + gain * |dz|, max_scale) * dz``, the paper's law near
    the band and up to ``max_scale`` times faster far from it."""

    name = "adaptive"

    def __init__(self, gain: float = 2.0, max_scale: float = 5.0):
        if not (gain >= 0.0 and max_scale >= 1.0):
            raise ValueError(f"need gain >= 0 and max_scale >= 1, got "
                             f"{gain}, {max_scale}")
        self.gain = gain
        self.max_scale = max_scale

    def step(self, key: str, lam: float, ratio: float,
             cfg: DualConfig) -> float:
        dz = deadzone(ratio, cfg.deadzone)
        scale = min(self.max_scale, 1.0 + self.gain * abs(dz))
        return _clip(lam + cfg.eta * scale * dz, cfg)


class PIController(DualController):
    """Positional PI on the dead-zoned error:

        I_t    = clip(I_{t-1} + dz, 0, lambda_max / ki)   (anti-windup)
        lambda = clip(kp * dz + ki * I_t)

    with ``kp = kp_scale * eta`` and ``ki = ki_scale * eta``. A stream's
    integral starts at ``lam / ki``, so a warm start is held; inside the
    band (dz = 0) the integral does not move."""

    name = "pi"

    def __init__(self, kp_scale: float = 2.0, ki_scale: float = 1.0):
        if kp_scale < 0.0 or ki_scale < 0.0:
            raise ValueError(f"PI gains must be >= 0, got {kp_scale}, "
                             f"{ki_scale}")
        if not (kp_scale > 0.0 or ki_scale > 0.0):
            raise ValueError("PI with both gains 0")
        self.kp_scale = kp_scale
        self.ki_scale = ki_scale
        self._integral: Dict[str, float] = {}

    def reset(self) -> None:
        self._integral.clear()

    def step(self, key: str, lam: float, ratio: float,
             cfg: DualConfig) -> float:
        dz = deadzone(ratio, cfg.deadzone)
        kp = self.kp_scale * cfg.eta
        ki = self.ki_scale * cfg.eta
        i = self._integral.get(key)
        if i is None:
            i = (lam / ki) if ki > 0.0 else 0.0
        if dz != 0.0:
            i = i + dz
            if ki > 0.0:
                i = min(max(i, 0.0), cfg.lambda_max / ki)
        self._integral[key] = i
        return _clip(kp * dz + ki * i, cfg)

    def state_snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "integrals": dict(self._integral)}


def dual_step_torch(lam: torch.Tensor, ratio: torch.Tensor, eta: float,
                    delta: float, lambda_max: float) -> torch.Tensor:
    """Traceable (vectorised) twin of ``DeadzoneSubgradient.step``, the
    counterpart of the reference's ``dual_step_jnp``: the paper's Eq. 4
    over a whole constraint stack at once,

        lambda <- clip(lambda + eta * dz(ratio), 0, lambda_max),

    in the tensors' dtype, with the reference's arithmetic (the band's
    edge is ``abs(ratio - 1.0) <= delta``, so in f32 a ratio of 1.05
    lies inside a 0.05 band, as in ``dual_step_jnp``; in f64 outside,
    as in the scalar law)."""
    x = ratio - 1.0
    dz = torch.where(torch.abs(x) <= delta, torch.zeros_like(x), x)
    return torch.clamp(lam + eta * dz, 0.0, lambda_max)


# ---------------------------------------------------------------------------
# trace-analysis entry points (repro_torch.analysis.trace)
# ---------------------------------------------------------------------------


def _dual_build() -> Any:
    from repro_torch.configs import get_fl_config
    cfg = get_fl_config().duals

    def fn(lam: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
        return dual_step_torch(lam, ratio, cfg.eta, cfg.deadzone,
                               cfg.lambda_max)

    lam = torch.tensor([0.0, 0.5, 1.0, 2.0], dtype=torch.float32)
    ratio = torch.tensor([0.5, 1.0, 1.05, 1.3], dtype=torch.float32)
    return fn, (lam, ratio)


def trace_entry_points() -> List[Any]:
    """Declared traceable surface: one dual ascent step over the paper's
    four multipliers."""
    from repro_torch.analysis.trace.registry import EntryPoint, anchor
    return [EntryPoint(
        name="constraints.dual_update", **anchor(dual_step_torch),
        build=_dual_build, note="Eq. 4 dead-zoned dual ascent, 4 constraints")]


CONTROLLERS = ("deadzone", "adaptive", "pi")

ControllerSpec = Union[str, DualController, None]


def make_controller(spec: ControllerSpec = "deadzone",
                    **kw: Any) -> DualController:
    """Resolve a controller spec: an instance passes through; strings
    name a law ("deadzone", "adaptive", "pi")."""
    if spec is None:
        return DeadzoneSubgradient()
    if isinstance(spec, DualController):
        return spec
    name = spec.lower()
    if name in ("deadzone", "subgradient"):
        return DeadzoneSubgradient(**kw)
    if name == "adaptive":
        return AdaptiveStep(**kw)
    if name == "pi":
        return PIController(**kw)
    raise ValueError(f"unknown dual controller {spec!r}; "
                     f"options: {', '.join(CONTROLLERS)}")
