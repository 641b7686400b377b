"""Virtual wall clock: simulated time kept beside the round loop.

    SimClock        monotone virtual time, advanced on events, every
                    advance logged
    RoundTimeModel  how long a round takes on the server's clock;
                    ``KnobRoundTime`` derives client compute times from
                    the knobs (time 1.0 = one baseline round of
                    ``s_base * b_base`` sequences on calibration silicon)

The port runs the reference's ``time_mode="rounds"``, where the clock is
pure accounting (``RoundRecord.sim_time`` / ``round_seconds``).
``"wall_clock"`` and the reference's ``EventQueue`` of in-flight late
reports that it needs are not ported yet (ROADMAP queue 8).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import FLConfig
from repro_torch.core.policy import Knobs
from repro_torch.fl.device import ClientInfo


class SimClock:
    """Monotone virtual time. ``advance_to`` clamps backwards moves to
    now and records ``(label, requested_time, clock_after)`` in
    ``events`` (at most ``max_events``; the oldest half is dropped when
    full, ``event_count`` keeps the total)."""

    def __init__(self, start: float = 0.0, max_events: int = 100_000):
        if start < 0.0 or max_events < 2:
            raise ValueError(f"need start >= 0 and max_events >= 2, got "
                             f"{start}, {max_events}")
        self._now = float(start)
        self.max_events = max_events
        self.event_count = 0
        self.events: List[Tuple[str, float, float]] = []

    @property
    def now(self) -> float:
        return self._now

    def advance_to(self, t: float, label: str = "") -> float:
        self._now = max(self._now, float(t))
        if len(self.events) >= self.max_events:
            del self.events[:self.max_events // 2]
        self.events.append((label, float(t), self._now))
        self.event_count += 1
        return self._now

    def advance(self, dt: float, label: str = "") -> float:
        if dt < 0.0:
            raise ValueError(f"negative clock step {dt!r}")
        return self.advance_to(self._now + dt, label)

    def __repr__(self) -> str:
        return f"SimClock(now={self._now:.4f}, events={len(self.events)})"


class RoundTimeModel:
    """Server-side round duration from the round's composition:
    ``client_seconds(ci, kn)`` and ``round_seconds(...)``."""

    name = "base"

    def client_seconds(self, ci: ClientInfo, kn: Knobs) -> float:
        raise NotImplementedError

    def round_seconds(self, sampled: Sequence[ClientInfo],
                      knobs: Sequence[Knobs], times: Sequence[float],
                      survivor_idx: Sequence[int],
                      deadline: Optional[float]) -> float:
        raise NotImplementedError


@dataclass
class KnobRoundTime(RoundTimeModel):
    """The default model: ``compute_scale * s * grad_accum * b /
    work_unit`` per client, the slowest survivor (or the deadline when
    someone missed it) per round, plus ``server_seconds``; a round nobody
    joined lasts ``idle_seconds``."""

    name = "knob"

    work_unit: float = 1.0
    server_seconds: float = 0.0
    idle_seconds: float = 1.0

    def __post_init__(self):
        if not (self.work_unit > 0 and self.server_seconds >= 0.0
                and self.idle_seconds > 0.0):
            raise ValueError(f"invalid {self!r}")

    @classmethod
    def for_config(cls, fl: FLConfig, **kw) -> "KnobRoundTime":
        return cls(work_unit=float(fl.s_base * fl.b_base), **kw)

    def client_seconds(self, ci, kn):
        return float(ci.profile.compute_scale
                     * (kn.s * kn.grad_accum * kn.b) / self.work_unit)

    def round_seconds(self, sampled, knobs, times, survivor_idx, deadline):
        if times:
            if len(survivor_idx) < len(times) and deadline is not None:
                dur = float(deadline)       # the barrier waited it out
            else:
                dur = max((times[i] for i in survivor_idx),
                          default=float(deadline or 0.0))
        elif sampled:
            dur = max(self.client_seconds(ci, kn)
                      for ci, kn in zip(sampled, knobs))
        else:
            dur = float(deadline) if deadline else self.idle_seconds
        if dur <= 0.0:
            dur = self.idle_seconds
        return dur + self.server_seconds


def make_round_time(spec, fl: FLConfig) -> RoundTimeModel:
    """An instance passes through; None / "knob" builds ``KnobRoundTime``
    on the config's baseline work unit."""
    if isinstance(spec, RoundTimeModel):
        return spec
    if spec is None or spec == "knob":
        return KnobRoundTime.for_config(fl)
    raise ValueError(f"unknown round-time model {spec!r}; "
                     f"options: knob, or a RoundTimeModel instance")
