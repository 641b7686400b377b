"""Virtual wall clock: simulated time as an engine axis.

    SimClock        monotone virtual time, advanced on events, every
                    advance logged
    RoundTimeModel  how long a round takes on the server's clock;
                    ``KnobRoundTime`` derives client compute times from
                    the knobs (time 1.0 = one baseline round of
                    ``s_base * b_base`` sequences on calibration silicon)
    EventQueue      in-flight late reports (``TimedReport``), ordered
                    by arrival time, then stamping order

In ``time_mode="rounds"`` the clock is pure accounting
(``RoundRecord.sim_time`` / ``round_seconds``). In ``"wall_clock"`` a
barrier round lasts until its survivors reported (or the deadline, when
someone missed it), a buffered-async round ends at its first mid-round
server update, and a late report lands at its simulated arrival time.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import FLConfig
from repro_torch.core.policy import Knobs
from repro_torch.fl.device import ClientInfo

TIME_MODES = ("rounds", "wall_clock")


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


@dataclass(frozen=True)
class TimedReport:
    """One in-flight client report on the wall-clock event queue.
    ``seq`` is the stamping order, which resolves simultaneous arrivals
    (a homogeneous cohort delivers in cohort order, as in rounds mode);
    ``tie`` sits between ``arrival`` and ``seq`` in the sort key and is
    0.0 unless a caller stamps its own tie-breaks."""
    arrival: float                # absolute simulated arrival time
    report: object                # the ClientReport to deliver
    seq: int = 0                  # tie-break: stamping order
    tie: float = 0.0              # caller-chosen tie-break

    def sort_key(self):
        return (self.arrival, self.tie, self.seq)


@dataclass
class EventQueue:
    """Arrival-ordered pending reports: ``push`` never drops,
    ``pop_until`` returns every event at or before the cutoff exactly
    once, ``drain`` empties the queue."""

    _items: List[TimedReport] = field(default_factory=list)
    _seq: int = 0

    def stamp(self, arrival: float, report) -> TimedReport:
        """Mint an ordered event without queueing it. A NaN or infinite
        arrival raises: it would mis-sort and never be delivered."""
        arrival = float(arrival)
        if not math.isfinite(arrival):
            raise ValueError(
                f"event arrival time must be finite, got {arrival!r}; "
                f"NaN/inf arrivals silently mis-sort the event queue")
        ev = TimedReport(arrival, report, self._seq)
        self._seq += 1
        return ev

    def push(self, arrival: float, report) -> None:
        """Queue a report for delivery at ``arrival`` (>= 0)."""
        if float(arrival) < 0.0:
            raise ValueError(
                f"event arrival time must be >= 0, got {arrival!r}; "
                f"simulated time starts at 0.0 and never runs backwards")
        self._items.append(self.stamp(arrival, report))

    def push_event(self, ev: TimedReport) -> None:
        self._items.append(ev)

    def pop_until(self, cutoff: float) -> List[TimedReport]:
        due = sorted((e for e in self._items if e.arrival <= cutoff),
                     key=TimedReport.sort_key)
        self._items = [e for e in self._items if e.arrival > cutoff]
        return due

    def drain(self) -> List[TimedReport]:
        out = sorted(self._items, key=TimedReport.sort_key)
        self._items = []
        return out

    def __len__(self) -> int:
        return len(self._items)


def seconds_to_target(result, target: float) -> Optional[float]:
    """First simulated time at which a run's val loss reached ``target``,
    or None. A record's ``val_loss`` is measured at round start, so a hit
    charges the round's start ``sim_time - round_seconds``; the final
    record's loss is re-evaluated after the last update and charges the
    full clock."""
    history = result.history
    if not history:
        return None
    for r in history[:-1]:
        if r.val_loss <= target:
            return r.sim_time - r.round_seconds
    last = history[-1]
    return last.sim_time if last.val_loss <= target else None


def make_round_time(spec, fl: FLConfig) -> RoundTimeModel:
    """An instance passes through; None / "knob" builds ``KnobRoundTime``
    on the config's baseline work unit."""
    if isinstance(spec, RoundTimeModel):
        return spec
    if spec is None or spec == "knob":
        return KnobRoundTime.for_config(fl)
    raise ValueError(f"unknown round-time model {spec!r}; "
                     f"options: knob, or a RoundTimeModel instance")
