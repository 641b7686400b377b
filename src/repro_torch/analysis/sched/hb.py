"""Happens-before model of one engine run of the port.

The reference's model (``repro.analysis.sched.hb``) over the port's
engine: it reads ``engine.clock`` (``SimClock.events`` /
``event_count``) and hooks ``repro_torch.fl.callbacks.RoundCallback``.

A wall-clock run is a sequence of events — report deliveries, server
updates (applies), dual updates, round boundaries — whose *processing*
order is one of many legal linearizations: simultaneous arrivals could
have been delivered in any order. This module reconstructs the partial
order that is actually forced by the physics:

    time        e1 -> e2 when e1's clock reading is strictly earlier
    per client  a client's deliveries are sequenced (one device)
    rounds      round_start(r) -> every event of r -> round_end(r) ->
                round_start(r+1)
    causality   a delivery -> the apply that folded its report;
                an apply -> the round's dual update

Everything the partial order leaves *unordered* is schedule freedom:
the engine had to pick an order (``TimedReport.sort_key``), and any
state both events touch had better not care. ``HBGraph.races`` checks
exactly that: an unordered pair touching the same aggregator/strategy
state is benign only under the aggregator's declared ``commutativity``
certificate ("exact" / "canonical" / "tiebreak" — see
``repro_torch.fl.aggregator``); an undeclared policy is flagged as a race.

The event stream comes from two sources merged by clock position:
``SimClock``'s event log (deliveries — the engine labels them
``deliver:c<id>``) and a ``ScheduleRecorder`` callback (round
boundaries, applies, dual updates, which the clock log does not
attribute). The ``SchedulePermuter`` (sibling module) is the dynamic
complement: it *exercises* the schedule freedom this model identifies.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.fl.callbacks import RoundCallback

#: which shared state each event kind's handler touches
_TOUCHES: Dict[str, Tuple[str, ...]] = {
    "deliver": ("aggregator",),
    "apply": ("aggregator", "params"),
    "dual": ("duals",),
    "round_start": (),
    "round_end": (),
}


@dataclass(frozen=True)
class SchedEvent:
    """One event of a recorded run, in processing order."""

    kind: str            # deliver | apply | dual | round_start | round_end
    round: int
    time: float          # clock reading when processed (monotone)
    index: int           # global processing position
    client: int = -1     # deliver: the reporting client
    clients: Tuple[int, ...] = ()   # apply: clients folded in

    @property
    def touches(self) -> Tuple[str, ...]:
        return _TOUCHES.get(self.kind, ())

    def __str__(self) -> str:
        who = (f" c{self.client}" if self.client >= 0 else
               (f" {list(self.clients)}" if self.clients else ""))
        return (f"[{self.index}] r{self.round} t={self.time:.4f} "
                f"{self.kind}{who}")


@dataclass(frozen=True)
class SchedRace:
    """Two HB-unordered events touching the same state."""

    a: SchedEvent
    b: SchedEvent
    state: Tuple[str, ...]
    certified: bool
    via: str             # the certificate (or why it is missing)

    def describe(self) -> str:
        verdict = ("certified: " + self.via if self.certified
                   else "RACE: " + self.via)
        return (f"{self.a} || {self.b} on {'/'.join(self.state)} "
                f"({verdict})")


class ScheduleRecorder(RoundCallback):
    """Records the run-side events the clock log cannot attribute.

    Each marker remembers ``clock.event_count`` at hook time, so the
    markers interleave with the clock's delivery events by position —
    not by timestamp, which would lose the processing order of
    time-equal events."""

    def __init__(self):
        self.markers: List[Tuple[int, str, int, float, Tuple[int, ...]]] = []
        self._round = 0

    def on_train_start(self, engine: Any) -> None:
        self.markers = []
        self._round = 0

    def _mark(self, engine: Any, kind: str, rnd: int,
              clients: Tuple[int, ...] = ()) -> None:
        clock = engine.clock
        self.markers.append((clock.event_count, kind, rnd,
                             float(clock.now), clients))

    def on_round_start(self, engine: Any, rnd: int) -> None:
        self._round = rnd
        self._mark(engine, "round_start", rnd)

    def on_server_update(self, engine: Any, update: Any) -> None:
        self._mark(engine, "apply", update.round,
                   tuple(r.client.client_id for r in update.reports))

    def on_dual_update(self, engine: Any, rnd: int,
                       creports: Any) -> None:
        self._mark(engine, "dual", rnd)

    def on_round_end(self, engine: Any, record: Any) -> None:
        self._mark(engine, "round_end", record.round)

    # ------------------------------------------------------------------
    def events(self, engine: Any) -> List[SchedEvent]:
        """Merge the clock's delivery log with the recorded markers
        into the full processing-ordered event stream."""
        clock = engine.clock
        if clock is None:
            return []
        if clock.event_count != len(clock.events):
            raise ValueError(
                f"SimClock log truncated ({clock.event_count} events, "
                f"{len(clock.events)} kept) — raise max_events to "
                f"analyze this run")
        out: List[SchedEvent] = []
        mi = 0
        rnd = 0

        def flush_markers(upto: int) -> None:
            nonlocal mi, rnd
            while mi < len(self.markers) and self.markers[mi][0] <= upto:
                _, kind, mrnd, mtime, clients = self.markers[mi]
                if kind == "round_start":
                    rnd = mrnd
                out.append(SchedEvent(kind=kind, round=mrnd, time=mtime,
                                      index=len(out), clients=clients))
                mi += 1

        for ci, (label, _requested, after) in enumerate(clock.events):
            flush_markers(ci)
            if label.startswith("deliver:c"):
                out.append(SchedEvent(kind="deliver", round=rnd,
                                      time=float(after), index=len(out),
                                      client=int(label[len("deliver:c"):])))
            # round_end clock ticks are covered by the recorder marker
        flush_markers(len(clock.events))
        return out


def build_hb_graph(engine: Any,
                   recorder: ScheduleRecorder) -> "HBGraph":
    return HBGraph(recorder.events(engine))


@dataclass
class HBGraph:
    """The happens-before partial order over a recorded event stream.

    Events are in processing order and times are monotone in that
    order, so every edge points forward and the closure is one
    backward sweep over successor bitsets."""

    events: List[SchedEvent]
    _closure: List[int] = field(default_factory=list, repr=False)

    def __post_init__(self):
        n = len(self.events)
        direct = [0] * n
        ev = self.events

        def edge(i: int, j: int) -> None:
            if i != j:
                direct[i] |= 1 << j

        last_by_client: Dict[int, int] = {}
        last_round_start: Dict[int, int] = {}
        for j, e in enumerate(ev):
            # strict time order: anything at an earlier clock reading
            # happened before. Times are monotone in processing order,
            # so it suffices to link j to every member of the nearest
            # strictly-earlier time plateau (that plateau links to the
            # one before it, and the closure does the rest); events on
            # j's own plateau stay unordered unless another rule
            # sequences them — that is the schedule freedom.
            i = j - 1
            while i >= 0 and ev[i].time >= e.time:
                i -= 1
            if i >= 0:
                plateau = ev[i].time
                while i >= 0 and ev[i].time == plateau:
                    edge(i, j)
                    i -= 1
            if e.kind == "round_start":
                last_round_start[e.round] = j
                # previous round's end precedes
                for i in range(j - 1, -1, -1):
                    if ev[i].kind == "round_end":
                        edge(i, j)
                        break
            else:
                if e.round in last_round_start:
                    edge(last_round_start[e.round], j)
            if e.kind == "deliver":
                if e.client in last_by_client:
                    edge(last_by_client[e.client], j)
                last_by_client[e.client] = j
            if e.kind == "apply":
                members = set(e.clients)
                for i in range(j - 1, -1, -1):
                    if ev[i].kind == "deliver" and ev[i].client in members:
                        edge(i, j)
                        members.discard(ev[i].client)
                        if not members:
                            break
            if e.kind in ("dual", "round_end"):
                for i in range(j - 1, -1, -1):
                    if ev[i].round != e.round:
                        break
                    if ev[i].kind == "apply":
                        edge(i, j)
            if e.kind == "round_end":
                for i in range(j - 1, -1, -1):
                    if ev[i].round != e.round:
                        break
                    edge(i, j)
        closure = [0] * n
        for i in range(n - 1, -1, -1):
            acc = direct[i]
            m = direct[i]
            while m:
                jbit = m & -m
                acc |= closure[jbit.bit_length() - 1]
                m ^= jbit
            closure[i] = acc
        self._closure = closure

    def happens_before(self, i: int, j: int) -> bool:
        return bool((self._closure[i] >> j) & 1)

    def unordered_pairs(self) -> List[Tuple[SchedEvent, SchedEvent]]:
        """Every pair the partial order does not sequence — the
        schedule freedom of the run."""
        out: List[Tuple[SchedEvent, SchedEvent]] = []
        for i in range(len(self.events)):
            for j in range(i + 1, len(self.events)):
                if not self.happens_before(i, j) \
                        and not self.happens_before(j, i):
                    out.append((self.events[i], self.events[j]))
        return out

    def races(self, commutativity: Optional[str],
              tie_broken: bool = True) -> List[SchedRace]:
        """Unordered pairs touching shared state, judged against the
        aggregator's commutativity certificate.

        ``tie_broken`` says the engine linearized ties through a total
        order (``TimedReport.sort_key`` — always true for
        ``FederatedEngine``); "tiebreak" certificates rely on it."""
        out: List[SchedRace] = []
        for a, b in self.unordered_pairs():
            shared = tuple(s for s in a.touches if s in b.touches)
            if not shared:
                continue
            if commutativity in ("exact", "canonical"):
                cert, via = True, (
                    f"aggregator folds are {commutativity} "
                    f"(order-free over the report set)")
            elif commutativity == "tiebreak" and tie_broken:
                cert, via = True, (
                    "buffer composition is delivery-ordered but the "
                    "engine tie-breaks into a total order "
                    "(TimedReport.sort_key)")
            elif commutativity == "tiebreak":
                cert, via = False, (
                    "tiebreak certificate requires a total event "
                    "order, but the schedule leaves ties unresolved")
            else:
                cert, via = False, (
                    "aggregator declares no commutativity certificate")
            out.append(SchedRace(a=a, b=b, state=shared,
                                 certified=cert, via=via))
        return out
