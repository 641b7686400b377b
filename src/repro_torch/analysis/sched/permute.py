"""The runtime schedule sanitizer: replay a run of the port's engine
under adversarial legal schedules and prove the results don't move.

The reference's sanitizer (``repro.analysis.sched.permute``) on
``repro_torch.fl``: the tie queue is injected through the engine's
``event_queue`` factory, and a run's final parameters are read in JAX's
leaf order (``models.convert.jax_order``), a fixed name order.

``TimedReport.sort_key`` is ``(arrival, tie, seq)`` with ``tie = 0.0``
in production, so the engine resolves simultaneous arrivals by
stamping order. ``AdversarialTieQueue`` stamps seeded pseudo-random
ties instead: every ordering it produces still respects every arrival
time — it is a *legal* schedule — but simultaneous arrivals deliver in
a different order each seed. ``SchedulePermuter`` replays one engine
configuration under K such schedules and compares ``RoundRecord``
streams, dual trajectories and final params against the production
schedule:

    mode="exact"      bit-for-bit (deterministic aggregators: the
                      "exact"/"canonical" certificates, and FedBuff
                      scenarios whose tie groups align with its fills)
    mode="tolerance"  within declared bands (staleness-weighted paths
                      where a permutation legitimately changes *which*
                      round a tied report lands in)

``ScheduleSanitizerCallback`` is the always-on flavour: it records the
run (``ScheduleRecorder``), builds the happens-before graph at
``on_train_end`` and raises on any uncertified race — wire it like the
runtime guards (``analysis.runtime``):

    engine = FederatedEngine(..., callbacks=[ScheduleSanitizerCallback()])
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.analysis.sched.hb import (HBGraph, SchedRace,
                                           ScheduleRecorder, build_hb_graph)
from repro_torch.fl.clock import EventQueue, TimedReport
from repro_torch.models.convert import jax_order

#: stream domain separator for tie draws (vs every other seeded rng)
_TIE_STREAM = 0x5CED


@dataclass
class AdversarialTieQueue(EventQueue):
    """An ``EventQueue`` that stamps seeded pseudo-random tie-breaks.

    The tie only reorders *equal-arrival* events (it sits between
    ``arrival`` and ``seq`` in the sort key), so every schedule this
    queue produces is a legal linearization of the same physical run.
    Draws key on ``(stream, seed, event seq)`` — no state is shared
    with any other rng, and the schedule is replayable per seed."""

    seed: int = 0

    def stamp(self, arrival: float, report: Any) -> TimedReport:
        ev = super().stamp(arrival, report)
        rng = np.random.default_rng([_TIE_STREAM, self.seed, ev.seq])
        return dataclasses.replace(ev, tie=float(rng.random()))


# ---------------------------------------------------------------------------
# run signatures
# ---------------------------------------------------------------------------

#: RoundRecord fields compared bit-for-bit (or within bands): the
#: accounting the determinism contract covers
_ROUND_FLOATS = ("val_loss", "train_loss", "wire_mb_actual", "energy_true",
                 "mean_staleness", "sim_time", "round_seconds")
_ROUND_INTS = ("updates_applied", "reports_applied", "num_available")


def run_signature(result: Any) -> Dict[str, Any]:
    """Everything a schedule permutation must leave invariant, pulled
    from one ``FLResult``. ``participant_order`` is delivery-order
    telemetry — excluded from comparison, but used to prove a
    permutation actually reordered something."""
    rounds: List[Dict[str, Any]] = []
    for r in result.history:
        rounds.append({
            "round": int(r.round),
            **{k: float(getattr(r, k)) for k in _ROUND_FLOATS},
            **{k: int(getattr(r, k)) for k in _ROUND_INTS},
            "usage": {k: float(v) for k, v in r.usage.items()},
            "ratios": {k: float(v) for k, v in r.ratios.items()},
            "duals": {k: float(v) for k, v in r.duals.items()},
            "knobs": dict(r.knobs),
            "participants": frozenset(r.participants),
            "participant_order": tuple(r.participants),
            "dropped": frozenset(r.dropped),
        })
    leaves = [leaf.detach().cpu().numpy() for leaf in
              jax_order(result.final_params).values()]
    return {"rounds": rounds, "final": leaves}


def _cmp_float(key: str, a: float, b: float, exact: bool,
               rtol: float, atol: float) -> Optional[str]:
    if exact:
        if not (a == b or (np.isnan(a) and np.isnan(b))):
            return f"{key}: {a!r} != {b!r} (bit-exact required)"
    elif not np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True):
        return f"{key}: {a!r} vs {b!r} outside rtol={rtol} atol={atol}"
    return None


def compare_signatures(base: Dict[str, Any], other: Dict[str, Any],
                       mode: str = "exact", rtol: float = 1e-6,
                       atol: float = 1e-8) -> List[str]:
    """Mismatch descriptions between two run signatures ([] = match).
    Integers, sets and knob dicts are compared exactly in every mode;
    ``mode`` only relaxes the float fields and the final params."""
    assert mode in ("exact", "tolerance"), mode
    exact = mode == "exact"
    out: List[str] = []
    if len(base["rounds"]) != len(other["rounds"]):
        return [f"round count: {len(base['rounds'])} != "
                f"{len(other['rounds'])}"]
    for ra, rb in zip(base["rounds"], other["rounds"]):
        where = f"round {ra['round']}"
        for k in ("round",) + _ROUND_INTS:
            if ra[k] != rb[k]:
                out.append(f"{where}.{k}: {ra[k]} != {rb[k]}")
        for k in ("participants", "dropped", "knobs"):
            if ra[k] != rb[k]:
                out.append(f"{where}.{k}: {ra[k]!r} != {rb[k]!r}")
        for k in _ROUND_FLOATS:
            bad = _cmp_float(f"{where}.{k}", ra[k], rb[k], exact,
                             rtol, atol)
            if bad:
                out.append(bad)
        for grp in ("usage", "ratios", "duals"):
            if set(ra[grp]) != set(rb[grp]):
                out.append(f"{where}.{grp} keys: {sorted(ra[grp])} != "
                           f"{sorted(rb[grp])}")
                continue
            for k in ra[grp]:
                bad = _cmp_float(f"{where}.{grp}[{k}]", ra[grp][k],
                                 rb[grp][k], exact, rtol, atol)
                if bad:
                    out.append(bad)
    if len(base["final"]) != len(other["final"]):
        out.append(f"final params: {len(base['final'])} leaves != "
                   f"{len(other['final'])}")
        return out
    for i, (la, lb) in enumerate(zip(base["final"], other["final"])):
        if la.shape != lb.shape or la.dtype != lb.dtype:
            out.append(f"final leaf {i}: shape/dtype "
                       f"{la.shape}/{la.dtype} != {lb.shape}/{lb.dtype}")
        elif exact and la.tobytes() != lb.tobytes():
            out.append(f"final leaf {i}: bits differ "
                       f"(max abs diff {np.max(np.abs(la - lb)):g})")
        elif not exact and not np.allclose(la, lb, rtol=rtol, atol=atol):
            out.append(f"final leaf {i}: max abs diff "
                       f"{np.max(np.abs(la - lb)):g} outside bands")
    return out


# ---------------------------------------------------------------------------
# the permuter
# ---------------------------------------------------------------------------


@dataclass
class PermutationReport:
    """What ``SchedulePermuter.run`` proved (or failed to)."""

    permutations: int
    mode: str
    #: rounds whose delivery order actually changed, per permutation —
    #: all zeros means the test was vacuous (no ties to permute)
    swapped: List[int] = field(default_factory=list)
    mismatches: List[str] = field(default_factory=list)
    problems: List[str] = field(default_factory=list)

    @property
    def total_swapped(self) -> int:
        return sum(self.swapped)

    def ok(self) -> bool:
        return not self.mismatches and not self.problems

    def to_json(self) -> Dict[str, Any]:
        return {"permutations": self.permutations, "mode": self.mode,
                "swapped": list(self.swapped),
                "total_swapped": self.total_swapped,
                "mismatches": list(self.mismatches),
                "problems": list(self.problems), "ok": self.ok()}


class SchedulePermuter:
    """Replay one engine under K adversarial legal schedules.

    The engine is reused across replays — its runner / executor cache
    is built once, and the kernel library loads once per process — but
    two pieces of engine state deliberately *continue* across ``run()``
    calls and must be rewound per replay: the per-client batch streams
    (``FederatedData.reset_rngs``) and the strategy's dual multipliers
    (``init_duals`` warm continuation — replays run a deepcopy of the
    pristine strategy; the caller's strategy object is restored
    untouched). A production-schedule double run guards the comparison
    first: if two identical replays differ, the nondeterminism is not
    the schedule's fault and every permutation verdict would be noise.

    ``mode`` defaults from the aggregator's commutativity certificate:
    "exact"/"canonical" compare bit-for-bit, "tiebreak" within bands
    (a permutation may legally move a tied report across a buffer
    fill). Pass ``mode="exact"`` explicitly for tiebreak scenarios
    constructed so tie groups align with fills. ``run_kwargs`` must
    select ``time_mode="wall_clock"`` — ties only exist on the event
    queue."""

    def __init__(self, engine: Any, permutations: int = 8,
                 seed: int = 0,
                 mode: Optional[str] = None, rtol: float = 1e-6,
                 atol: float = 1e-8,
                 run_kwargs: Optional[Dict[str, Any]] = None):
        assert permutations >= 1
        self.engine = engine
        self.permutations = permutations
        self.seed = seed
        cert = engine.aggregator.commutativity
        self.mode = mode if mode is not None else (
            "tolerance" if cert == "tiebreak" else "exact")
        self.rtol, self.atol = rtol, atol
        self.run_kwargs = dict(run_kwargs or {})
        self.run_kwargs.setdefault("time_mode", "wall_clock")

    def _signature(self, pristine: Any) -> Dict[str, Any]:
        # rewind the run state that intentionally continues across
        # run() calls, so every replay is the same physical run and any
        # difference is the schedule's
        self.engine.data.reset_rngs()
        self.engine.strategy = copy.deepcopy(pristine)
        return run_signature(self.engine.run(**self.run_kwargs))

    def run(self) -> PermutationReport:
        eng = self.engine
        report = PermutationReport(permutations=self.permutations,
                                   mode=self.mode)
        prev_factory = eng.event_queue_factory
        prev_strategy = eng.strategy
        pristine = copy.deepcopy(eng.strategy)
        try:
            eng.event_queue_factory = None
            base = self._signature(pristine)
            for bad in compare_signatures(base, self._signature(pristine),
                                          "exact"):
                report.problems.append(f"rerun nondeterminism: {bad}")
            if report.problems:
                return report          # permutation verdicts would be noise
            for k in range(self.permutations):
                tie_seed = self.seed * 7919 + k + 1
                eng.event_queue_factory = (
                    lambda s=tie_seed: AdversarialTieQueue(seed=s))
                sig = self._signature(pristine)
                report.swapped.append(sum(
                    ra["participant_order"] != rb["participant_order"]
                    for ra, rb in zip(base["rounds"], sig["rounds"])))
                report.mismatches.extend(
                    f"perm {k}: {bad}" for bad in compare_signatures(
                        base, sig, self.mode, self.rtol, self.atol))
        finally:
            eng.event_queue_factory = prev_factory
            eng.strategy = prev_strategy
        return report


# ---------------------------------------------------------------------------
# the always-on sanitizer callback
# ---------------------------------------------------------------------------


class ScheduleRaceError(AssertionError):
    """An HB-unordered event pair touched shared state without a
    commutativity certificate."""


class ScheduleSanitizerCallback(ScheduleRecorder):
    """Record the run, build the happens-before graph at train end and
    check every unordered pair against the aggregator's commutativity
    certificate. ``strict=True`` (default) raises ``ScheduleRaceError``
    on an uncertified race; either way ``races`` / ``certified`` /
    ``graph`` stay inspectable after the run."""

    def __init__(self, strict: bool = True):
        super().__init__()
        self.strict = strict
        self.graph: Optional[HBGraph] = None
        self.races: List[SchedRace] = []
        self.certified: List[SchedRace] = []

    def on_train_end(self, engine: Any, result: Any) -> None:
        self.graph = build_hb_graph(engine, self)
        verdicts = self.graph.races(engine.aggregator.commutativity)
        self.races = [r for r in verdicts if not r.certified]
        self.certified = [r for r in verdicts if r.certified]
        if self.strict and self.races:
            lines = "\n  ".join(r.describe() for r in self.races[:8])
            raise ScheduleRaceError(
                f"{len(self.races)} schedule race(s): HB-unordered "
                f"events touch shared state without a commutativity "
                f"certificate\n  {lines}")


__all__: Sequence[str] = (
    "AdversarialTieQueue", "PermutationReport", "SchedulePermuter",
    "ScheduleRaceError", "ScheduleSanitizerCallback",
    "compare_signatures", "run_signature",
)
