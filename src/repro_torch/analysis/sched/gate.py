"""The ``--sched`` gate: run the schedule sanitizer scenarios and
report races/mismatches as analysis findings.

The reference's gate (``repro.analysis.sched.gate``) on the port's
engine, on ``device`` (the card unless the caller asks for the CPU).
Three scenarios exercise the determinism contract end to end on a tiny
model (one engine each, reused across replays):

    sync_ties       homogeneous cohort under the sync barrier — every
                    survivor arrives at the same instant, so the whole
                    cohort is one tie group; results must be
                    bit-identical under any tie resolution
    masked_shuffle  the same cohort shuffle through
                    ``MaskedSumAggregator()`` — its one fold,
                    ``ops.masked_sum_u64`` on the deltas' device, is
                    exact mod 2^64, so this must be bit-identical *by
                    construction*
    fedbuff_wall    3 rounds of wall-clock FedBuff over three device
                    classes (jitter 0): each class is a tie pair and
                    ``buffer_size=2`` aligns fills with tie groups, so
                    even the "tiebreak"-certified policy must hold
                    bit-for-bit under ≥8 adversarial permutations

Every replay runs under a ``ScheduleSanitizerCallback`` (strict=False)
so the happens-before race check rides along: an uncertified race
becomes a SCHED005 finding in the normal baseline stream; permutation
mismatches and vacuous permutations (nothing actually reordered — the
scenario stopped proving anything) are hard problems, like trace
problems: never baselinable."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.sched.permute import (PermutationReport,
                                                SchedulePermuter,
                                                ScheduleSanitizerCallback)

#: rule id for runtime happens-before races (static rules own 001-004)
HB_RULE_ID = "SCHED005"
_HB_HINT = ("declare the aggregator's commutativity certificate "
            "(exact/canonical/tiebreak) and make it true — fold in "
            "canonical report order or an exact representation")


def _tiny_stack():
    """The shared scenario substrate: the reference gate's tiny charlm
    (2 layers, d_model 32, 6 clients)."""
    from repro_torch.configs import get_config, get_fl_config
    from repro_torch.data import load_corpus
    from repro_torch.models import build

    ds = load_corpus(target_bytes=60_000)
    cfg = get_config("charlm-shakespeare").replace(
        vocab_size=max(ds.vocab_size, 64), num_layers=2, d_model=32,
        num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64)
    fl = get_fl_config().replace(
        rounds=3, num_clients=6, clients_per_round=3, s_base=3, b_base=8,
        seq_len=16, eval_batches=1, eval_batch_size=8)
    fl = fl.replace(duals=dataclasses.replace(fl.duals, s_min=2, b_min=4))
    return build(cfg), fl, ds


def full_width_stack():
    """The scenario substrate with the charlm at its own widths and
    depth (6 layers, d_model 192; the vocab widened to the corpus's only
    where that is larger). The federated setting stays ``_tiny_stack``'s:
    the scenarios' certificates rest on it (FedBuff's buffer of 2 fills
    with one tie pair at a time only in its 6-client, 3-class fleet)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build

    _, fl, ds = _tiny_stack()
    cfg = get_config("charlm-shakespeare")
    if cfg.vocab_size < ds.vocab_size:
        cfg = cfg.replace(vocab_size=ds.vocab_size)
    return build(cfg), fl, ds


def _sync_ties(model, fl, ds, sanitizer, device=None):
    from repro_torch.fl import FederatedEngine
    eng = FederatedEngine(model, fl, ds, strategy="cafl",
                          aggregator="sync", callbacks=[sanitizer],
                          device=device)
    return eng, dict(permutations=4, mode="exact")


def _masked_shuffle(model, fl, ds, sanitizer, device=None):
    from repro_torch.fl import FederatedEngine, MaskedSumAggregator
    eng = FederatedEngine(model, fl, ds, strategy="fedavg",
                          aggregator=MaskedSumAggregator(),
                          callbacks=[sanitizer], device=device)
    return eng, dict(permutations=4, mode="exact")


def _fedbuff_wall(model, fl, ds, sanitizer, device=None):
    from repro_torch.fl import (DeadlineStragglers, FedBuffAggregator,
                                FederatedEngine, FleetClass, FleetDynamics,
                                UniformSampler, make_fleet)
    fl = fl.replace(clients_per_round=fl.num_clients)
    profiles, cp = make_fleet(fl, [
        FleetClass("fast", 1 / 3),
        FleetClass("mid", 1 / 3, compute_scale=1.5),
        FleetClass("slow", 1 / 3, compute_scale=2.0)])
    dyn = FleetDynamics(
        sampler=UniformSampler(fl.clients_per_round),
        stragglers=DeadlineStragglers.for_config(fl, deadline=10.0,
                                                 jitter=0.0))
    eng = FederatedEngine(model, fl, ds, strategy="cafl",
                          profiles=profiles, client_profiles=cp,
                          dynamics=dyn,
                          aggregator=FedBuffAggregator(buffer_size=2),
                          callbacks=[sanitizer], device=device)
    return eng, dict(permutations=8, mode="exact")


#: name -> builder(model, fl, ds, sanitizer, device) -> (engine,
#: permuter kw)
SCENARIOS: Dict[str, Callable] = {
    "sync_ties": _sync_ties,
    "masked_shuffle": _masked_shuffle,
    "fedbuff_wall": _fedbuff_wall,
}


@dataclass
class SchedReport:
    """Everything one --sched run produced (mirrors TraceReport)."""

    scenarios: List[Dict[str, Any]] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)
    problems: List[str] = field(default_factory=list)
    rules_run: List[str] = field(default_factory=list)

    def rows_json(self) -> List[Dict[str, Any]]:
        return list(self.scenarios)


def _race_finding(scenario: str, race: Any) -> Finding:
    return Finding(
        rule=HB_RULE_ID, path="src/repro_torch/fl/aggregator.py", line=1,
        message=f"[{scenario}] schedule race: {race.describe()}",
        hint=_HB_HINT,
        snippet=f"{scenario}:{race.a.kind}|{race.b.kind}:"
                f"{'/'.join(race.state)}")


def run_scenario(name: str, model: Any, fl: Any, ds: Any,
                 permutations: Optional[int] = None, device: Any = None,
                 callbacks: Sequence[Any] = ()
                 ) -> Tuple[Dict[str, Any], List[Finding], List[str]]:
    """Run one scenario on ``device``, ``callbacks`` riding along on
    every replay; returns (json row, findings, problems)."""
    sanitizer = ScheduleSanitizerCallback(strict=False)
    eng, kw = SCENARIOS[name](model, fl, ds, sanitizer, device)
    eng.callbacks.extend(callbacks)
    if permutations is not None:
        kw["permutations"] = permutations
    permuter = SchedulePermuter(eng, run_kwargs={"time_mode": "wall_clock"},
                                **kw)
    perm: PermutationReport = permuter.run()
    races = list(sanitizer.races)           # from the last replay
    unordered = (len(sanitizer.graph.unordered_pairs())
                 if sanitizer.graph is not None else 0)
    row = {"scenario": name, "aggregator": eng.aggregator.name,
           "commutativity": eng.aggregator.commutativity,
           "unordered_pairs": unordered,
           "races_certified": len(sanitizer.certified),
           "races": len(races), **perm.to_json()}
    findings = [_race_finding(name, r) for r in races]
    problems = [f"[{name}] {p}" for p in perm.problems]
    problems += [f"[{name}] {m}" for m in perm.mismatches]
    if perm.total_swapped == 0:
        problems.append(
            f"[{name}] vacuous permutation: no round's delivery order "
            f"changed under {perm.permutations} adversarial tie "
            f"seeds — the scenario no longer exercises any schedule "
            f"freedom")
    return row, findings, problems


def run_sched(root: str, update: bool = False,
              device: Any = None) -> SchedReport:
    """Run every scenario on ``device`` (None: the card). ``root`` /
    ``update`` keep the reference's signature — the sched gate has no
    recorded table to re-write (the contract is bit-identity, not a
    budget), so ``update`` is a no-op beyond letting ``--sched
    --update-baseline`` own new SCHED005 findings like any other
    finding. A scenario that crashes is a problem, never skipped."""
    del root, update
    report = SchedReport(rules_run=[HB_RULE_ID])
    try:
        model, fl, ds = _tiny_stack()
    except Exception as e:          # pragma: no cover - env trouble
        report.problems.append(f"sched scenarios unavailable: {e!r}")
        return report
    for name in SCENARIOS:
        try:
            row, findings, problems = run_scenario(name, model, fl, ds,
                                                   device=device)
        except Exception as e:
            report.problems.append(f"[{name}] scenario crashed: {e!r}")
            continue
        report.scenarios.append(row)
        report.findings.extend(findings)
        report.problems.extend(problems)
    return report


def format_sched_report(report: SchedReport) -> str:
    lines = ["schedule sanitizer:"]
    for row in report.scenarios:
        verdict = "ok" if row["ok"] and not row["races"] else "FAIL"
        lines.append(
            f"  {row['scenario']:<16} {row['aggregator']:<8} "
            f"cert={row['commutativity'] or '-':<9} "
            f"perms={row['permutations']} mode={row['mode']:<9} "
            f"swapped={row['total_swapped']:<3} "
            f"unordered={row['unordered_pairs']:<4} "
            f"races={row['races']} {verdict}")
    if not report.scenarios:
        lines.append("  (no scenarios ran)")
    return "\n".join(lines)
