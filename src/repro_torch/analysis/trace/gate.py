"""The static feasibility gate: traced costs against the committed table
and the paper's memory budget.

The port's counterpart of ``repro.analysis.trace.gate``, the same in
meaning. Two checks ride on every ``python -m repro_torch.analysis
--trace`` run:

1. **Ratchet**: each entry's peak must stay within ``PEAK_RTOL`` of its
   row in the committed ``TRACE_BUDGETS_TORCH.json`` (the band absorbs
   torch-version changes to the aten graphs; re-record when it moves).
   A regression fails; an improvement is banked with ``--trace
   --update-baseline``.

2. **Memory gate**: peak bytes become the paper's relative memory units
   through the calibration entry (the client step at *baseline* knobs
   defines Table 1's FedAvg memory, 0.31 units, as
   ``core.resources.calibrate`` does) and every ``gated`` entry is
   checked against ``Budgets.memory`` through the Constraint API. The
   baseline step itself violates the budget (0.31 > 0.26): that is the
   paper's Fig. 2 starting point and the negative control of the tests,
   so only the *adapted* operating point is gated.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.trace.registry import TracedEntry, traced_entries
from repro_torch.analysis.trace.rules import run_trace_rules, trace_rule_ids

DEFAULT_TRACE_TABLE = "TRACE_BUDGETS_TORCH.json"
TRACE_TABLE_VERSION = 1
#: static costs are deterministic given the code; the band only absorbs
#: torch-version changes to the recorded graphs
PEAK_RTOL = 0.02


def memory_budget_units() -> float:
    """Budgets.memory resolved through the Constraint API (the same
    ``budget_of`` the dual update reads), in relative proxy units."""
    from repro_torch.configs import get_fl_config
    from repro_torch.constraints import make_constraints

    budgets = get_fl_config().budgets
    cs = make_constraints("paper")
    mem = next(c for c in cs if c.name == "memory")
    return float(mem.budget_of(budgets))


def baseline_units() -> float:
    from repro_torch.core.resources import TABLE1_FEDAVG
    return float(TABLE1_FEDAVG["memory"])


@dataclass
class GateRow:
    """One entry's memory-gate accounting (in paper proxy units)."""

    entry: str
    peak_bytes: int
    memory_units: float
    budget_units: float
    gated: bool
    violated: bool

    def to_json(self) -> Dict[str, Any]:
        return {"entry": self.entry, "peak_bytes": self.peak_bytes,
                "memory_units": round(self.memory_units, 6),
                "budget_units": self.budget_units, "gated": self.gated,
                "violated": self.violated}


@dataclass
class TraceReport:
    """Everything one --trace run produced."""

    traced: List[TracedEntry] = field(default_factory=list)
    findings: List[Finding] = field(default_factory=list)
    gate: List[GateRow] = field(default_factory=list)
    problems: List[str] = field(default_factory=list)
    rules_run: List[str] = field(default_factory=list)

    def rows_json(self) -> List[Dict[str, Any]]:
        out = []
        for t in self.traced:
            row = {"entry": t.entry.name, **t.cost.to_json()}
            if t.entry.donatable:
                row["inplace_leaves"] = t.inplace_leaves
                row["donatable_leaves"] = t.donatable_leaves
            out.append(row)
        return out


def to_units(peak_bytes: int, calibration_bytes: int) -> float:
    """Peak bytes in the paper's memory units: the calibration peak is
    Table 1's FedAvg memory (the gate's conversion; ``chip_smoke.py``
    applies it to peaks measured on the card too)."""
    return baseline_units() * peak_bytes / calibration_bytes


def memory_gate(traced: Sequence[TracedEntry]) -> List[GateRow]:
    """Convert peaks to units via the calibration entry and test every
    gated entry against the memory budget."""
    cal = [t for t in traced if t.entry.calibration]
    if not cal:
        return []
    cal_peak = cal[0].cost.peak_bytes
    if cal_peak <= 0:
        return []
    budget = memory_budget_units()
    rows: List[GateRow] = []
    for t in traced:
        if not (t.entry.gated or t.entry.calibration):
            continue
        units = to_units(t.cost.peak_bytes, cal_peak)
        rows.append(GateRow(
            entry=t.entry.name, peak_bytes=t.cost.peak_bytes,
            memory_units=units, budget_units=budget,
            gated=t.entry.gated, violated=units > budget))
    return rows


def load_table(path: str) -> Optional[Dict[str, Any]]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    if raw.get("version") != TRACE_TABLE_VERSION:
        raise ValueError(
            f"{path}: unsupported trace table version "
            f"{raw.get('version')!r} (expected {TRACE_TABLE_VERSION})")
    return raw


def build_table(traced: Sequence[TracedEntry],
                gate_rows: Sequence[GateRow]) -> Dict[str, Any]:
    units = {r.entry: r for r in gate_rows}
    entries: Dict[str, Any] = {}
    for t in traced:
        row: Dict[str, Any] = dict(t.cost.to_json())
        g = units.get(t.entry.name)
        if g is not None:
            row["memory_units"] = round(g.memory_units, 6)
            row["gated"] = g.gated
        entries[t.entry.name] = row
    return {
        "version": TRACE_TABLE_VERSION,
        "budget": {"memory_units": memory_budget_units(),
                   "baseline_units": baseline_units()},
        "entries": entries,
    }


def save_table(table: Dict[str, Any], path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(table, fh, indent=2, sort_keys=True)
        fh.write("\n")


def diff_table(table: Optional[Dict[str, Any]],
               traced: Sequence[TracedEntry]) -> List[str]:
    """Ratchet: current costs against the committed table's rows."""
    problems: List[str] = []
    if table is None:
        problems.append(
            f"no committed trace table ({DEFAULT_TRACE_TABLE}); run "
            f"--trace --update-baseline to record one")
        return problems
    rows = table.get("entries", {})
    for t in traced:
        row = rows.get(t.entry.name)
        if row is None:
            problems.append(
                f"entry '{t.entry.name}' is not in the committed trace "
                f"table; re-record with --trace --update-baseline")
            continue
        old = int(row.get("peak_bytes", 0))
        new = t.cost.peak_bytes
        if old and new > old * (1.0 + PEAK_RTOL):
            problems.append(
                f"entry '{t.entry.name}' peak regressed: {new} B > "
                f"recorded {old} B (+{(new / old - 1) * 100:.1f}%)")
    current = {t.entry.name for t in traced}
    for name in sorted(set(rows) - current):
        problems.append(
            f"trace table row '{name}' no longer has a registered "
            f"entry; re-record with --trace --update-baseline")
    return problems


def run_trace(root: str = ".", table_path: Optional[str] = None,
              update: bool = False) -> TraceReport:
    """Trace every registered entry, run the TRACE rules, apply the
    memory gate and the committed-table ratchet.

    ``update=True`` rewrites the table instead of diffing against it
    (findings still flow to the caller for the shared baseline).
    """
    traced = list(traced_entries())
    report = TraceReport(traced=traced,
                         findings=run_trace_rules(traced),
                         rules_run=trace_rule_ids())
    report.gate = memory_gate(traced)
    for row in report.gate:
        if row.gated and row.violated:
            report.problems.append(
                f"memory gate: entry '{row.entry}' static estimate "
                f"{row.memory_units:.3f} units exceeds Budgets.memory "
                f"= {row.budget_units:.2f}")

    path = table_path or os.path.join(root, DEFAULT_TRACE_TABLE)
    if update:
        save_table(build_table(traced, report.gate), path)
    else:
        report.problems.extend(diff_table(load_table(path), traced))
    return report


def format_report(report: TraceReport) -> str:
    """The human-readable --trace section."""
    lines = [f"trace: {len(report.traced)} entry point(s), "
             f"{len(report.rules_run)} TRACE rules"]
    width = max((len(t.entry.name) for t in report.traced), default=0)
    for t in report.traced:
        c = t.cost
        extra = ""
        if t.entry.donatable:
            extra = (f"  in place {t.inplace_leaves}/"
                     f"{t.donatable_leaves}")
        lines.append(
            f"  {t.entry.name:<{width}}  peak {_fmt_bytes(c.peak_bytes):>10}"
            f"  flops {_fmt_count(c.flops):>8}"
            f"  xfer {_fmt_bytes(c.transfer_bytes):>8}{extra}")
    for row in report.gate:
        tag = ("VIOLATED" if row.violated else "ok") if row.gated else \
            "calibration"
        lines.append(
            f"  gate[memory] {row.entry}: {row.memory_units:.3f} / "
            f"{row.budget_units:.2f} units ({tag})")
    return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f} KiB"
    return f"{n} B"


def _fmt_count(n: int) -> str:
    if n >= 10 ** 9:
        return f"{n / 1e9:.2f} G"
    if n >= 10 ** 6:
        return f"{n / 1e6:.2f} M"
    if n >= 10 ** 3:
        return f"{n / 1e3:.1f} k"
    return str(n)
