"""repro_torch.analysis — static analysis + runtime sanitizers for the
port, the counterpart of ``repro.analysis``.

Static half: an AST rule engine (``python -m repro_torch.analysis``)
with torch discipline rules (draws from the global generator,
import-time device work, per-client Python loops) and repo invariants
(each CUDA kernel's entry point, twin, dispatch, launch counter and
test; benchmark metric specs; exact wire/token accounting), gated by a
committed suppression baseline (``ANALYSIS_BASELINE_TORCH.json``) so
legacy findings don't block CI while new code is held to zero. The
static half imports no torch.

Runtime half (``repro_torch.analysis.runtime``): opt-in sanitizers —
``torch.cuda.set_sync_debug_mode`` wiring and a rebuild watcher — plus
engine ``RoundCallback``s that record every steady-state host sync by
call site and pin the kernel library at zero builds or loads after
round 1.

Schedule half (``repro_torch.analysis.sched``): the determinism contract
for the event-driven control plane — static SCHED rules, a
happens-before race checker over recorded runs, and the
``SchedulePermuter`` that replays a run under adversarial legal event
permutations (``python -m repro_torch.analysis --sched``).

Trace half (``repro_torch.analysis.trace``): the reference's jaxpr cost
model, TRACE rules and memory gate over aten graphs recorded on fake
tensors (``python -m repro_torch.analysis --trace``, table
``TRACE_BUDGETS_TORCH.json``).

The runtime names load lazily, on first attribute access, so importing
this package does not import torch.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.engine import (Analyzer, ModuleRule, ParsedModule,
                                         ProjectRule, Rule, default_rules,
                                         rule_ids, run_analysis)
from repro_torch.analysis.findings import AnalysisResult, Finding

_RUNTIME = ("EXPLICIT_READS", "RecompileWatchCallback", "RecompileWatcher",
            "SyncGuardCallback", "no_syncs", "sync_debug_supported")

__all__ = [
    "Analyzer", "AnalysisResult", "Baseline", "DEFAULT_BASELINE",
    "Finding", "ModuleRule", "ParsedModule", "ProjectRule", "Rule",
    "default_rules", "rule_ids", "run_analysis", *_RUNTIME,
]


def __getattr__(name: str):
    if name not in _RUNTIME:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from repro_torch.analysis import runtime
    return getattr(runtime, name)


def __dir__() -> List[str]:
    return sorted(list(globals()) + list(_RUNTIME))
