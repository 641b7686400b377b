"""``repro_torch.analysis.sched`` — schedule-determinism analysis of the
port's engine: prove round results are invariant under the event
schedule, or flag where they are not.

    rules     static SCHED001-004 (registered into the shared engine)
    hb        happens-before model over a recorded run: partial order
              of report -> delivery -> apply -> dual events, plus the
              race checker (HB-unordered events touching shared
              aggregator/strategy state must be commutative-certified)
    permute   the runtime sanitizer: ``SchedulePermuter`` replays a
              run under adversarial legal schedule permutations and
              asserts bit-identical (or tolerance-banded) results
    gate      ``run_sched`` — the ``--sched`` CLI/CI entry point

This module keeps imports light: the static rules are importable
without torch; ``hb``/``permute``/``gate`` pull in the engine and the
model stack and are loaded lazily on first attribute access.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.sched.rules import (  # noqa: F401
    OrderSensitiveReportFold, SharedComponentRNG, SCHED_RULE_IDS,
    UnorderedContainerIteration, UntiedTimestampOrder,
)

_LAZY = {
    "HBGraph": "repro_torch.analysis.sched.hb",
    "SchedEvent": "repro_torch.analysis.sched.hb",
    "SchedRace": "repro_torch.analysis.sched.hb",
    "ScheduleRecorder": "repro_torch.analysis.sched.hb",
    "build_hb_graph": "repro_torch.analysis.sched.hb",
    "AdversarialTieQueue": "repro_torch.analysis.sched.permute",
    "PermutationReport": "repro_torch.analysis.sched.permute",
    "SchedulePermuter": "repro_torch.analysis.sched.permute",
    "ScheduleSanitizerCallback": "repro_torch.analysis.sched.permute",
    "run_signature": "repro_torch.analysis.sched.permute",
    "SchedReport": "repro_torch.analysis.sched.gate",
    "format_sched_report": "repro_torch.analysis.sched.gate",
    "run_sched": "repro_torch.analysis.sched.gate",
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)


def __dir__() -> List[str]:
    return sorted(list(globals()) + list(_LAZY))
