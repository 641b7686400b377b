"""repro_torch.analysis.trace — aten-graph static analysis.

The port's counterpart of ``repro.analysis.trace``. Where the AST half of
``repro_torch.analysis`` reads source text, this half traces registered
entry points (the client's grad, update and local steps, the batched
executor's cohort round, the aggregator combines, the wire kernels and
the masked fold, the dual update) to aten graphs on fake tensors under
declared example shapes, runs a static cost model over them (peak live
bytes by a linear scan over storages, FLOPs, host-transfer bytes),
evaluates the TRACE rules on the graphs, and gates the peak-memory
estimate against ``Budgets.memory`` through the Constraint API: a
feasibility check made before a run.

    PYTHONPATH=src python -m repro_torch.analysis --trace [--json]

The committed ``TRACE_BUDGETS_TORCH.json`` is the cost table the ratchet
diffs against; ``--trace --update-baseline`` re-records it (and folds
any TRACE findings into ``ANALYSIS_BASELINE_TORCH.json``).
"""
from __future__ import annotations

from repro_torch.analysis.trace.cost import (GraphCost, cost_of_graph,
                                             iter_nodes, node_flops,
                                             tensor_bytes)
from repro_torch.analysis.trace.gate import (DEFAULT_TRACE_TABLE, GateRow,
                                             TraceReport, format_report,
                                             memory_gate, run_trace)
from repro_torch.analysis.trace.registry import (EntryPoint, TracedEntry,
                                                 charlm_trace_setup,
                                                 collect_entry_points,
                                                 trace_entry,
                                                 traced_entries)
from repro_torch.analysis.trace.rules import (TraceRule,
                                              register_trace_rule,
                                              run_trace_rules,
                                              trace_rule_ids, trace_rules)

__all__ = [
    "DEFAULT_TRACE_TABLE", "EntryPoint", "GateRow", "GraphCost",
    "TraceReport", "TraceRule", "TracedEntry", "charlm_trace_setup",
    "collect_entry_points", "cost_of_graph", "format_report", "iter_nodes",
    "memory_gate", "node_flops", "register_trace_rule", "run_trace",
    "run_trace_rules", "tensor_bytes", "trace_entry", "trace_rule_ids",
    "trace_rules", "traced_entries",
]
