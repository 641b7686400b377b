"""Where a traced window's device idle goes, by the program's own spans.

One traced run of a cell through the harness (``--trace 1``'s window and
readers), then, from the same trace and the program's spans
(``repro_torch.telemetry``, read by ``portbench/spans.py``): the
window's idle seconds; each span name's idle in its self time (the span
less its children); the idle outside every span; and their sum against
the window's idle, which the nesting makes equal up to spans that
overlap. Also each name's count and device seconds, and how far the
first span starts after the window (both on the profiler's clock).

    python3 -m portbench.tools.span_sums --workload <name> --seed <n>

Prints one JSON line: the result line's per-layer metrics beside these.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sums(tr, got) -> dict:
    """The idle split of one traced window (``rec["trace"]``) by the
    program's spans (``telemetry.collect()``)."""
    from portbench import spans
    w0, w1 = tr["window_ns"]
    busy = spans.busy(tr)
    idle = (w1 - w0) * 1e-9 - spans.length(busy) * 1e-9
    names = sorted({s["name"] for s in got["spans"]})
    by_name = {n: spans.idle_seconds(tr, got["spans"], [n]) for n in names}
    under = spans.clip(spans.self_intervals(got["spans"], names, True),
                       w0, w1)
    outside = spans.length(spans.subtract(spans.subtract(
        [(w0, w1)], under), busy)) * 1e-9
    total = sum(by_name.values()) + outside
    first = min((s["start_ns"] for s in got["spans"]), default=w0)
    return {
        "window_s": (w1 - w0) * 1e-9, "idle_s": idle,
        "idle_self_s": by_name, "idle_outside_s": outside,
        "sum_s": total, "sum_gap": (total - idle) / idle if idle else 0.0,
        "count": {n: sum(s["name"] == n for s in got["spans"])
                  for n in names},
        "device_s": {n: sum(s["device_s"] or 0.0 for s in got["spans"]
                            if s["name"] == n) for n in names},
        "first_span_after_window_ms": (first - w0) * 1e-6,
        "counters": got["counters"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench import harness
    harness._environment()
    from repro_torch import telemetry
    cell = harness.resolve(harness.load_spec(), args.workload)
    device = harness.card(cell.workload["chips"])
    kept = {}
    reduce_trace = harness.reduce_trace

    def keep(prof):
        kept["trace"] = reduce_trace(prof)
        return kept["trace"]

    harness.reduce_trace = keep
    t0 = time.perf_counter()
    res = harness.run_cell(cell, args.seed, args.seconds, True, device,
                           t_start=t0)
    line = {"workload": args.workload, "seed": args.seed,
            "correct": res["correct"], "device": res["device"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            **sums(kept["trace"], telemetry.collect())}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
