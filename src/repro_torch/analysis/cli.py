"""``python -m repro_torch.analysis`` — run the port's rule engine from
the shell.

The reference's CLI (``python -m repro.analysis``): the same flags, exit
codes and JSON. Exit codes: 0 clean (or everything suppressed by the
baseline), 1 new findings (or stale baseline entries, or a ``--sched``
problem), 2 usage error. ``--sched`` runs the schedule gate on
``--device`` (default ``cuda``, as every entry point of the port; pass
``--device cpu`` on a machine without a card). ``--trace`` is not ported
yet (ROADMAP queue 1 item 14b) and raises. The committed baseline is
``ANALYSIS_BASELINE_TORCH.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.analysis.baseline import DEFAULT_BASELINE, Baseline
from repro_torch.analysis.engine import (DEFAULT_CODE_PATHS, Analyzer,
                                         default_rules)
from repro_torch.analysis.findings import assign_occurrences

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Torch-aware static analysis for the repro_torch "
                    "tree.")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/directories to scan (default: "
                        f"{', '.join(DEFAULT_CODE_PATHS)})")
    p.add_argument("--root", default=".",
                   help="repo root the paths are relative to")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help=f"suppression baseline to diff against "
                        f"(e.g. {DEFAULT_BASELINE})")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite --baseline with the current findings "
                        "and exit 0")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print rule metadata and exit")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable JSON on stdout")
    p.add_argument("--trace", action="store_true",
                   help="trace analysis (cost model and memory gate): "
                        "not ported yet, ROADMAP queue 1 item 14b")
    p.add_argument("--sched", action="store_true",
                   help="also run the schedule-determinism sanitizer: "
                        "replay the sched scenarios under adversarial "
                        "legal event permutations, check the happens-"
                        "before graph for uncertified races (SCHED005) "
                        "and fail on any permutation mismatch")
    p.add_argument("--device", default="cuda",
                   help="where --sched runs the engine (default: cuda; "
                        "cpu on a machine without a card)")
    return p


def _select_rules(spec: Optional[str]
                  ) -> Tuple[Optional[List[Any]], Optional[str]]:
    rules = default_rules()
    if spec is None:
        return rules, None
    wanted = [s.strip() for s in spec.split(",") if s.strip()]
    known = {r.id for r in rules}
    unknown = [w for w in wanted if w not in known]
    if unknown:
        return None, (f"unknown rule(s) {', '.join(unknown)}; "
                      f"available: {', '.join(sorted(known))}")
    return [r for r in rules if r.id in wanted], None


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules, err = _select_rules(args.rules)
    if err:
        print(err, file=sys.stderr)
        return EXIT_USAGE

    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.title}")
            print(f"    why:  {r.rationale}")
            print(f"    fix:  {r.hint}")
        return EXIT_CLEAN

    paths = args.paths if args.paths else None
    kwargs = {"rules": rules}
    if paths:
        kwargs["code_paths"] = paths
    result = Analyzer(args.root, **kwargs).run()
    findings = list(result.findings)
    rules_run = list(result.rules_run)

    if args.trace:
        raise NotImplementedError(
            "--trace (the trace analysis: cost model, memory gate, "
            "TRACE rules) is not ported yet: ROADMAP queue 1 item 14b")

    sched_report = None
    if args.sched:
        # lazy: the sanitizer scenarios run the engine (torch + model)
        from repro_torch.analysis.sched import run_sched
        sched_report = run_sched(args.root, update=args.update_baseline,
                                 device=args.device)
        findings = assign_occurrences(findings + sched_report.findings)
        rules_run += sched_report.rules_run

    baseline_path = args.baseline
    if baseline_path is None and os.path.exists(
            os.path.join(args.root, DEFAULT_BASELINE)) and not paths:
        baseline_path = os.path.join(args.root, DEFAULT_BASELINE)

    if args.update_baseline:
        if baseline_path is None:
            if paths:
                print("--update-baseline needs --baseline FILE when "
                      "scanning explicit paths", file=sys.stderr)
                return EXIT_USAGE
            baseline_path = os.path.join(args.root, DEFAULT_BASELINE)
        Baseline.from_findings(findings).save(baseline_path)
        print(f"baseline written: {baseline_path} "
              f"({len(findings)} findings)")
        return EXIT_CLEAN

    if baseline_path is not None:
        base = Baseline.load(baseline_path)
        new, suppressed, stale = base.diff(findings)
    else:
        new, suppressed, stale = list(findings), [], []
    problems = list(sched_report.problems) if sched_report else []

    if args.as_json:
        payload = {
            "files_scanned": result.files_scanned,
            "rules": rules_run,
            "new": [f.to_json() for f in new],
            "suppressed": [f.to_json() for f in suppressed],
            "stale_baseline": stale,
        }
        if sched_report is not None:
            payload["sched"] = {
                "scenarios": sched_report.rows_json(),
                "problems": list(sched_report.problems),
            }
        print(json.dumps(payload, indent=2))
    else:
        for f in new:
            print(f.format())
        for e in stale:
            print(f"{e['path']}:{e['line']}: STALE baseline entry for "
                  f"{e['rule']} (finding no longer exists; run "
                  f"--update-baseline to drop it)")
        if sched_report is not None:
            from repro_torch.analysis.sched import format_sched_report
            print()
            print(format_sched_report(sched_report))
            for pr in sched_report.problems:
                print(f"SCHED PROBLEM: {pr}")
        print(f"\n{result.files_scanned} files, "
              f"{len(rules_run)} rules: "
              f"{len(new)} new finding(s), {len(suppressed)} suppressed "
              f"by baseline, {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}"
              + (f", {len(problems)} runtime problem(s)"
                 if sched_report is not None else ""))

    return EXIT_FINDINGS if (new or stale or problems) else EXIT_CLEAN
