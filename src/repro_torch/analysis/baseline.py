"""The port's committed suppression baseline
(``ANALYSIS_BASELINE_TORCH.json``; ``ANALYSIS_BASELINE.json`` stays the
reference's).

Legacy findings live here so they don't block CI while new code is held
to zero. Entries are keyed by the finding *fingerprint* (rule + path +
source-line text + occurrence — no line numbers), so unrelated edits
that shift lines keep suppressing, but a new identical violation
elsewhere still fails.

``diff`` splits a fresh run into (new, suppressed, stale): stale
entries are baseline lines whose finding no longer exists — the CLI
reports them so the baseline can only shrink over time (run with
``--update-baseline`` to drop them).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = "ANALYSIS_BASELINE_TORCH.json"


@dataclass
class Baseline:
    """fingerprint -> the recorded entry (context only; the fingerprint
    is the key that matters)."""

    entries: Dict[str, Dict] = field(default_factory=dict)

    @classmethod
    def from_findings(cls, findings: List[Finding]) -> "Baseline":
        return cls(entries={f.fingerprint: f.to_json() for f in findings})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls()
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
        if raw.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"{path}: unsupported baseline version {raw.get('version')!r}"
                f" (expected {BASELINE_VERSION})")
        return cls(entries={e["fingerprint"]: e for e in raw["findings"]})

    def save(self, path: str) -> None:
        rows = sorted(self.entries.values(),
                      key=lambda e: (e["path"], e["line"], e["rule"]))
        payload = {"version": BASELINE_VERSION, "findings": rows}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def diff(self, findings: List[Finding]
             ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
        """-> (new, suppressed, stale_entries)."""
        fresh = {f.fingerprint: f for f in findings}
        new = [f for fp, f in fresh.items() if fp not in self.entries]
        suppressed = [f for fp, f in fresh.items() if fp in self.entries]
        stale = [e for fp, e in self.entries.items() if fp not in fresh]
        order = lambda f: (f.path, f.line, f.rule)  # noqa: E731
        return (sorted(new, key=order), sorted(suppressed, key=order),
                sorted(stale, key=lambda e: (e["path"], e["line"])))
