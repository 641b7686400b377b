"""Findings: what a rule reports, and how a finding is fingerprinted.

A ``Finding`` pins a rule violation to ``path:line`` with a message and
a fix hint. The *fingerprint* deliberately excludes the line number —
it hashes (rule, path, normalized source line text, occurrence index)
— so a committed baseline keeps suppressing a legacy finding when
unrelated edits shift it up or down the file, but a *new* identical
violation on a second line still surfaces.

The fingerprint is the reference's (``repro.analysis.findings``) byte
for byte, so the same finding fingerprints the same in both packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str            # e.g. "TORCH001"
    path: str            # repo-relative, forward slashes
    line: int            # 1-indexed
    message: str
    hint: str = ""       # how to fix it
    snippet: str = ""    # the stripped source line (fingerprint input)
    occurrence: int = 0  # nth identical (rule, path, snippet) triple

    @property
    def fingerprint(self) -> str:
        key = f"{self.rule}\x00{self.path}\x00{self.snippet}\x00{self.occurrence}"
        return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]

    def format(self) -> str:
        out = f"{self.path}:{self.line}: {self.rule} {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "hint": self.hint,
            "fingerprint": self.fingerprint,
        }


def assign_occurrences(findings: List[Finding]) -> List[Finding]:
    """Stamp each finding's ``occurrence`` index among identical
    (rule, path, snippet) triples, in line order, so two textually
    identical violations in one file get distinct fingerprints."""
    counts: Dict[tuple, int] = {}
    out = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        key = (f.rule, f.path, f.snippet)
        idx = counts.get(key, 0)
        counts[key] = idx + 1
        out.append(Finding(rule=f.rule, path=f.path, line=f.line,
                           message=f.message, hint=f.hint,
                           snippet=f.snippet, occurrence=idx))
    return out


@dataclass
class AnalysisResult:
    """Everything one analyzer run produced."""

    findings: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    rules_run: List[str] = field(default_factory=list)

    def by_rule(self) -> Dict[str, List[Finding]]:
        out: Dict[str, List[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out
