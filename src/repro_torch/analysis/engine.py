"""The rule engine: parse once, run every rule, collect findings.

The reference's engine (``repro.analysis.engine``) pointed at the port:
it scans ``src/repro_torch`` by default, with ``tests`` as the context
set. This module, the rule modules and ``findings`` / ``baseline`` /
``cli`` import no ``torch``: the static half runs on any machine.

Two rule kinds:

``ModuleRule``   — sees one parsed module at a time (an AST + source).
                   Most torch discipline rules are per-module.
``ProjectRule``  — sees the whole parsed file set at once, for
                   cross-file invariants (kernel/ref twins, benchmark
                   metric specs). Project rules also get read-only
                   access to *context* files (the test tree) that
                   module rules never scan — so a rule can require "a
                   test references this kernel" without the test files
                   themselves being linted.

Rules self-register via the ``@register_rule`` decorator at import
time; ``default_rules()`` imports the rule modules and returns the
registry. Every rule carries metadata (id, title, rationale, hint) the
CLI surfaces in ``--list-rules``.
"""
from __future__ import annotations

import ast
import fnmatch
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Type

from repro_torch.analysis.findings import (AnalysisResult, Finding,
                                           assign_occurrences)

#: Directories scanned by default (repo-relative), and the context set
#: project rules may read but module rules never lint.
DEFAULT_CODE_PATHS = ("src/repro_torch",)
DEFAULT_CONTEXT_PATHS = ("tests",)
#: Never scanned, even when explicitly under a scanned directory —
#: the seeded-violation fixtures live here.
EXCLUDE_GLOBS = ("tests/fixtures/*", "*/__pycache__/*", "*/.git/*")


@dataclass
class ParsedModule:
    """One parsed source file, shared by every rule."""

    path: str                 # repo-relative, forward slashes
    source: str
    tree: ast.Module
    lines: List[str] = field(default_factory=list)

    def __post_init__(self):
        if not self.lines:
            self.lines = self.source.splitlines()

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""


class Rule:
    """Base rule: metadata only. Subclass ``ModuleRule`` or
    ``ProjectRule`` and register with ``@register_rule``."""

    id: str = ""
    title: str = ""
    rationale: str = ""
    hint: str = ""
    #: fnmatch patterns over repo-relative paths; empty = every module.
    paths: Sequence[str] = ()
    #: the analyzed tree's root (set by ``Analyzer.run``), for project
    #: rules that read non-Python sources (REPRO001's ``.cu`` files)
    root: str = ""

    def applies_to(self, path: str) -> bool:
        if not self.paths:
            return True
        return any(fnmatch.fnmatch(path, pat) for pat in self.paths)

    def make_finding(self, mod: ParsedModule, node: ast.AST,
                     message: str, hint: Optional[str] = None) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=self.id, path=mod.path, line=line,
                       message=message,
                       hint=self.hint if hint is None else hint,
                       snippet=mod.line(line))


class ModuleRule(Rule):
    def check_module(self, mod: ParsedModule) -> List[Finding]:
        raise NotImplementedError


class ProjectRule(Rule):
    def check_project(self, modules: Dict[str, ParsedModule],
                      context: Dict[str, ParsedModule]) -> List[Finding]:
        raise NotImplementedError


_RULES: Dict[str, Type[Rule]] = {}


def register_rule(cls: Type[Rule]) -> Type[Rule]:
    assert cls.id, f"{cls.__name__} needs a rule id"
    _RULES[cls.id] = cls
    return cls


def default_rules() -> List[Rule]:
    """Instantiate every registered rule (importing the rule modules
    the first time so their ``@register_rule`` decorators run)."""
    _import_rule_modules()
    return [cls() for _, cls in sorted(_RULES.items())]


def rule_ids() -> List[str]:
    _import_rule_modules()
    return sorted(_RULES)


def _import_rule_modules() -> None:
    from repro_torch.analysis import rules_repro, rules_torch  # noqa: F401
    from repro_torch.analysis.sched import rules as rules_sched  # noqa: F401


# ---------------------------------------------------------------------------
# file collection + the analyzer
# ---------------------------------------------------------------------------


def _excluded(rel: str) -> bool:
    return any(fnmatch.fnmatch(rel, pat) or
               fnmatch.fnmatch(rel, pat.rstrip("*") + "**")
               for pat in EXCLUDE_GLOBS)


def collect_files(root: str, paths: Sequence[str]) -> List[str]:
    """Repo-relative .py files under ``paths`` (files or directories),
    minus the exclude globs, sorted for deterministic output."""
    out = []
    for p in paths:
        full = os.path.join(root, p)
        if os.path.isfile(full) and full.endswith(".py"):
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            if not _excluded(rel):
                out.append(rel)
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      root).replace(os.sep, "/")
                if not _excluded(rel):
                    out.append(rel)
    return sorted(set(out))


def parse_files(root: str, rels: Iterable[str]) -> Dict[str, ParsedModule]:
    out: Dict[str, ParsedModule] = {}
    for rel in rels:
        full = os.path.join(root, rel)
        try:
            with open(full, "r", encoding="utf-8") as f:
                src = f.read()
            tree = ast.parse(src, filename=rel)
        except (OSError, SyntaxError):
            continue            # unparseable files are not this tool's job
        out[rel] = ParsedModule(path=rel, source=src, tree=tree)
    return out


class Analyzer:
    """Run a rule set over a file tree and collect findings."""

    def __init__(self, root: str,
                 code_paths: Sequence[str] = DEFAULT_CODE_PATHS,
                 context_paths: Sequence[str] = DEFAULT_CONTEXT_PATHS,
                 rules: Optional[Sequence[Rule]] = None):
        self.root = os.path.abspath(root)
        self.code_paths = tuple(code_paths)
        self.context_paths = tuple(context_paths)
        self.rules = list(rules) if rules is not None else default_rules()

    def run(self) -> AnalysisResult:
        code = parse_files(self.root,
                           collect_files(self.root, self.code_paths))
        context = parse_files(self.root,
                              collect_files(self.root, self.context_paths))
        findings: List[Finding] = []
        for rule in self.rules:
            rule.root = self.root
            if isinstance(rule, ProjectRule):
                findings.extend(rule.check_project(code, context))
            elif isinstance(rule, ModuleRule):
                for mod in code.values():
                    if rule.applies_to(mod.path):
                        findings.extend(rule.check_module(mod))
        findings = assign_occurrences(findings)
        return AnalysisResult(findings=findings, files_scanned=len(code),
                              rules_run=[r.id for r in self.rules])


def run_analysis(root: str, paths: Optional[Sequence[str]] = None,
                 rules: Optional[Sequence[Rule]] = None) -> AnalysisResult:
    """One-call entry point (the CLI and tests both use it)."""
    kwargs = {}
    if paths is not None:
        kwargs["code_paths"] = paths
    return Analyzer(root, rules=rules, **kwargs).run()


# ---------------------------------------------------------------------------
# small AST helpers shared by the rule modules
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for the func of a Call, '' when not a
    plain dotted path."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(call: ast.Call) -> str:
    return dotted_name(call.func)


def is_main_guard(node: ast.stmt) -> bool:
    """``if __name__ == "__main__":`` (either comparison order)."""
    if not isinstance(node, ast.If):
        return False
    t = node.test
    if not (isinstance(t, ast.Compare) and len(t.ops) == 1
            and isinstance(t.ops[0], ast.Eq)):
        return False
    sides = [t.left] + list(t.comparators)
    names = [s.id for s in sides if isinstance(s, ast.Name)]
    consts = [s.value for s in sides if isinstance(s, ast.Constant)]
    return "__name__" in names and "__main__" in consts


def is_type_checking_guard(node: ast.stmt) -> bool:
    if not isinstance(node, ast.If):
        return False
    t = node.test
    name = dotted_name(t) if isinstance(t, (ast.Name, ast.Attribute)) else ""
    return name in ("TYPE_CHECKING", "typing.TYPE_CHECKING")
