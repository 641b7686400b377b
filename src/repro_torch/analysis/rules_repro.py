"""Repro-specific rules: kernel twins and contract, benchmark metric
specs, and exact-integer wire/token accounting.

These guard the paper's core claim — exact constraint accounting — and
the port's kernel contract: every hand-written CUDA kernel is reached
through one C entry point, has a plain PyTorch twin behind one dispatch
point, counts its launches, and is pinned by a test.

REPRO002 is the reference's rule unchanged; the port has no benchmark
package yet, so only fixture trees exercise it. REPRO003 is
framework-free and ported as is.
"""
from __future__ import annotations

import ast
import fnmatch
import glob
import os
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.engine import (ModuleRule, ParsedModule,
                                         ProjectRule, call_name,
                                         register_rule)

# ---------------------------------------------------------------------------
# REPRO001 — every CUDA kernel has its C entry point, a plain twin, an ops
# dispatch, a launch counter and a test referencing it
# ---------------------------------------------------------------------------

KERNELS_DIR = "src/repro_torch/kernels"
CUDA_LIB_MODULE = f"{KERNELS_DIR}/cuda_lib.py"
REF_MODULE = f"{KERNELS_DIR}/ref.py"
OPS_MODULE = f"{KERNELS_DIR}/ops.py"
CSRC_GLOB = f"{KERNELS_DIR}/csrc/*.cu"
#: kernel modules hold the wrappers that launch the C entry points
_NOT_WRAPPERS = ("cuda_lib.py", "ref.py", "ops.py", "__init__.py")
#: the port's own tests (the context files REPRO001 reads)
TEST_GLOB = "tests/test_torch_*.py"
_LAUNCH_SUFFIX = "_launch"


def _public_functions(mod: ParsedModule) -> List[ast.FunctionDef]:
    return [n for n in mod.tree.body
            if isinstance(n, ast.FunctionDef)
            and not n.name.startswith("_")]


def _dict_assigned(mod: ParsedModule, name: str) -> Optional[ast.Dict]:
    """The dict literal bound to module-level ``name`` (plain or
    annotated assignment), or None."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if isinstance(value, ast.Dict) and any(
                isinstance(t, ast.Name) and t.id == name for t in targets):
            return value
    return None


def _str_keys(d: Optional[ast.Dict]) -> List[ast.Constant]:
    return [k for k in (d.keys if d is not None else [])
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


_EXTERN_ONE = re.compile(r'extern\s+"C"\s+[\w\s\*&:<>,]*?\b(\w+)\s*\(')
_EXTERN_BLOCK = re.compile(r'extern\s+"C"\s*\{')
_TOP_DEF = re.compile(r'^[A-Za-z_][\w\s\*&:<>,]*?\b(\w+)\s*\(', re.M)


def extern_c_names(source: str) -> Set[str]:
    """Names a CUDA source defines or declares with C linkage: single
    ``extern "C" int f(...)`` declarations and the top-level functions
    of ``extern "C" { ... }`` blocks."""
    names = set(_EXTERN_ONE.findall(source))
    for block in _EXTERN_BLOCK.finditer(source):
        depth, i = 1, block.end()
        top: List[str] = []          # the block's text outside any braces
        while i < len(source) and depth:
            ch = source[i]
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
            elif depth == 1:
                top.append(ch)
            i += 1
        names |= set(_TOP_DEF.findall("".join(top)))
    return names


def _launch_wrappers(mod: ParsedModule, entry: str) -> Set[str]:
    """Top-level functions of ``mod`` that launch ``entry`` (hold its
    name as a string) or call, within the module, one that does."""
    funcs = {n.name: n for n in mod.tree.body
             if isinstance(n, ast.FunctionDef)}
    reach = {name for name, fn in funcs.items()
             if any(isinstance(c, ast.Constant) and c.value == entry
                    for c in ast.walk(fn))}
    grew = True
    while grew:
        grew = False
        for name, fn in funcs.items():
            if name in reach:
                continue
            called = {call_name(c).rsplit(".", 1)[-1]
                      for c in ast.walk(fn) if isinstance(c, ast.Call)}
            if called & reach:
                reach.add(name)
                grew = True
    return reach


@register_rule
class KernelRefTwin(ProjectRule):
    """REPRO001 — every CUDA kernel keeps its C entry point, plain twin,
    ops dispatch, launch counter and test."""

    id = "REPRO001"
    title = "CUDA kernel without entry point / twin / dispatch / counter / test"
    rationale = ("The port's correctness story is the plain PyTorch twin "
                 "and the launch count: every kernel in cuda_lib's "
                 "_SIGNATURES must be defined with C linkage in "
                 "kernels/csrc, have a kernels/ref.py twin, be "
                 "dispatched through kernels/ops.py, count its launches "
                 "in LAUNCHES, and be pinned by a tests/test_torch_* "
                 "test; a kernel that loses any of these can drift or "
                 "drop off the main path unseen.")
    hint = ("define `<name>_launch` in an extern \"C\" block of "
            "kernels/csrc/*.cu, add `<name>_ref` to kernels/ref.py, "
            "dispatch both in kernels/ops.py, add a LAUNCHES key, and "
            "pin kernel-vs-twin equality in tests/test_torch_*.py")

    def check_project(self, modules: Dict[str, ParsedModule],
                      context: Dict[str, ParsedModule]) -> List:
        lib = modules.get(CUDA_LIB_MODULE)
        if lib is None:
            return []
        entries = [k for k in _str_keys(_dict_assigned(lib, "_SIGNATURES"))
                   if k.value.endswith(_LAUNCH_SUFFIX)]
        counters = {k.value for k in _str_keys(_dict_assigned(lib,
                                                              "LAUNCHES"))}
        extern: Set[str] = set()
        for path in sorted(glob.glob(os.path.join(self.root, CSRC_GLOB))):
            with open(path, "r", encoding="utf-8") as fh:
                extern |= extern_c_names(fh.read())
        ref = modules.get(REF_MODULE)
        ops = modules.get(OPS_MODULE)
        ref_bases = ([f.name[:-4] for f in _public_functions(ref)
                      if f.name.endswith("_ref")] if ref else [])
        ops_src = ops.source if ops else ""
        wrappers = [m for p, m in sorted(modules.items())
                    if os.path.dirname(p) == KERNELS_DIR
                    and os.path.basename(p) not in _NOT_WRAPPERS]
        test_src = "\n".join(m.source for p, m in sorted(context.items())
                             if fnmatch.fnmatch(p, TEST_GLOB))
        findings: List = []
        for key in entries:
            entry = key.value
            name = entry[:-len(_LAUNCH_SUFFIX)]

            def flag(msg: str) -> None:
                findings.append(self.make_finding(lib, key, msg))

            if entry not in extern:
                flag(f"kernel '{name}': no extern \"C\" definition of "
                     f"'{entry}' in kernels/csrc/*.cu")
            if name not in counters:
                flag(f"kernel '{name}' has no LAUNCHES counter in "
                     f"kernels/cuda_lib.py")
            twin = name if name in ref_bases else next(
                (b for b in ref_bases
                 if name.startswith(b) or b.startswith(name)), None)
            if twin is None:
                flag(f"kernel '{name}' has no plain twin in kernels/ref.py")
                continue
            callers = {name}
            for mod in wrappers:
                callers |= {f for f in _launch_wrappers(mod, entry)
                            if not f.startswith("_")}
            if not any(re.search(rf"\b{re.escape(c)}\b", ops_src)
                       for c in callers):
                flag(f"kernel '{name}' is not dispatched in kernels/ops.py")
            if f"{twin}_ref" not in ops_src:
                flag(f"kernel '{name}': its twin '{twin}_ref' is not "
                     f"dispatched in kernels/ops.py")
            # a test may pin the kernel directly, its twin, or the
            # ops-level dispatch wrapper (the twin's base name)
            if not any(re.search(rf"\b{re.escape(pat)}\b", test_src)
                       for pat in (name, f"{twin}_ref", twin)):
                flag(f"kernel '{name}' has no tests/test_torch_* test "
                     f"referencing it or its twin")
        return findings




# ---------------------------------------------------------------------------
# REPRO002 — every emitted benchmark metric has a MetricSpec
# ---------------------------------------------------------------------------

_VALID_DIRECTIONS = {"higher", "lower"}
#: non-metric keys the runner strips before validation (descriptive
#: context strings, as the reference's bench runner does)
_NON_METRIC_KEYS = {"context"}


def _decl_metric_names(dec: ast.Call) -> Optional[Set[str]]:
    """Metric names a @benchmark(...) decorator declares; None when any
    spec name is dynamic (f-string / comprehension) — the set is then
    open and emitted keys cannot be checked statically."""
    metrics_node = None
    for kw in dec.keywords:
        if kw.arg == "metrics":
            metrics_node = kw.value
    if metrics_node is None and len(dec.args) >= 3:  # positional form
        metrics_node = dec.args[2]
    if metrics_node is None:
        return set()
    if not isinstance(metrics_node, (ast.List, ast.Tuple)):
        return None
    names: Set[str] = set()
    for el in metrics_node.elts:
        if not (isinstance(el, ast.Call)
                and call_name(el).endswith("MetricSpec")):
            return None
        name_node = el.args[0] if el.args else next(
            (kw.value for kw in el.keywords if kw.arg == "name"), None)
        if isinstance(name_node, ast.Constant) and isinstance(
                name_node.value, str):
            names.add(name_node.value)
        else:
            return None          # dynamic name: open set
    return names


@register_rule
class BenchMetricSpec(ProjectRule):
    """REPRO002 — benchmark return keys must be declared MetricSpecs."""

    id = "REPRO002"
    title = "benchmark emits a metric without a MetricSpec"
    rationale = ("The perf ratchet is direction-aware: a metric without "
                 "a declared MetricSpec (unit + better-direction) cannot "
                 "be compared and silently escapes the CI ratchet.")
    hint = ("declare the metric in the @benchmark(metrics=[...]) list "
            "with its unit and direction")
    paths = ("benchmarks/*.py",)

    def check_project(self, modules: Dict[str, ParsedModule],
                      context: Dict[str, ParsedModule]) -> List:
        findings: List = []
        for path, mod in modules.items():
            if not self.applies_to(path):
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.FunctionDef):
                    continue
                for dec in node.decorator_list:
                    if not (isinstance(dec, ast.Call)
                            and call_name(dec).endswith("benchmark")):
                        continue
                    declared = _decl_metric_names(dec)
                    self._check_direction_literals(mod, dec, findings)
                    if declared is None:
                        continue     # dynamic spec list: runner validates
                    for ret in [n for n in ast.walk(node)
                                if isinstance(n, ast.Return)]:
                        if not isinstance(ret.value, ast.Dict):
                            continue
                        for key in ret.value.keys:
                            if (isinstance(key, ast.Constant)
                                    and isinstance(key.value, str)
                                    and key.value not in _NON_METRIC_KEYS
                                    and key.value not in declared):
                                findings.append(self.make_finding(
                                    mod, key,
                                    f"metric '{key.value}' is returned "
                                    f"but has no MetricSpec in the "
                                    f"@benchmark declaration"))
        return findings

    def _check_direction_literals(self, mod: ParsedModule, dec: ast.Call,
                                  findings: List) -> None:
        for call in [n for n in ast.walk(dec) if isinstance(n, ast.Call)
                     and call_name(n).endswith("MetricSpec")]:
            for kw in call.keywords:
                if (kw.arg == "direction"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value not in _VALID_DIRECTIONS):
                    findings.append(self.make_finding(
                        mod, kw.value,
                        f"MetricSpec direction {kw.value.value!r} is not "
                        f"one of {sorted(_VALID_DIRECTIONS)}"))


# ---------------------------------------------------------------------------
# REPRO003 — wire/token accounting must stay exact-integer
# ---------------------------------------------------------------------------

_WIRE_FN = re.compile(r"wire_bytes|wire_mb")
_TOKEN_TARGET = re.compile(
    r"(^|_)(debt|token_budget|token_debt|tokens_owed|wire_bytes)s?$")


def _target_root_name(node: ast.AST) -> str:
    """Innermost identifier of an assignment target: ``self._debt[cid]``
    -> '_debt', ``wire_bytes`` -> 'wire_bytes'."""
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _float_ops(value: ast.AST) -> List[ast.AST]:
    """Div nodes / float constants / float() casts, one per line."""
    out: List[ast.AST] = []
    seen_lines: Set[int] = set()
    for n in ast.walk(value):
        hit = ((isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div))
               or (isinstance(n, ast.Constant)
                   and isinstance(n.value, float))
               or (isinstance(n, ast.Call) and call_name(n) == "float"))
        line = getattr(n, "lineno", 0)
        if hit and line not in seen_lines:
            seen_lines.add(line)
            out.append(n)
    return out


@register_rule
class ExactWireAccounting(ModuleRule):
    """REPRO003 — float arithmetic flowing into exact accounting."""

    id = "REPRO003"
    title = "float arithmetic in wire-bytes / token-budget accounting"
    rationale = ("Wire bytes and token budgets are the paper's exact "
                 "constraint ledgers (Eq. 5-8): true division or float "
                 "constants make them drift; the reference fixed one "
                 "such bug by hand and this rule keeps it fixed.")
    hint = ("count with integer arithmetic (`*`, `//`, `-(-n // b)` for "
            "ceil-div); convert to float only at the MB reporting edge")

    def check_module(self, mod: ParsedModule) -> List:
        raw: List = []
        findings = raw
        # (a) any function whose name smells like wire accounting
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.FunctionDef)
                    and _WIRE_FN.search(node.name)):
                for bad in self._body_float_ops(node):
                    findings.append(self.make_finding(
                        mod, bad,
                        f"float arithmetic in wire accounting "
                        f"function '{node.name}'"))
        # (b) assignments to token/debt-ish names anywhere
        for node in ast.walk(mod.tree):
            targets: List[ast.AST] = []
            value: Optional[ast.AST] = None
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            if value is None:
                continue
            for tgt in targets:
                name = _target_root_name(tgt)
                if _TOKEN_TARGET.search(name):
                    for bad in _float_ops(value):
                        findings.append(self.make_finding(
                            mod, bad,
                            f"float arithmetic assigned to exact "
                            f"accounting name '{name}'"))
        seen: Set[int] = set()
        out: List = []
        for f in raw:
            if f.line not in seen:
                seen.add(f.line)
                out.append(f)
        return out

    @staticmethod
    def _body_float_ops(fn: ast.FunctionDef) -> List[ast.AST]:
        out: List[ast.AST] = []
        seen: Set[int] = set()
        for stmt in fn.body:
            for bad in _float_ops(stmt):
                line = getattr(bad, "lineno", 0)
                if line not in seen:
                    seen.add(line)
                    out.append(bad)
        return out
