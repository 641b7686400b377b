"""SCHED rules: static schedule-determinism analysis of the port's fl
control plane.

The reference's SCHED001-004 (``repro.analysis.sched.rules``) on
``src/repro_torch/fl``, with torch's folds (``torch.sum`` /
``torch.mean`` and the ``.sum()`` / ``.mean()`` of a stacked report
buffer) and ``torch.Generator`` added.

The event-driven engine admits many legal delivery orders for the same
physical run (simultaneous arrivals, buffered fills, churn). The
determinism contract (``repro_torch.fl.aggregator`` module docstring) says
round results must be a function of the report *set*, never of the
delivery schedule. These rules flag the code shapes that break it:

    SCHED001  order-sensitive float folds over client-report buffers
              (float + is not associative; fold in canonical order)
    SCHED002  iteration over unordered containers feeding round
              composition (set iteration order is salted per process;
              dict order is insertion = delivery order)
    SCHED003  event ordering on a bare timestamp (simultaneous
              arrivals compare equal -> the sort is schedule-dependent;
              tie-break like ``TimedReport.sort_key``)
    SCHED004  RNG streams owned by components instead of threaded by
              the engine (draw order then depends on the call schedule)

All four are scoped to the control-plane modules (``fl/clock.py``,
``fl/aggregator.py``, ``fl/engine.py``, ``fl/dynamics.py``) — the only
places delivery order exists. The runtime counterpart (the
happens-before checker + ``SchedulePermuter``) lives in the sibling
modules; together they are the machine-checked side of the contract.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set

from repro_torch.analysis.engine import (ModuleRule, ParsedModule,
                                         call_name, dotted_name,
                                         register_rule)
from repro_torch.analysis.findings import Finding

#: where delivery order exists: the four control-plane modules
SCHED_PATHS = ("src/repro_torch/fl/clock.py",
               "src/repro_torch/fl/aggregator.py",
               "src/repro_torch/fl/engine.py",
               "src/repro_torch/fl/dynamics.py")
#: where client reports are folded into floats
FOLD_PATHS = ("src/repro_torch/fl/aggregator.py",
              "src/repro_torch/fl/engine.py")

#: names that hold buffered client reports (the things whose order is
#: a delivery schedule, not a property of the round)
_BUFFERISH = re.compile(r"^_?(reports?|buf(fer(ed)?)?|reporters|pending|"
                        r"inbox)$")
#: containers whose iteration order tracks the delivery schedule
_UNORDEREDISH = re.compile(r"pending|busy|in_flight|inbox|buf")
#: single-attribute sort keys that are timestamps (ties possible)
_TIMEISH = frozenset({"arrival", "arrival_time", "time", "timestamp",
                      "t", "t_end", "due", "finish", "finish_time"})
#: order-sensitive float reductions (math.fsum is order-robust enough
#: to exempt; np.stack/concatenate preserve order rather than fold)
_FOLDS = frozenset({"sum", "np.mean", "np.sum", "np.average",
                    "numpy.mean", "numpy.sum", "numpy.average",
                    "jnp.mean", "jnp.sum", "statistics.mean",
                    "torch.sum", "torch.mean"})
_FOLD_METHODS = ("_combine", "aggregate")
#: tensor reductions: ``x.sum()`` / ``x.mean()`` fold their receiver
_TENSOR_FOLDS = ("sum", "mean")
#: order-preserving stackers looked through to the buffer they stack
_STACKERS = frozenset({"torch.stack", "torch.cat", "torch.tensor",
                       "torch.as_tensor", "np.stack", "np.array",
                       "np.asarray", "np.concatenate", "list", "tuple"})
#: canonicalizers: a name (re)assigned through one of these holds a
#: schedule-independent ordering
_CANONICALIZERS = frozenset({"canonical_order", "sorted"})
_RNG_CTORS = frozenset({"np.random.default_rng", "numpy.random.default_rng",
                        "np.random.RandomState", "numpy.random.RandomState",
                        "np.random.Generator", "numpy.random.Generator",
                        "torch.Generator"})
_RNG_SINGLETON = re.compile(
    r"^(np|numpy)\.random\.(random|random_sample|rand|randn|randint|"
    r"choice|shuffle|permutation|normal|uniform|integers|standard_normal|"
    r"binomial|exponential)$")


def _terminal(node: ast.AST) -> str:
    """The rightmost name of a load: ``reports`` -> reports,
    ``self._buf`` -> _buf, anything else -> ''."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return ""


def _iter_names(node: ast.AST) -> Set[str]:
    """Terminal names iterated by an ``iter`` expression; looks through
    order-preserving wrappers (zip/enumerate/reversed/list/tuple)."""
    if isinstance(node, ast.Call) and call_name(node) in (
            "zip", "enumerate", "reversed", "list", "tuple"):
        out: Set[str] = set()
        for arg in node.args:
            out |= _iter_names(arg)
        return out
    name = _terminal(node)
    return {name} if name else set()


def _unstack(node: ast.AST) -> ast.AST:
    """Look through order-preserving stackers (``torch.stack(x)`` ->
    ``x``): stacking a buffer keeps its delivery order."""
    while (isinstance(node, ast.Call) and node.args
           and call_name(node) in _STACKERS):
        node = node.args[0]
    return node


def _is_tensor_fold(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in _TENSOR_FOLDS
            and call_name(call) not in _FOLDS)


def _fold_operands(call: ast.Call) -> List[ast.AST]:
    """What a fold call folds: its arguments, and for ``x.sum()`` /
    ``x.mean()`` its receiver, each looked through its stackers."""
    ops = list(call.args)
    if _is_tensor_fold(call):
        ops = [call.func.value]
    return [_unstack(op) for op in ops]


def _scopes(tree: ast.Module) -> Iterable[ast.AST]:
    """Module body + every function, like the dataflow rules: name
    bindings are tracked per scope, not across the file."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _scope_statements(scope: ast.AST) -> List[ast.stmt]:
    return list(getattr(scope, "body", []))


def _walk_scope(scope: ast.AST) -> Iterable[ast.AST]:
    """Walk a scope without descending into nested functions (they are
    their own scopes and would otherwise be scanned twice)."""
    stack: List[ast.AST] = [
        s for s in _scope_statements(scope)
        if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.append(child)


def _canonical_names(scope: ast.AST) -> Set[str]:
    """Names assigned (anywhere in the scope) from ``canonical_order``
    or ``sorted`` — their iteration order is schedule-independent."""
    out: Set[str] = set()
    for node in _walk_scope(scope):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if call_name(node.value) in _CANONICALIZERS:
                for tgt in node.targets:
                    name = _terminal(tgt)
                    if name:
                        out.add(name)
    return out


@register_rule
class OrderSensitiveReportFold(ModuleRule):
    """SCHED001: float folds over buffered client reports in delivery
    order. Float addition reassociates differently under every
    schedule permutation; the applied update / accounting then depends
    on *when* reports arrived, not just *which* arrived."""

    id = "SCHED001"
    title = "order-sensitive float fold over client reports"
    rationale = ("float folds are not associative: summing a report "
                 "buffer in delivery order makes round results a "
                 "function of the event schedule, which breaks the "
                 "determinism contract FedBuff-style async relies on")
    hint = ("fold in canonical report order (canonical_order / "
            "report_order_key) or use an exact representation (the "
            "uint64 masked sum is order-free mod 2^64)")
    paths = FOLD_PATHS

    def check_module(self, mod: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        for scope in _scopes(mod.tree):
            findings.extend(self._check_scope(mod, scope))
        return findings

    def _is_fold(self, call: ast.Call) -> bool:
        name = call_name(call)
        if name in _FOLDS or _is_tensor_fold(call):
            return True
        return any(name == m or name.endswith("." + m)
                   for m in _FOLD_METHODS)

    def _check_scope(self, mod: ParsedModule,
                     scope: ast.AST) -> List[Finding]:
        canonical = _canonical_names(scope)
        # names assigned from a comprehension -> the buffers it iterated
        comp_sources: Dict[str, Set[str]] = {}
        for node in _walk_scope(scope):
            if isinstance(node, ast.Assign) and isinstance(
                    _unstack(node.value), (ast.ListComp, ast.GeneratorExp)):
                srcs: Set[str] = set()
                for gen in _unstack(node.value).generators:
                    srcs |= _iter_names(gen.iter)
                for tgt in node.targets:
                    name = _terminal(tgt)
                    if name:
                        comp_sources[name] = srcs

        def bad_buffers(names: Set[str]) -> Set[str]:
            return {n for n in names
                    if _BUFFERISH.match(n) and n not in canonical}

        findings: List[Finding] = []
        for node in _walk_scope(scope):
            if isinstance(node, ast.Call) and self._is_fold(node):
                for arg in _fold_operands(node):
                    if isinstance(arg, (ast.ListComp, ast.GeneratorExp)):
                        names: Set[str] = set()
                        for gen in arg.generators:
                            names |= _iter_names(gen.iter)
                    elif isinstance(arg, ast.Name):
                        names = comp_sources.get(arg.id, set())
                    else:
                        continue
                    for buf in sorted(bad_buffers(names)):
                        findings.append(self.make_finding(
                            mod, node,
                            f"{call_name(node)}() folds report buffer "
                            f"'{buf}' in delivery order"))
            elif isinstance(node, ast.For):
                bufs = bad_buffers(_iter_names(node.iter))
                if not bufs:
                    continue
                for stmt in ast.walk(node):
                    if isinstance(stmt, ast.AugAssign):
                        findings.append(self.make_finding(
                            mod, stmt,
                            f"accumulation inside a loop over report "
                            f"buffer '{sorted(bufs)[0]}' folds in "
                            f"delivery order"))
        return findings


@register_rule
class UnorderedContainerIteration(ModuleRule):
    """SCHED002: round composition iterating a set (per-process salted
    order) or a schedule-tracking dict (insertion order = delivery
    order) without sorting first."""

    id = "SCHED002"
    title = "iteration over unordered container in round composition"
    rationale = ("set iteration order varies across processes and dict "
                 "order is insertion order — for busy/pending maps that "
                 "IS the delivery schedule, so anything composed from "
                 "such an iteration depends on it")
    hint = "iterate sorted(...) (any total order will do)"
    paths = SCHED_PATHS

    def check_module(self, mod: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        for scope in _scopes(mod.tree):
            findings.extend(self._check_scope(mod, scope))
        return findings

    def _check_scope(self, mod: ParsedModule,
                     scope: ast.AST) -> List[Finding]:
        canonical = _canonical_names(scope)
        set_names: Set[str] = set()
        sorted_comps: Set[int] = set()
        for node in _walk_scope(scope):
            value = None
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                value, targets = node.value, [node.target]
            if value is not None:
                is_set = isinstance(value, (ast.Set, ast.SetComp)) or (
                    isinstance(value, ast.Call)
                    and call_name(value) in ("set", "frozenset"))
                if is_set:
                    for tgt in targets:
                        name = _terminal(tgt)
                        if name:
                            set_names.add(name)
            if isinstance(node, ast.Call) and call_name(node) == "sorted":
                for arg in node.args:
                    if isinstance(arg, (ast.GeneratorExp, ast.ListComp,
                                        ast.SetComp)):
                        sorted_comps.add(id(arg))

        def check_iter(it: ast.AST, where: ast.AST) -> None:
            name = _terminal(it)
            if (isinstance(it, ast.Name) and name in set_names
                    and name not in canonical):
                findings.append(self.make_finding(
                    mod, where,
                    f"iteration over set '{name}' (per-process order)"))
            elif (isinstance(it, ast.Call)
                  and isinstance(it.func, ast.Attribute)
                  and it.func.attr in ("keys", "values", "items")):
                owner = _terminal(it.func.value)
                if _UNORDEREDISH.search(owner) and owner not in canonical:
                    findings.append(self.make_finding(
                        mod, where,
                        f"iteration over {owner}.{it.func.attr}() "
                        f"(insertion order = delivery order)"))

        findings: List[Finding] = []
        for node in _walk_scope(scope):
            if isinstance(node, ast.For):
                check_iter(node.iter, node)
            elif isinstance(node, (ast.GeneratorExp, ast.ListComp,
                                   ast.SetComp, ast.DictComp)):
                if id(node) in sorted_comps:
                    continue
                for gen in node.generators:
                    check_iter(gen.iter, node)
        return findings


@register_rule
class UntiedTimestampOrder(ModuleRule):
    """SCHED003: ordering events by a bare timestamp. Simultaneous
    arrivals compare equal, so the resulting order is whatever the
    input order was — i.e. the schedule leaks through the sort."""

    id = "SCHED003"
    title = "timestamp ordering without a total-order tie-break"
    rationale = ("a key like `lambda e: e.arrival` leaves simultaneous "
                 "events tied; stable sorts then preserve delivery "
                 "order, making downstream folds schedule-dependent")
    hint = ("tie-break into a total order, like TimedReport.sort_key's "
            "(arrival, tie, seq) or report_order_key's "
            "(round, arrival, client_id)")
    paths = SCHED_PATHS

    def check_module(self, mod: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            is_order = name in ("sorted", "min", "max") or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "sort")
            if not is_order:
                continue
            for kw in node.keywords:
                if kw.arg != "key":
                    continue
                attr = self._single_time_attr(kw.value)
                if attr:
                    findings.append(self.make_finding(
                        mod, node,
                        f"{name or 'sort'}() orders by bare timestamp "
                        f"'.{attr}' — simultaneous events stay tied"))
        return findings

    @staticmethod
    def _single_time_attr(key: ast.AST) -> str:
        if isinstance(key, ast.Lambda) and isinstance(key.body,
                                                      ast.Attribute):
            if key.body.attr in _TIMEISH:
                return key.body.attr
        if isinstance(key, ast.Call) and dotted_name(key.func) in (
                "attrgetter", "operator.attrgetter"):
            if len(key.args) == 1 and isinstance(key.args[0], ast.Constant):
                val = key.args[0].value
                if isinstance(val, str) and val in _TIMEISH:
                    return val
        return ""


@register_rule
class SharedComponentRNG(ModuleRule):
    """SCHED004: RNG streams owned by control-plane components. The
    engine threads ONE generator through the loop in a fixed call
    order; a component that keeps its own stream (or draws from the
    numpy global singleton, or seeds from entropy) makes draw order —
    and therefore sampling — depend on the event schedule."""

    id = "SCHED004"
    title = "component-owned / unseeded RNG stream"
    rationale = ("the engine's determinism rests on one rng threaded "
                 "in a fixed order; component-held generators and "
                 "global-singleton draws resequence under schedule "
                 "permutation, and unseeded generators differ per run")
    hint = ("accept the engine's rng as a parameter, or derive a "
            "per-call generator from explicit keys "
            "(np.random.default_rng([seed, round, ...]))")
    paths = SCHED_PATHS

    def check_module(self, mod: ParsedModule) -> List[Finding]:
        findings: List[Finding] = []
        for stmt in mod.tree.body:
            if isinstance(stmt, ast.Assign) and isinstance(
                    stmt.value, ast.Call) and \
                    call_name(stmt.value) in _RNG_CTORS:
                findings.append(self.make_finding(
                    mod, stmt,
                    "module-level RNG is shared by every component "
                    "that imports it"))
        # ``torch.Generator().manual_seed(s)`` is seeded where it is made
        seeded = {id(n.func.value) for n in ast.walk(mod.tree)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)
                  and n.func.attr == "manual_seed"}
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if _RNG_SINGLETON.match(name):
                findings.append(self.make_finding(
                    mod, node,
                    f"{name}() draws from the process-global RNG "
                    f"singleton"))
            if (name in _RNG_CTORS and not node.args and not node.keywords
                    and id(node) not in seeded):
                findings.append(self.make_finding(
                    mod, node,
                    f"{name}() without a seed draws entropy — runs "
                    f"are not replayable"))
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call) and \
                    call_name(node.value) in _RNG_CTORS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Attribute) and isinstance(
                            tgt.value, ast.Name) and tgt.value.id == "self":
                        findings.append(self.make_finding(
                            mod, node,
                            f"RNG stored on component state "
                            f"(self.{tgt.attr}); draw order then "
                            f"depends on the call schedule"))
        return findings


SCHED_RULE_IDS = ("SCHED001", "SCHED002", "SCHED003", "SCHED004")
