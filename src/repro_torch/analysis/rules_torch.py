"""Torch discipline rules: explicit generators, import-time device work,
and Python-loop hot paths.

The reference's JAX rules (``repro.analysis.rules_jax``) restated for the
port. Each guards a property the federated stack leans on:

TORCH001 (for JAX001) — random draws from torch's global generator.
    The reference's client draws are stream-deterministic because every
    draw consumes an explicit key; JAX001 catches a key used twice. The
    port's counterpart of that contract is explicit generators: every
    draw in package code takes ``generator=`` (weights from
    ``torch.Generator().manual_seed(seed)``, batches from per-client
    NumPy streams). A draw from the global generator (``torch.rand*``,
    ``randperm``, ``normal_``, ``uniform_``, ``bernoulli``,
    ``multinomial``, ``dropout``, which takes no generator at all) or a
    ``torch.manual_seed`` in package code makes a result depend on every
    other draw in the process, so the same seed no longer gives the same
    clients.

JAX002 has no counterpart. It catches array-valued ``static_argnums``
    of ``jax.jit``, which recompile every call. The port compiles
    nothing (no ``jit``, no ``torch.compile``), so it has no static
    arguments to abuse; ``analysis.runtime.RecompileWatcher`` watches
    what the port does build at run time (the kernel library, and any
    ``torch._dynamo`` compile a later change might add).

TORCH003 (for JAX003) — device work at import. The port's modules
    import on a machine without a card (the tests do, and so does the
    chip script before it checks for one): a module-scope call that
    touches CUDA (``torch.cuda.*`` other than ``is_available``, a tensor
    made on ``"cuda"``, ``cuda_lib.load_library()`` / ``_build``) breaks
    that, initialises the CUDA context before the caller chose a device
    and hides a kernel build in an import.

TORCH004 (for JAX004) — per-client Python loops in the engine's hot
    path (``fl/engine.py``, ``fl/dynamics.py``), unchanged: the round
    control plane iterates per client on the host, which caps fleets at
    thousands and keeps the card waiting (ROADMAP item 17).
"""
from __future__ import annotations

import ast
import re
from typing import List

from repro_torch.analysis.engine import (ModuleRule, ParsedModule, call_name,
                                         is_main_guard,
                                         is_type_checking_guard,
                                         register_rule)

# ---------------------------------------------------------------------------
# TORCH001 — draws from the global generator / global seeding
# ---------------------------------------------------------------------------

#: ``torch.<name>(...)`` draws
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "rand_like", "randn_like", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson"})
#: in-place / method draws on any tensor (not ``.multinomial``: a NumPy
#: ``Generator`` has one too, and ``torch.multinomial`` is caught above)
_METHOD_DRAWS = frozenset({
    "normal_", "uniform_", "bernoulli_", "bernoulli", "random_",
    "exponential_", "geometric_", "log_normal_", "cauchy_"})
#: dropout in every spelling: none of them accepts a generator
_DROPOUT = re.compile(r"^(feature_)?(alpha_)?dropout([123]d)?$|"
                      r"^(Alpha|FeatureAlpha)?Dropout([123]d)?$")
_GLOBAL_SEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed",
    "torch.cuda.seed_all"})


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register_rule
class GlobalGeneratorDraw(ModuleRule):
    """TORCH001 — a random draw from torch's global generator, or global
    seeding, in package code."""

    id = "TORCH001"
    title = "draw from torch's global generator"
    rationale = ("The port's determinism contract is explicit generators: "
                 "a draw from the global generator (or a global "
                 "manual_seed) makes every later draw depend on all "
                 "earlier ones in the process, so clients stop being "
                 "stream-deterministic.")
    hint = ("pass `generator=` (a torch.Generator seeded from the run's "
            "seed) and seed that generator, never torch's global one")

    def check_module(self, mod: ParsedModule) -> List:
        findings: List = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else name)
            if name in _GLOBAL_SEEDS:
                findings.append(self.make_finding(
                    mod, node, f"'{name}(...)' seeds torch's global "
                               f"generator in package code"))
            elif _DROPOUT.match(attr):
                findings.append(self.make_finding(
                    mod, node, f"'{name or attr}(...)' draws its mask from "
                               f"torch's global generator (dropout takes "
                               f"no generator=)"))
            elif _has_generator(node):
                continue
            elif ((name.startswith("torch.") and name.count(".") == 1
                   and attr in _TORCH_DRAWS)
                  or (isinstance(node.func, ast.Attribute)
                      and attr in _METHOD_DRAWS)):
                findings.append(self.make_finding(
                    mod, node, f"'{name or attr}(...)' draws from torch's "
                               f"global generator (no generator=)"))
        return findings


# ---------------------------------------------------------------------------
# TORCH003 — device work at import time
# ---------------------------------------------------------------------------

#: ``torch.cuda.*`` calls that touch no device
_CUDA_QUERIES = frozenset({"torch.cuda.is_available"})
_LIB_LOADS = re.compile(r"(^|\.)load_library$|^(cuda_lib\.)?_build$")


def _is_cuda_literal(node: ast.AST) -> bool:
    """``"cuda"`` / ``"cuda:0"`` or ``torch.device("cuda...")``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value == "cuda" or node.value.startswith("cuda:")
    return (isinstance(node, ast.Call)
            and call_name(node) in ("torch.device", "device")
            and bool(node.args) and _is_cuda_literal(node.args[0]))


def _touches_cuda(call: ast.Call) -> str:
    """Why ``call`` touches the card, or ''."""
    name = call_name(call)
    if name.startswith("torch.cuda.") and name not in _CUDA_QUERIES:
        return f"'{name}(...)' touches the card"
    if _LIB_LOADS.search(name):
        return f"'{name}(...)' builds / loads the kernel library"
    if isinstance(call.func, ast.Attribute) and call.func.attr == "cuda":
        return "'.cuda()' moves a tensor to the card"
    if any(kw.arg == "device" and _is_cuda_literal(kw.value)
           for kw in call.keywords):
        return f"'{name or 'call'}(..., device=cuda)' makes a tensor on " \
               f"the card"
    if (isinstance(call.func, ast.Attribute) and call.func.attr == "to"
            and call.args and _is_cuda_literal(call.args[0])):
        return "'.to(cuda)' moves a tensor to the card"
    return ""


@register_rule
class ImportTimeDeviceWork(ModuleRule):
    """TORCH003 — CUDA work executed at module import."""

    id = "TORCH003"
    title = "device work at import time"
    rationale = ("The port's modules must import without a card (tests, "
                 "the chip script's own refusal): import-time CUDA work "
                 "initialises the context before the caller picked a "
                 "device and hides a kernel build in an import.")
    hint = ("move the work into a function or a lazy cache; module scope "
            "may only define callables and host constants")

    def _flag_calls(self, mod: ParsedModule, node: ast.AST,
                    findings: List) -> None:
        # manual walk so Lambda bodies are skipped: a lambda at module
        # scope only *defines* work, it doesn't run it
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Lambda):
                continue
            if isinstance(n, ast.Call):
                why = _touches_cuda(n)
                if why:
                    findings.append(self.make_finding(
                        mod, n, f"{why} at import time"))
            stack.extend(ast.iter_child_nodes(n))

    def _walk_toplevel(self, mod: ParsedModule, body: List[ast.stmt],
                       findings: List) -> None:
        for stmt in body:
            if is_main_guard(stmt) or is_type_checking_guard(stmt):
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # default-arg expressions and decorators run at import
                a = stmt.args
                for d in (list(a.defaults) + [d for d in a.kw_defaults if d]
                          + list(stmt.decorator_list)):
                    self._flag_calls(mod, d, findings)
                continue
            if isinstance(stmt, ast.ClassDef):
                self._walk_toplevel(mod, stmt.body, findings)
                continue
            if isinstance(stmt, (ast.If, ast.Try, ast.With)):
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.stmt):
                        self._walk_toplevel(mod, [sub], findings)
                    elif not isinstance(sub, ast.excepthandler):
                        self._flag_calls(mod, sub, findings)
                for handler in getattr(stmt, "handlers", ()):
                    self._walk_toplevel(mod, handler.body, findings)
                continue
            self._flag_calls(mod, stmt, findings)

    def check_module(self, mod: ParsedModule) -> List:
        findings: List = []
        self._walk_toplevel(mod, mod.tree.body, findings)
        return findings


# ---------------------------------------------------------------------------
# TORCH004 — Python loops over per-client state in the engine hot path
# ---------------------------------------------------------------------------

_CLIENTISH = re.compile(
    r"client|survivor|sampled|cohort|fleet|participant|roster")


@register_rule
class PerClientPythonLoop(ModuleRule):
    """TORCH004 — per-client Python for-loop in fl/engine.py|dynamics.py."""

    id = "TORCH004"
    title = "Python loop over per-client state in a hot path"
    rationale = ("The round control plane iterates Python-side per "
                 "client, capping fleets at thousands and leaving the "
                 "card idle between launches (ROADMAP item 17); new hot "
                 "paths must not add more.")
    hint = ("vectorize over a client axis (a batched tensor program over "
            "client-state arrays); new hot-path code must not add "
            "per-client Python loops")
    paths = ("src/repro_torch/fl/engine.py", "src/repro_torch/fl/dynamics.py")

    def check_module(self, mod: ParsedModule) -> List:
        findings: List = []
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            for node in ast.walk(fn):
                if not isinstance(node, ast.For):
                    continue
                text = ast.unparse(node.iter) + " " + ast.unparse(
                    node.target)
                if _CLIENTISH.search(text):
                    findings.append(self.make_finding(
                        mod, node,
                        f"per-client Python loop over "
                        f"'{ast.unparse(node.iter)}' in "
                        f"{fn.name}()"))
        return findings
