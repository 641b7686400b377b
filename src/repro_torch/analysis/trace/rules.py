"""TRACE rules: discipline checks evaluated on traced aten graphs.

The port's counterpart of ``repro.analysis.trace.rules``: the same ids,
the same anchors (the entry point's declaration), the same
``trace:<entry>:<detail>`` fingerprints and per-entry ``allow``.

TRACE001  64-bit promotion: a node makes float64, int64, uint64 or
          complex128 from narrower inputs, or an entry output is wide
          while every input is narrower. One case is the platform's, not
          a promotion of metered bytes, and is skipped: torch's index ops
          take int64 only, so an int64 made from an integer input and
          read (through views) only as the index operand of ``gather``,
          ``index_select``, ``embedding``, ``scatter`` or ``nll_loss``
          (and their backward ops) is not flagged. Any float64, and any
          int64 that reaches an output or another op, still is.
TRACE002  missed in-place update: an update-style entry declares
          donatable arguments, but the graph writes fewer of their leaves
          in place than they have (the port's counterpart of a donation
          the compiled step does not alias).
TRACE003  dense per-client materialisation: an aggregation combine
          allocates one value of >= cohort x the largest client leaf.
TRACE004  host transfer inside a step: a read of a value on the host
          (``.item()`` / ``_local_scalar_dense``, ``nonzero``, any read
          that stopped the trace: the registry's ``host_read``), a copy
          from the device to the host, or a copy from the host of
          ``DEVICE_PUT_MIN_BYTES`` or more.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set, Type

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.trace.cost import (arg_nodes, crosses_host,
                                             iter_nodes,
                                             node_io_bytes, op_name,
                                             output_nodes, placeholders,
                                             storage_key, tensor_bytes,
                                             tensors_of)
from repro_torch.analysis.trace.registry import TracedEntry

_WIDE_DTYPES = {torch.float64, torch.int64, torch.uint64, torch.complex128}

#: staging a handful of scalars (combine weights, a divisor) is the
#: endorsed pattern: TRACE004 flags a copy from the host only once its
#: bytes stop looking like scalars; a read back to the host always fires
DEVICE_PUT_MIN_BYTES = 4096

#: ops whose index operand must be int64, by that operand's position
_INDEX_OPERAND = {
    "gather": 2, "scatter": 2, "scatter_add": 2, "scatter_reduce": 2,
    "index_select": 2, "index_add": 2, "embedding": 1,
    "embedding_dense_backward": 1, "nll_loss": 1, "nll_loss_forward": 1,
    "nll_loss_backward": 2, "nll_loss_nd": 1,
}


class TraceRule:
    """Base: metadata + one ``check`` over a traced entry."""

    id: str = ""
    title: str = ""
    rationale: str = ""
    hint: str = ""

    def check(self, traced: TracedEntry) -> List[Finding]:
        raise NotImplementedError

    def finding(self, traced: TracedEntry, detail: str,
                message: str) -> Finding:
        ep = traced.entry
        return Finding(rule=self.id, path=ep.path, line=ep.line,
                       message=f"[{ep.name}] {message}", hint=self.hint,
                       snippet=f"trace:{ep.name}:{detail}")


_TRACE_RULES: Dict[str, Type[TraceRule]] = {}


def register_trace_rule(cls: Type[TraceRule]) -> Type[TraceRule]:
    assert cls.id, f"{cls.__name__} needs a rule id"
    _TRACE_RULES[cls.id] = cls
    return cls


def trace_rules() -> List[TraceRule]:
    return [cls() for _, cls in sorted(_TRACE_RULES.items())]


def trace_rule_ids() -> List[str]:
    return sorted(_TRACE_RULES)


def run_trace_rules(traced: Sequence[TracedEntry],
                    rules: Sequence[TraceRule] = ()) -> List[Finding]:
    """Every rule over every traced entry, honouring per-entry allows."""
    ruleset = list(rules) if rules else trace_rules()
    findings: List[Finding] = []
    for t in traced:
        for rule in ruleset:
            if rule.id in t.entry.allow:
                continue
            findings.extend(rule.check(t))
    return findings


def _wide(node: torch.fx.Node) -> List[torch.Tensor]:
    return [t for t in tensors_of(node.meta.get("val"))
            if t.dtype in _WIDE_DTYPES]


def _index_only(node: torch.fx.Node) -> bool:
    """An int64 made from integer inputs and read, through views, only as
    the index operand of an op that takes int64 indices."""
    ins = [t for a in arg_nodes(node) for t in tensors_of(a.meta.get("val"))]
    if not ins or any(t.is_floating_point() or t.is_complex() for t in ins):
        return False
    frontier, seen = [node], set()
    while frontier:
        cur = frontier.pop()
        for user in cur.users:
            if user in seen:
                continue
            seen.add(user)
            target = user.target
            if getattr(target, "is_view", False):
                frontier.append(user)
                continue
            pos = _INDEX_OPERAND.get(op_name(user))
            if (pos is None or pos >= len(user.args)
                    or user.args[pos] is not cur):
                return False
    return True


@register_trace_rule
class DtypePromotion(TraceRule):
    """TRACE001 — widening to 64-bit inside a traced entry."""

    id = "TRACE001"
    title = "dtype promotion to 64-bit in traced entry"
    rationale = ("The wire and update paths are specified in f32 (and "
                 "narrower wire formats): a silent f64/i64 promotion "
                 "doubles the very bytes the memory and comm budgets "
                 "meter, and usually enters through a Python scalar or a "
                 "default dtype (torch.arange, torch.tensor of an int).")
    hint = ("pin the dtype at the source (dtype=torch.float32 / "
            "torch.int32, np.float32 scalars); keep int64 to the index "
            "operands of ops that require it")

    def check(self, traced: TracedEntry) -> List[Finding]:
        if traced.graph is None:
            return []
        out: List[Finding] = []
        seen: Set[str] = set()
        for node in iter_nodes(traced.graph):
            wide = _wide(node)
            if not wide:
                continue
            if any(t.dtype in _WIDE_DTYPES for a in arg_nodes(node)
                   for t in tensors_of(a.meta.get("val"))):
                continue                   # already wide upstream
            if all(t.dtype == torch.int64 for t in wide) and \
                    _index_only(node):
                continue                   # the index ops' own int64
            detail = f"widen:{op_name(node)}:{str(wide[0].dtype)[6:]}"
            if detail in seen:
                continue
            seen.add(detail)
            out.append(self.finding(
                traced, detail,
                f"'{op_name(node)}' widens to {str(wide[0].dtype)[6:]} "
                f"from narrower inputs"))
        wide_out = [t for n in output_nodes(traced.graph)
                    for t in tensors_of(n.meta.get("val"))
                    if t.dtype in _WIDE_DTYPES]
        wide_in = any(t.dtype in _WIDE_DTYPES
                      for n in placeholders(traced.graph)
                      for t in tensors_of(n.meta.get("val")))
        if wide_out and not wide_in:
            dt = str(wide_out[0].dtype)[6:]
            out.append(self.finding(
                traced, f"wide-output:{dt}",
                f"entry output is {dt} but every input is narrower "
                f"(promotion reaches the output/wire buffer)"))
        return out


@register_trace_rule
class MissedInPlace(TraceRule):
    """TRACE002 — declared-donatable buffers not written in place."""

    id = "TRACE002"
    title = "missed in-place update in an update step"
    rationale = ("An update step that rebinds params/opt-state every "
                 "call can overwrite those buffers; built out of place, "
                 "the old and new copies are live together and the "
                 "client's peak memory grows by its largest state: the "
                 "exact quantity Budgets.memory gates.")
    hint = ("write the rebound state in place (the optimizer's "
            "``update_``, ``mul_`` / ``copy_`` into the argument), and "
            "keep arguments the caller still reads (the round-global "
            "params) out of the donatable set")

    def check(self, traced: TracedEntry) -> List[Finding]:
        ep = traced.entry
        if not ep.donatable or traced.inplace_leaves < 0:
            return []
        expected = traced.donatable_leaves
        actual = traced.inplace_leaves
        if actual >= expected:
            return []
        return [self.finding(
            traced, "missed-donation",
            f"only {actual} of {expected} declared-donatable leaves are "
            f"written in place by the step")]


@register_trace_rule
class DenseCohortMaterialization(TraceRule):
    """TRACE003 — O(C*P) value materialised inside an aggregation."""

    id = "TRACE003"
    title = "dense per-client materialization in aggregation"
    rationale = ("Server combines must stay O(P): stacking the cohort "
                 "into one (C, ...) tensor scales server peak memory "
                 "with cohort size, which is how aggregation quietly "
                 "busts the memory budget at exactly the moment the "
                 "paper scales clients.")
    hint = ("fold incrementally (weighted add per client, as "
            "core.aggregation.aggregate does) instead of "
            "stacking/concatenating the cohort axis")

    def check(self, traced: TracedEntry) -> List[Finding]:
        ep = traced.entry
        if ep.cohort < 2 or traced.unit_bytes <= 0 or traced.graph is None:
            return []
        threshold = ep.cohort * traced.unit_bytes
        out: List[Finding] = []
        seen: Set[str] = set()
        known: Set[int] = {storage_key(t) for n in placeholders(traced.graph)
                           for t in tensors_of(n.meta.get("val"))}
        for node in iter_nodes(traced.graph):
            for t in tensors_of(node.meta.get("val")):
                key = storage_key(t)
                fresh = key not in known
                known.add(key)
                if not fresh or tensor_bytes(t) < threshold:
                    continue
                detail = f"dense-cohort:{op_name(node)}"
                if detail in seen:
                    continue
                seen.add(detail)
                out.append(self.finding(
                    traced, detail,
                    f"'{op_name(node)}' materializes {tensor_bytes(t)} B "
                    f">= cohort({ep.cohort}) * largest client leaf "
                    f"({traced.unit_bytes} B)"))
        return out


@register_trace_rule
class HostTransferInStep(TraceRule):
    """TRACE004 — host boundary crossings inside a traced entry."""

    id = "TRACE004"
    title = "host read / transfer inside a traced step"
    rationale = ("A read of a device value on the host (.item(), "
                 ".tolist(), nonzero's shape, .cpu()) inside a "
                 "steady-state step stalls the host until the card has "
                 "caught up, every call; the round-loop sync guard "
                 "(repro_torch.analysis.runtime) catches the same thing "
                 "while a run goes; this catches it before one.")
    hint = ("keep the value on the device (reduce there, read once per "
            "client or round at an EXPLICIT_READS site); stage scalars "
            "as 0-d tensors once")

    def check(self, traced: TracedEntry) -> List[Finding]:
        if traced.host_read:
            return [self.finding(
                traced, "host-read",
                f"the step reads a device value on the host and cannot be "
                f"traced ({traced.host_read})")]
        if traced.graph is None:
            return []
        out: List[Finding] = []
        seen: Set[str] = set()
        for node in iter_nodes(traced.graph):
            name = op_name(node)
            h2d, d2h = crosses_host(node)
            if not (h2d or d2h) or name in seen:
                continue
            bytes_ = sum(node_io_bytes(node))
            if h2d and not d2h and bytes_ < DEVICE_PUT_MIN_BYTES:
                continue          # scalar staging, the endorsed idiom
            seen.add(name)
            out.append(self.finding(
                traced, f"host-boundary:{name}",
                f"'{name}' crosses the host boundary inside the traced "
                f"entry ({bytes_} B per call)"))
        return out


__all__ = ["DEVICE_PUT_MIN_BYTES", "TraceRule", "register_trace_rule",
           "run_trace_rules", "trace_rule_ids", "trace_rules"]
