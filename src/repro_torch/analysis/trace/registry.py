"""Traceable entry points: what gets traced, and under which shapes.

The port's counterpart of ``repro.analysis.trace.registry``. Hot modules
declare their own entry points in a module-level ``trace_entry_points()
-> list[EntryPoint]`` hook (``repro_torch.core.client``, ``.fl.executor``,
``.fl.aggregator``, ``.kernels.ops``, ``.constraints.controllers``);
``collect_entry_points`` imports those modules and gathers the
declarations, so the shapes live next to the code they describe.

An ``EntryPoint`` is lazy: ``build()`` constructs the callable and its
example arguments as real CPU tensors (the tiny model's parameters from
a seeded generator, batches drawn from another), so the same declaration
also runs for real on the card (``chip_smoke.py``'s ``trace`` phase).
``trace_entry`` turns every tensor argument into a fake tensor of the
same shape and dtype and records the aten
graph with ``make_fx``, the kernels replaced by their opaque stand-ins
(``kernels.stand_ins``). Nothing is allocated, so the committed
``TRACE_BUDGETS_TORCH.json`` is the same wherever it is computed. Its
rows stay comparable while the declarations stay fixed: changing one is
a table re-record.

Two of the reference's fields change meaning:

- ``x64`` is gone: it switched JAX into 64-bit mode for fixture entries,
  and torch has float64 and int64 natively.
- ``aliased_outputs`` becomes ``inplace_leaves``: the leaves of the
  declared donatable arguments that the graph writes in place. The port
  has no ``jit`` and no donation; its counterpart of a donated buffer is
  one the step overwrites.

Every entry traces on fake ``meta`` tensors, which stand for the card:
``kernels.stand_ins.kernel_stand_ins`` makes ``kernels/ops.py`` send
them to the kernels' stand-ins, the CUDA branch. Fake CUDA tensors would
say so more plainly, but a CPU-only torch cannot differentiate or index
them (both ask for CUDA's device guard), and the port branches on the
device only in ``kernels/ops.py``. A copy to the host shows as a copy
from ``meta`` to ``cpu``.

A read of a value on the host (``.item()``, ``.tolist()``, a data-
dependent shape such as ``nonzero``) has no value on fake tensors: the
trace either stops with a data-dependent error or records the read with
an unbacked size after it. Either way ``trace_entry`` records the read
on the entry (``host_read``), which TRACE004 reports, and prices the
entry no further, instead of failing the run.
"""
from __future__ import annotations

import functools
import importlib
import inspect
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException)
from torch.fx.experimental.proxy_tensor import make_fx
from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.analysis.trace.cost import (HOST_READ_OPS, GraphCost,
                                             cost_of_graph, iter_nodes,
                                             op_name, placeholders,
                                             storage_key, tensor_bytes,
                                             tensors_of, written_storages)
from repro_torch.kernels.stand_ins import kernel_stand_ins

#: modules whose ``trace_entry_points()`` hooks feed the registry
TRACE_ENTRY_MODULES: Tuple[str, ...] = (
    "repro_torch.core.client",
    "repro_torch.fl.executor",
    "repro_torch.fl.aggregator",
    "repro_torch.kernels.ops",
    "repro_torch.constraints.controllers",
)

#: char-LM dims every declared entry shares (the reference's: tiny, so
#: tracing is cheap; the gate uses the *ratios* between operating points)
TRACE_MODEL = {"vocab": 64, "num_layers": 2, "d_model": 32, "num_heads": 2,
               "head_dim": 16, "d_ff": 64, "seq_len": 64}

#: host reads a fake tensor cannot answer
HOST_READ_ERRORS = (DataDependentOutputException,
                    DynamicOutputShapeException,
                    GuardOnDataDependentSymNode)


@dataclass(frozen=True)
class EntryPoint:
    """One registered traceable callable and its declared example shapes."""

    name: str                     # e.g. "fl.client_update_step"
    path: str                     # repo-relative module declaring it
    line: int                     # declaration anchor for findings
    build: Callable[[], Tuple[Callable[..., Any], Tuple[Any, ...]]]
    #: argnums an update-style step should overwrite in place (TRACE002
    #: checks that the graph writes every leaf of them)
    donatable: Tuple[int, ...] = ()
    #: >= 2 marks an aggregation combine over a client cohort (TRACE003)
    cohort: int = 0
    #: takes part in the Budgets.memory static feasibility gate
    gated: bool = False
    #: the baseline-knobs twin whose peak defines bytes per memory unit
    calibration: bool = False
    #: TRACE rule ids intentionally suppressed for this entry
    allow: Tuple[str, ...] = ()
    note: str = ""


@dataclass
class TracedEntry:
    """One entry point after tracing: the graph plus its static cost."""

    entry: EntryPoint
    graph: Optional[torch.fx.GraphModule]
    cost: GraphCost
    donatable_leaves: int = 0     # leaves under the donatable argnums
    inplace_leaves: int = -1      # of those, written in place; -1: none
    donated: Tuple[int, ...] = ()  # graph inputs of those leaves
    unit_bytes: int = 0           # largest per-client leaf (TRACE003)
    host_read: str = ""           # the host read that stopped the trace


#: the checkout holding ``src/repro_torch/analysis/trace/registry.py``
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))


def anchor(obj: Any) -> Dict[str, Any]:
    """``path`` (repo-relative) and ``line`` of a function's or class's
    definition (its ``def`` line), the anchor of its entry's findings."""
    fn = inspect.unwrap(obj)
    rel = os.path.relpath(inspect.getsourcefile(fn), _ROOT)
    lines, first = inspect.getsourcelines(fn)
    decorators = next(i for i, text in enumerate(lines)
                      if text.lstrip().startswith(("def ", "class ")))
    return {"path": rel.replace(os.sep, "/"), "line": first + decorators}


def charlm_trace_setup(b: int, seq: Optional[int] = None,
                       model: Optional[Dict[str, int]] = None) -> Any:
    """The char-LM fixture of the fl.* declarations: a ``ClientRunner``
    (on the CPU; the traced functions take their device from their
    arguments), its parameters from a seeded generator, and a batch of
    ``b`` sequences of tokens drawn from another. ``model`` overrides
    ``TRACE_MODEL``'s dims (the full width in ``chip_smoke.py``)."""
    from repro_torch.configs import get_config, get_fl_config
    from repro_torch.core.client import ClientRunner
    from repro_torch.models import build

    dims = dict(TRACE_MODEL, **(model or {}))
    seq = dims["seq_len"] if seq is None else seq
    cfg = get_config("charlm-shakespeare").replace(
        vocab_size=dims["vocab"], num_layers=dims["num_layers"],
        d_model=dims["d_model"], num_heads=dims["num_heads"],
        num_kv_heads=dims["num_heads"], head_dim=dims["head_dim"],
        d_ff=dims["d_ff"])
    fl = get_fl_config().replace(seq_len=seq)
    mdl = build(cfg)
    runner = ClientRunner(mdl, fl, data=None, resources=None, device="cpu")
    params = dict(mdl.init(torch.Generator().manual_seed(0), "cpu").params())
    gen = torch.Generator().manual_seed(1)
    batch = {key: torch.randint(0, dims["vocab"], (b, seq), generator=gen,
                                dtype=torch.int32)
             for key in ("tokens", "targets")}
    return runner, params, batch


def collect_entry_points(
        extra_modules: Sequence[str] = ()) -> List[EntryPoint]:
    """Import the declaring modules and gather every entry point."""
    entries: List[EntryPoint] = []
    for modname in tuple(TRACE_ENTRY_MODULES) + tuple(extra_modules):
        mod = importlib.import_module(modname)
        hook = getattr(mod, "trace_entry_points", None)
        if hook is None:
            continue
        entries.extend(hook())
    names = [e.name for e in entries]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate trace entry points: {dupes}")
    return entries


def meta_args(args: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """Every tensor of ``args`` as a ``meta`` tensor of its shape and
    dtype (no storage; ``make_fx`` makes each a fake tensor of its own),
    anything else as it is."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta")
                    if isinstance(t, torch.Tensor) else t, args)


def trace_entry(entry: EntryPoint) -> TracedEntry:
    """Trace one entry point to an aten graph and run the cost model."""
    fn, args = entry.build()
    metas = meta_args(args)
    leaf_counts = [len(tree_leaves(a)) for a in args]
    donated_leaves: List[int] = []
    offset = 0
    for i, n in enumerate(leaf_counts):
        if i in entry.donatable:
            donated_leaves.extend(range(offset, offset + n))
        offset += n
    traced = TracedEntry(entry=entry, graph=None, cost=GraphCost(),
                         donatable_leaves=len(donated_leaves),
                         unit_bytes=_cohort_unit_bytes(entry, args))
    def call(*a):          # make_fx reads a bound method's signature
        return fn(*a)

    try:
        with kernel_stand_ins():
            graph = make_fx(call, tracing_mode="fake",
                            _allow_non_fake_inputs=True)(*metas)
    except HOST_READ_ERRORS as e:
        traced.host_read = str(e).splitlines()[0] if str(e) else repr(e)
        return traced
    reads = [op_name(n) for n in iter_nodes(graph)
             if op_name(n) in HOST_READ_OPS]
    if reads:
        traced.host_read = f"aten.{reads[0]}: a device value read on the host"
        return traced
    phs = placeholders(graph)
    if len(phs) != offset:
        raise ValueError(f"{entry.name}: {len(phs)} graph inputs for "
                         f"{offset} argument leaves")
    written = written_storages(graph)
    inplace = [i for i in donated_leaves
               if any(storage_key(t) in written
                      for t in tensors_of(phs[i].meta.get("val")))]
    traced.graph = graph
    traced.donated = tuple(inplace)
    traced.cost = cost_of_graph(graph, donated=inplace)
    if entry.donatable:
        traced.inplace_leaves = len(inplace)
    return traced


def _cohort_unit_bytes(entry: EntryPoint, args: Tuple[Any, ...]) -> int:
    """Largest single-client leaf for TRACE003's O(C*P) threshold: an
    aggregation combine materialising ``cohort * max_leaf`` bytes in one
    value has stacked the cohort densely."""
    if entry.cohort < 2:
        return 0
    return max((tensor_bytes(t) for t in tree_leaves(args)), default=0)


@functools.lru_cache(maxsize=1)
def traced_entries() -> Tuple[TracedEntry, ...]:
    """Trace every registered entry once per process (tests, the CLI
    gate and the chip phase share the result)."""
    return tuple(trace_entry(e) for e in collect_entry_points())
