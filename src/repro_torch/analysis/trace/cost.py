"""Static cost model over aten graphs: peak live bytes, FLOPs, transfers.

The port's counterpart of ``repro.analysis.trace.cost``, in a new design.
The reference walks jaxprs; this walks the aten-level ``torch.fx`` graph
that ``make_fx`` records on fake tensors (``registry.trace_entry``), the
counterpart of a jaxpr: one ``call_function`` node per aten op, with the
fake output in ``node.meta["val"]``. The estimate is pre-allocator: it
prices the unfused program with ideal liveness, the side to gate on.

The names map one to one (``JaxprCost`` -> ``GraphCost``, ``aval_bytes``
-> ``tensor_bytes``, ``eqn_flops`` -> ``node_flops``, ``iter_eqns`` ->
``iter_nodes``, ``cost_of_jaxpr`` -> ``cost_of_graph``), with two
differences:

- ``unwrap_pjit`` has no counterpart: ``make_fx`` adds no call wrapper,
  and its placeholders are the flattened arguments in order.
- There is no control flow to recurse into. The graph has no ``scan``,
  ``while`` or ``cond``: a Python loop unrolls as it runs, and
  ``torch.func.vmap`` lowers to batched aten ops, so every node is at
  depth 0 and FLOPs need no trip counts.

Peak live bytes come from a linear scan over the nodes, counted per
*storage*, not per node. A view (``view``, ``t``, ``transpose``,
``permute``, ``expand``, ``slice``, ``select``, ``unsqueeze``,
``as_strided``, ``_unsafe_view``, ...) allocates nothing and keeps its
base alive; an in-place op (``add_``, ``copy_``, a kernel stand-in
writing ``out``) writes its argument's storage and allocates nothing.
The fake tensors carry that aliasing: two values share a storage
exactly when their ``untyped_storage()`` is the same. A storage lives
from the node that allocates it to its last read through any alias;
the graph's outputs and the inputs that are not donated live to the
end (the caller holds them), a donated input dies at its last read. In
the port a donated buffer is one the step overwrites in place (the
registry passes those), which is how an in-place update turns into a
statically visible memory win.

FLOPs (``node_flops``): a matrix product or convolution 2 m n k, by the
formulas of ``torch.utils.flop_counter``; a reduction its input
elements; a sort or top-k n log2 n; a view or pure data movement 0; a
kernel stand-in by ``kernels.stand_ins.STAND_IN_FLOPS``; anything else
its output elements.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Sequence, Set, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.stand_ins import STAND_IN_FLOPS

#: ops that move or make data without arithmetic (views are caught by
#: ``OpOverload.is_view``): no FLOPs charged, as the reference's movement
#: primitives (reshape, transpose, slice, concatenate, pad, gather,
#: scatter, iota, copy, broadcast)
_MOVEMENT = {
    "clone", "copy", "copy_", "_foreach_copy_", "contiguous", "detach",
    "alias", "lift_fresh_copy", "_unsafe_view", "cat", "stack",
    "constant_pad_nd", "flip", "roll", "repeat", "gather", "scatter",
    "index", "index_put", "index_put_", "index_select", "embedding",
    "slice_scatter", "select_scatter", "as_strided_scatter",
    "slice_backward", "select_backward", "arange", "zeros", "ones", "full",
    "empty", "empty_strided", "new_zeros", "new_ones", "new_full",
    "new_empty", "new_empty_strided", "zeros_like", "ones_like",
    "full_like", "empty_like", "fill", "fill_", "zero_", "split",
    "split_with_sizes", "unbind", "chunk",
}

#: reductions: charged their input elements (the reference's reduce_*,
#: cum*, argmax / argmin)
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "prod",
    "logsumexp", "var", "std", "var_mean", "std_mean", "any", "all",
    "norm", "linalg_vector_norm", "cumsum", "cumprod", "nansum",
}

_SORTS = {"sort", "topk", "argsort", "msort", "kthvalue"}

#: ops that read a device value on the host (``.item()``, ``.tolist()``,
#: ``float()``; ``nonzero``'s output shape): a graph holding one has
#: data-dependent sizes and is not priced (``registry.trace_entry``)
HOST_READ_OPS = {"_local_scalar_dense", "nonzero"}
#: copies: their bytes count as transfers when they cross between the
#: host and a device (``crosses_host``; TRACE004 reads them too)
COPY_OPS = {"_to_copy", "copy_", "copy"}


def tensor_bytes(t: Any) -> int:
    """Bytes of a tensor's elements (0 for anything else)."""
    if not isinstance(t, torch.Tensor):
        return 0
    return int(math.prod(t.shape)) * t.element_size()


def tensor_elems(t: Any) -> int:
    return int(math.prod(t.shape)) if isinstance(t, torch.Tensor) else 0


def tensors_of(val: Any) -> List[torch.Tensor]:
    """The tensors in a node's value (a tensor, or a tuple / list)."""
    return [t for t in tree_leaves(val) if isinstance(t, torch.Tensor)]


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(t: torch.Tensor, granule: int = 1) -> int:
    return -(-int(t.untyped_storage().nbytes()) // granule) * granule


def op_name(node: torch.fx.Node) -> str:
    """``aten.add_.Tensor`` -> ``add_``; a stand-in keeps its own name."""
    packet = getattr(node.target, "overloadpacket", None)
    return packet.__name__ if packet is not None else str(node.target)


def arg_nodes(node: torch.fx.Node) -> List[torch.fx.Node]:
    return [a for a in tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node)]


def _val_tensors(nodes: Sequence[torch.fx.Node]) -> List[torch.Tensor]:
    return [t for n in nodes for t in tensors_of(n.meta.get("val"))]


@dataclass
class GraphCost:
    """What one traced entry point statically costs."""

    peak_bytes: int = 0          # max live set incl. inputs / outputs
    flops: int = 0               # node_flops summed over the graph
    transfer_bytes: int = 0      # bytes crossing the host boundary
    input_bytes: int = 0         # the arguments' tensors
    output_bytes: int = 0        # the results' tensors
    eqns: int = 0                # aten nodes walked
    dot_flops: int = 0           # the matrix products' share of flops

    def to_json(self) -> Dict[str, Any]:
        return {
            "peak_bytes": self.peak_bytes, "flops": self.flops,
            "transfer_bytes": self.transfer_bytes,
            "input_bytes": self.input_bytes,
            "output_bytes": self.output_bytes, "eqns": self.eqns,
        }


# ---------------------------------------------------------------------------
# per-node FLOP model
# ---------------------------------------------------------------------------


def _vals(x: Any) -> Any:
    """fx arguments -> their fake values (for the flop formulas)."""
    if isinstance(x, torch.fx.Node):
        return x.meta.get("val")
    if isinstance(x, (list, tuple)):
        return type(x)(_vals(a) for a in x)
    if isinstance(x, dict):
        return {k: _vals(v) for k, v in x.items()}
    return x


def is_dot(node: torch.fx.Node) -> bool:
    """A matrix product or convolution (a ``flop_counter`` formula)."""
    packet = getattr(node.target, "overloadpacket", None)
    return packet in flop_registry


def node_flops(node: torch.fx.Node) -> int:
    """FLOPs of one aten node."""
    packet = getattr(node.target, "overloadpacket", None)
    if packet is None:
        return 0
    out = node.meta.get("val")
    if packet in STAND_IN_FLOPS:
        return int(STAND_IN_FLOPS[packet](_vals(node.args), out))
    if packet in flop_registry:
        return int(flop_registry[packet](*_vals(node.args),
                                         **_vals(node.kwargs), out_val=out))
    name = op_name(node)
    if node.target.is_view or name in _MOVEMENT:
        return 0
    if name in _REDUCTIONS:
        return sum(tensor_elems(t) for t in _val_tensors(arg_nodes(node)))
    if name in _SORTS:
        n = max((tensor_elems(t) for t in _val_tensors(arg_nodes(node))),
                default=0)
        return n * max(1, int(math.log2(n)) if n > 1 else 1)
    return sum(tensor_elems(t) for t in tensors_of(out))


# ---------------------------------------------------------------------------
# traversal, aliasing, transfers
# ---------------------------------------------------------------------------


def iter_nodes(graph: Any) -> Iterator[torch.fx.Node]:
    """Every aten node of the graph in order (no placeholders, outputs or
    tuple-element reads): the traversal the TRACE rules share."""
    g = getattr(graph, "graph", graph)
    for node in g.nodes:
        if node.op == "call_function" and node.target is not operator.getitem:
            yield node


def placeholders(graph: Any) -> List[torch.fx.Node]:
    g = getattr(graph, "graph", graph)
    return [n for n in g.nodes if n.op == "placeholder"]


def output_nodes(graph: Any) -> List[torch.fx.Node]:
    g = getattr(graph, "graph", graph)
    out = next(n for n in g.nodes if n.op == "output")
    return arg_nodes(out)


def written_args(node: torch.fx.Node) -> List[torch.fx.Node]:
    """The arguments an op writes in place (its schema marks them
    ``Tensor(a!)``): ``add_``'s self, ``copy_``'s destination, an
    ``out=`` tensor, a stand-in's ``out``."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return []
    written: List[torch.fx.Node] = []
    for i, arg in enumerate(schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        value = (node.args[i] if i < len(node.args)
                 else node.kwargs.get(arg.name))
        written += [a for a in tree_leaves(value)
                    if isinstance(a, torch.fx.Node)]
    return written


def written_storages(graph: Any) -> Set[int]:
    """Storages some node of the graph writes in place."""
    keys: Set[int] = set()
    for node in iter_nodes(graph):
        for t in _val_tensors(written_args(node)):
            keys.add(storage_key(t))
    return keys


def _is_host(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def crosses_host(node: torch.fx.Node) -> Tuple[bool, bool]:
    """(host to device, device to host) for a copy node."""
    if op_name(node) not in COPY_OPS:
        return False, False
    ins = _val_tensors(arg_nodes(node))
    outs = tensors_of(node.meta.get("val"))
    if not ins or not outs:
        return False, False
    src = ins[-1] if op_name(node) == "copy_" else ins[0]
    dst = outs[0]
    return (_is_host(src) and not _is_host(dst),
            not _is_host(src) and _is_host(dst))


def is_transfer(node: torch.fx.Node) -> bool:
    return any(crosses_host(node))


def node_io_bytes(node: torch.fx.Node) -> Tuple[int, int]:
    ins = sum(tensor_bytes(t) for t in _val_tensors(arg_nodes(node)))
    outs = sum(tensor_bytes(t) for t in tensors_of(node.meta.get("val")))
    return ins, outs


# ---------------------------------------------------------------------------
# the cost of one graph
# ---------------------------------------------------------------------------


def cost_of_graph(graph: Any, donated: Sequence[int] = (),
                  granule: int = 1) -> GraphCost:
    """Static cost of one traced callable.

    ``donated`` indexes the placeholders (the flattened arguments) whose
    buffers the step consumes: those die at their last read instead of
    living for the whole call. ``granule`` rounds every storage up to a
    multiple of that many bytes for the peak (1: the tensors' own bytes,
    the committed table's unit; 512: the blocks of the CUDA caching
    allocator, to set the estimate beside a peak measured on the card).
    """
    cost = GraphCost()
    phs = placeholders(graph)
    ph_tensors = [t for n in phs for t in tensors_of(n.meta.get("val"))]
    cost.input_bytes = sum(tensor_bytes(t) for t in ph_tensors)
    out_tensors = _val_tensors(output_nodes(graph))
    cost.output_bytes = sum(tensor_bytes(t) for t in out_tensors)

    nodes = list(iter_nodes(graph))
    index = {n: i for i, n in enumerate(nodes)}
    donated = set(donated)
    size: Dict[int, int] = {}
    last: Dict[int, int] = {}
    pinned: Set[int] = set()
    for i, n in enumerate(phs):
        for t in tensors_of(n.meta.get("val")):
            key = storage_key(t)
            size[key] = storage_bytes(t, granule)
            last[key] = -1
            if i not in donated:
                pinned.add(key)
    pinned |= {storage_key(t) for t in out_tensors}

    born: List[List[int]] = []
    for i, node in enumerate(nodes):
        fresh = []
        for t in tensors_of(node.meta.get("val")):
            key = storage_key(t)
            if key not in size:
                size[key] = storage_bytes(t, granule)
                fresh.append(key)
            last[key] = max(last.get(key, i), i)
        born.append(fresh)
        for t in _val_tensors(arg_nodes(node)):
            key = storage_key(t)
            if key in size:              # not a host constant
                last[key] = i
    # a tuple element read (getitem) extends its producer's storages
    g = getattr(graph, "graph", graph)
    for node in g.nodes:
        if node.op == "call_function" and node.target is operator.getitem:
            users = [index[u] for u in node.users if u in index]
            for t in tensors_of(node.meta.get("val")):
                key = storage_key(t)
                if key in size:
                    last[key] = max([last[key]] + users)

    frees: Dict[int, List[int]] = {}
    for key, i in last.items():
        if key not in pinned:
            frees.setdefault(i, []).append(key)

    live = sum(size[storage_key(t)] for t in
               {storage_key(t): t for t in ph_tensors}.values())
    for key in frees.get(-1, ()):            # donated and never read
        live -= size[key]
    peak = live
    for i, node in enumerate(nodes):
        cost.eqns += 1
        f = node_flops(node)
        cost.flops += f
        if is_dot(node):
            cost.dot_flops += f
        if is_transfer(node):
            cost.transfer_bytes += sum(node_io_bytes(node))
        live += sum(size[k] for k in born[i])
        peak = max(peak, live)
        live -= sum(size[k] for k in frees.get(i, ()))
    cost.peak_bytes = peak
    return cost
