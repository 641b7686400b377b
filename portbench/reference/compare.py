"""The numbers that decide ``correct``, each the same for the program, the
control and the planted faults.

``norm_gap``: for each leaf (each layer's slice of a stacked leaf) the
gap between the program's norm and the reference's, over the
reference's norm of that leaf (at least ``FLOOR`` of the median
leaf's); the worst leaf. ``median_gap`` holds the same gap against the
larger of the leaf's norm and the median leaf's.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out: they move by round-off alone (a frozen layer, a
key bias under softmax).
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch

UNIT = "stack.units."
#: the least a leaf's norm counts for in ``norm_gap``, as a share of the
#: median leaf's
FLOOR = 1e-3


def leaf_norms(tree: Dict[str, torch.Tensor], model: Dict) -> Dict[str, float]:
    """fp32 (fp64 for the sum) L2 norm of every leaf, stacked leaves by
    layer (``name#i``)."""
    out = {}
    for name, t in tree.items():
        t = t.detach()
        if name.startswith(UNIT) and t.shape[0] == model["num_layers"]:
            for i in range(t.shape[0]):
                out[f"{name}#{i}"] = float(
                    torch.linalg.vector_norm(t[i].double()))
        else:
            out[name] = float(torch.linalg.vector_norm(t.double()))
    return out


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def counted(ref_grad: Dict[str, float]):
    """Leaves whose reference gradient norm is at least a thousandth of
    the median leaf's (the median of the leaves it moves at all: a
    frozen leaf's gradient is masked to exactly 0)."""
    moved = [v for v in ref_grad.values() if v > 0]
    med = statistics.median(moved)
    return [k for k, v in ref_grad.items() if v > 0 and v >= 1e-3 * med]


def norm_gap(prog: Dict[str, float], ref: Dict[str, float],
             ref_grad: Dict[str, float]) -> float:
    keys = counted(ref_grad)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], FLOOR * med)
               for k in keys)


def median_gap(prog: Dict[str, float], ref: Dict[str, float],
               ref_grad: Dict[str, float]) -> float:
    keys = counted(ref_grad)
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med)
               for k in keys)
