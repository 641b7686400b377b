"""Server-side delta combination (Algorithm 1, line 15).

The paper aggregates the *participating* clients' deltas with a plain
mean: w <- w + (1/|S_t|) sum_i dw_i. Passing ``weights`` gives the
|D_i|-weighted FedAvg variant (Eq. 1). ``normalize_weights`` is the one
place weights are renormalized over the clients present.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def normalize_weights(weights: Optional[Sequence[float]], n: int
                      ) -> List[float]:
    """``None`` -> uniform 1/n; else weights rescaled to sum to 1 over the
    clients that are present."""
    if n <= 0:
        raise ValueError("need at least one client to aggregate")
    if weights is None:
        return [1.0 / n] * n
    if len(weights) != n:
        raise ValueError(f"{len(weights)} weights for {n} clients")
    tot = sum(weights)
    if not tot > 0:
        raise ValueError("aggregation weights must have positive mass")
    return [x / tot for x in weights]


@torch.no_grad()
def aggregate(deltas: Sequence[Tensors],
              weights: Optional[List[float]] = None) -> Tensors:
    """Weighted sum of the clients' delta dicts, in fp32, in client
    order; each weight is the fp32 rounding of its float (as the
    reference's pre-staged f32 scalars)."""
    w = normalize_weights(weights, len(deltas))
    out = {}
    for name, first in deltas[0].items():
        w_dev = [torch.tensor(np.float32(x), device=first.device) for x in w]
        acc = first.to(torch.float32) * w_dev[0]
        for wi, d in zip(w_dev[1:], deltas[1:]):
            acc = acc + d[name].to(torch.float32) * wi
        out[name] = acc
    return out


@torch.no_grad()
def apply_delta(params: Tensors, delta: Tensors) -> Tensors:
    return {k: (p.to(torch.float32) + delta[k].to(torch.float32)).to(p.dtype)
            for k, p in params.items()}
