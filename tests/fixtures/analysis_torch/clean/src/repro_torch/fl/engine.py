"""Clean TORCH004 pattern: per-client work stays in stacked tensors."""
import torch


def aggregate_round(deltas_stacked, weights):
    return torch.tensordot(weights, deltas_stacked, dims=1)


def label_rows(rows):
    out = []
    for row in rows:                      # not per-client state: fine
        out.append(str(row))
    return out
