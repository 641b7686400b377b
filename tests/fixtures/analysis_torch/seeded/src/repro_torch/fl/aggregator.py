"""Seeded SCHED001/SCHED004 violations: delivery-order report folds
(host and tensor folds) and component-owned RNG streams."""
import numpy as np
import torch

_RNG = np.random.default_rng(0)       # SCHED004: module-level shared rng


class JitterPolicy:
    def __init__(self):
        # SCHED004 twice: rng on component state, and unseeded
        self.rng = np.random.default_rng()
        # SCHED004: a torch generator on component state
        self.gen = torch.Generator(device="cpu")

    def pick(self, reports):
        np.random.shuffle(reports)    # SCHED004: global singleton draw
        return reports[0]


def combine(reports):
    total = 0.0
    for r in reports:                 # SCHED001: += over delivery order
        total += r.value
    # SCHED001: fold over a comprehension iterating the buffer
    mean = np.mean([r.value for r in reports])
    return total, mean


def combine_tensors(reports):
    # SCHED001: torch.sum over the stacked buffer in delivery order
    total = torch.sum(torch.stack([r.delta for r in reports]), dim=0)
    stacked = torch.stack([r.delta for r in reports])
    # SCHED001: the stacked buffer's .mean() folds in delivery order
    return total, stacked.mean(0)
