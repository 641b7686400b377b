"""Clean SCHED patterns: canonical-order folds, engine-threaded rng."""
import numpy as np
import torch


def combine(reports):
    stats = sorted(reports, key=lambda r: (r.round, r.client_id))
    total = 0.0
    for r in stats:                   # canonical order: schedule-free
        total += r.value
    return total, float(np.mean([r.value for r in stats]))


def combine_tensors(reports):
    reports = sorted(reports, key=lambda r: (r.round, r.client_id))
    return torch.stack([r.delta for r in reports]).mean(0)


def jitter(rng, n):
    return rng.normal(size=n)         # rng threaded by the engine: fine


def init(seed):
    return torch.Generator().manual_seed(seed)   # seeded where made
