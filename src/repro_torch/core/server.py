"""CAFL-L / FedAvg server entry point (Algorithm 1).

The federated loop lives in ``repro_torch.fl`` (``FederatedEngine``);
``run_federated`` is the reference's thin wrapper over it. This module
keeps the result dataclasses and ``make_eval_fn``, so ``repro_torch.core``
and ``repro_torch.fl`` have no import cycle (the wrapper imports the
engine lazily).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.duals import DualState
from repro_torch.core.resources import ResourceModel
from repro_torch.data.shakespeare import CharDataset, sample_batch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.convert import as_params
from repro_torch.models.zoo import Model


@dataclass
class RoundRecord:
    round: int
    val_loss: float
    knobs: Dict
    usage: Dict[str, float]
    ratios: Dict[str, float]
    duals: Dict[str, float]
    train_loss: float
    wire_mb_actual: float
    energy_true: float
    seconds: float
    sim_time: float = 0.0
    round_seconds: float = 0.0
    per_profile: Dict[str, Dict] = field(default_factory=dict)
    participants: List[int] = field(default_factory=list)
    dropped: List[int] = field(default_factory=list)
    num_available: int = -1
    updates_applied: int = 0
    reports_applied: int = 0
    mean_staleness: float = 0.0
    late_arrivals: List[int] = field(default_factory=list)
    constraints: Dict[str, Dict] = field(default_factory=dict)


@dataclass
class FLResult:
    method: str
    history: List[RoundRecord] = field(default_factory=list)
    final_params: Optional[dict] = None

    def tail_mean(self, getter, n: int = 10) -> float:
        vals = [getter(r) for r in self.history[-n:]]
        return float(np.mean(vals))

    def summary(self, tail: int = 10) -> Dict[str, float]:
        return {
            "energy": self.tail_mean(lambda r: r.usage["energy"], tail),
            "comm_mb": self.tail_mean(lambda r: r.usage["comm"], tail),
            "memory": self.tail_mean(lambda r: r.usage["memory"], tail),
            "temp": self.tail_mean(lambda r: r.usage["temp"], tail),
            "val_loss": self.tail_mean(lambda r: r.val_loss, tail),
            "wire_mb_actual": self.tail_mean(lambda r: r.wire_mb_actual, tail),
            "energy_true": self.tail_mean(lambda r: r.energy_true, tail),
        }


def make_eval_fn(model: Model, dataset: CharDataset, fl: FLConfig,
                 device: DeviceLike = None):
    """Mean train loss over ``fl.eval_batches`` fixed validation batches
    (drawn once from ``default_rng(fl.seed + 777)``), on ``device``
    (``None`` -> ``"cuda"``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(fl.seed + 777)
    batches = [sample_batch(dataset.val, rng, fl.eval_batch_size, fl.seq_len)
               for _ in range(fl.eval_batches)]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in batches]

    @torch.no_grad()
    def evaluate(params) -> float:
        p = as_params(params)
        losses = [float(model.train_loss(p, b)[0]) for b in batches]
        return float(np.mean(losses))

    return evaluate


def run_federated(model: Model, fl: FLConfig, dataset: CharDataset,
                  method: Optional[str] = None, rounds: Optional[int] = None,
                  resources: Optional[ResourceModel] = None,
                  init_params=None, init_duals: Optional[DualState] = None,
                  log=print, device: DeviceLike = None) -> FLResult:
    """The reference's entry point: a ``FederatedEngine`` with the default
    homogeneous fleet and a logging callback, on ``device`` (``None`` ->
    ``"cuda"``)."""
    from repro_torch.fl.callbacks import LoggingCallback
    from repro_torch.fl.engine import FederatedEngine

    engine = FederatedEngine(
        model, fl, dataset,
        strategy=method or fl.method,
        callbacks=[LoggingCallback(log)] if log else [],
        resources=resources,
        init_duals=init_duals,
        device=device)
    return engine.run(rounds=rounds, init_params=init_params)
