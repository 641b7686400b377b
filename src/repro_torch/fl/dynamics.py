"""Fleet dynamics: who *can* train, who is picked, and who finishes.

    AvailabilityModel  which clients a round can see
    ClientSampler      which available clients the server picks
    StragglerModel     which picked clients report before the deadline

``FleetDynamics`` bundles the three with the ledger that re-credits a
dropped client's lost token budget at its next participation. Every model
draws only from the generator the engine hands it
(``default_rng(fl.seed)``), so a seed gives the reference's participation
sets exactly. The port has the default bundle (always available, uniform
K-of-N, no stragglers); the other samplers, availability models and
straggler models are not ported yet (ROADMAP queue 8).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core.policy import Knobs
from repro_torch.fl.device import ClientInfo


class AvailabilityModel:
    """Gate: the subset of the fleet a round can see."""

    name = "base"

    def available(self, rnd: int, clients: Sequence[ClientInfo],
                  rng: np.random.Generator) -> List[ClientInfo]:
        raise NotImplementedError


class AlwaysAvailable(AvailabilityModel):
    """Every client answers every round; draws nothing."""

    name = "always"

    def available(self, rnd, clients, rng):
        return list(clients)


class ClientSampler:
    """Picks this round's cohort from the available clients; ``duals`` is
    the strategy's per-profile dual snapshot."""

    name = "base"

    def reset(self) -> None:
        pass

    def sample(self, rnd: int, available: Sequence[ClientInfo],
               rng: np.random.Generator,
               duals: Dict[str, Dict[str, float]]) -> List[ClientInfo]:
        raise NotImplementedError


class UniformSampler(ClientSampler):
    """Uniform K-of-N without replacement:
    ``rng.choice(len(available), size=K, replace=False)``, the
    reference's exact call."""

    name = "uniform"

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k

    def sample(self, rnd, available, rng, duals):
        if len(available) < self.k:
            return list(available)
        idx = rng.choice(len(available), size=self.k, replace=False)
        return [available[int(i)] for i in idx]


class StragglerModel:
    """Splits the sampled cohort into (survivor_idx, dropped_idx, times);
    ``deadline`` is None for a model that keeps no clock."""

    name = "base"
    deadline: Optional[float] = None

    def split(self, rnd: int, sampled: Sequence[ClientInfo],
              knobs: Sequence[Knobs], rng: np.random.Generator
              ) -> Tuple[List[int], List[int], List[float]]:
        raise NotImplementedError


class NoStragglers(StragglerModel):
    """Every sampled client finishes; draws nothing."""

    name = "none"

    def split(self, rnd, sampled, knobs, rng):
        return list(range(len(sampled))), [], []


@dataclass(frozen=True)
class RoundPlan:
    """One round's composition, as callbacks and records observe it."""
    round: int
    available: Tuple[int, ...]     # client ids the round could see
    sampled: Tuple[int, ...]       # the cohort the sampler picked
    survivors: Tuple[int, ...]     # reported before the deadline
    dropped: Tuple[int, ...]       # sampled but missed the deadline
    times: Tuple[float, ...] = ()  # straggler draws (aligned to sampled)
    late: Tuple[int, ...] = ()     # misses whose report still arrives


@dataclass
class FleetDynamics:
    """Sampler x availability x straggler bundle + the dropped-client
    token-budget ledger; ``reset`` clears cursors and debts."""

    sampler: ClientSampler
    availability: AvailabilityModel = field(default_factory=AlwaysAvailable)
    stragglers: StragglerModel = field(default_factory=NoStragglers)
    carryover_tokens: bool = True   # re-credit dropped clients' budget
    max_carry_accum: int = 4        # cap on extra grad-accum steps/round
    _debt: Dict[int, int] = field(default_factory=dict, repr=False)

    @classmethod
    def default(cls, fl: FLConfig) -> "FleetDynamics":
        """Always-available fleet, uniform K-of-N, no stragglers."""
        return cls(sampler=UniformSampler(fl.clients_per_round))

    def reset(self) -> None:
        self.sampler.reset()
        self._debt.clear()

    def compose(self, rnd: int, clients: Sequence[ClientInfo],
                rng: np.random.Generator,
                duals: Dict[str, Dict[str, float]]
                ) -> Tuple[List[ClientInfo], List[ClientInfo]]:
        """-> (available, sampled) for this round."""
        avail = self.availability.available(rnd, clients, rng)
        sampled = self.sampler.sample(rnd, avail, rng, duals)
        return avail, sampled

    def adjust_knobs(self, sampled: Sequence[ClientInfo],
                     knobs: Sequence[Knobs]) -> List[Knobs]:
        """Spend carried token debt as extra (capped) grad-accum
        microbatches."""
        if not self.carryover_tokens:
            return list(knobs)
        out = []
        for ci, kn in zip(sampled, knobs):
            debt = self._debt.get(ci.client_id, 0)
            if debt > 0:
                extra = min(self.max_carry_accum,
                            max(1, math.ceil(debt / (kn.s * kn.b))))
                kn = dataclasses.replace(kn, grad_accum=kn.grad_accum + extra)
            out.append(kn)
        return out

    def finish(self, rnd: int, sampled: Sequence[ClientInfo],
               knobs: Sequence[Knobs], rng: np.random.Generator
               ) -> Tuple[List[int], List[int], List[float]]:
        return self.stragglers.split(rnd, sampled, knobs, rng)

    def settle(self, sampled: Sequence[ClientInfo],
               base_knobs: Sequence[Knobs],
               adjusted_knobs: Sequence[Knobs],
               survivor_idx: Sequence[int],
               dropped_idx: Sequence[int]) -> None:
        """Survivors pay down the tokens their carry boost trained;
        dropped clients owe this round's base token budget."""
        if not self.carryover_tokens:
            return
        for i in survivor_idx:
            cid = sampled[i].client_id
            if cid not in self._debt:
                continue
            base, adj = base_knobs[i], adjusted_knobs[i]
            repaid = (adj.grad_accum - base.grad_accum) * adj.s * adj.b
            left = self._debt[cid] - repaid
            if left > 0:
                self._debt[cid] = left
            else:
                del self._debt[cid]
        for i in dropped_idx:
            kn = base_knobs[i]
            cid = sampled[i].client_id
            self._debt[cid] = (self._debt.get(cid, 0)
                               + kn.s * kn.grad_accum * kn.b)

    def debt(self, client_id: int) -> int:
        """Outstanding token (sequence) debt for a client (0 if none)."""
        return self._debt.get(client_id, 0)


#: component names of ``repro.fl.dynamics.make_dynamics`` not ported yet
_NOT_PORTED = {"sampler": ("full", "round_robin", "resource_aware"),
               "availability": ("periodic", "bernoulli"),
               "stragglers": ("deadline",)}


def make_dynamics(fl: FLConfig, sampler: str = "uniform",
                  availability: str = "always", stragglers: str = "none"
                  ) -> FleetDynamics:
    """String-spec constructor for the default bundle's components."""
    names = {"sampler": sampler, "availability": availability,
             "stragglers": stragglers}
    ported = {"sampler": "uniform", "availability": "always",
              "stragglers": "none"}
    for part, name in names.items():
        if name in _NOT_PORTED[part]:
            raise NotImplementedError(
                f"{part} {name!r} is not ported yet (ROADMAP queue 8)")
        if name != ported[part]:
            raise ValueError(f"unknown dynamics component {name!r}")
    return FleetDynamics.default(fl)
