"""Fleet dynamics: who *can* train, who is picked, and who finishes.

    AvailabilityModel  which clients a round can see: always, periodic
                       charge windows, Bernoulli churn
    ClientSampler      which available clients the server picks: full,
                       uniform K-of-N, round-robin, resource-aware
    StragglerModel     which picked clients report before the deadline:
                       none, or per-client wall-clock draws against one

``FleetDynamics`` bundles the three with the ledger that re-credits a
dropped client's lost token budget at its next participation. Every model
draws only from the generator the engine hands it
(``default_rng(fl.seed)``), with the reference's calls in the
reference's order, so a seed gives the reference's participation sets,
straggler times and late deliveries exactly.
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


class PeriodicAvailability(AvailabilityModel):
    """Charge / idle windows: client ``i`` is reachable in ``on_rounds``
    of every ``period`` rounds, phase-staggered by its id;
    ``per_profile`` gives a profile its own ``(period, on_rounds)``.
    Draws nothing."""

    name = "periodic"

    def __init__(self, period: int = 4, on_rounds: int = 2,
                 per_profile: Optional[Dict[str, Tuple[int, int]]] = None):
        if not (period >= 1 and 1 <= on_rounds <= period):
            raise ValueError(f"need period >= 1 and 1 <= on_rounds <= "
                             f"period, got {period}, {on_rounds}")
        self.period = period
        self.on_rounds = on_rounds
        self.per_profile = per_profile or {}

    def _window(self, ci: ClientInfo) -> Tuple[int, int]:
        return self.per_profile.get(ci.profile.name,
                                    (self.period, self.on_rounds))

    def is_available(self, rnd: int, ci: ClientInfo) -> bool:
        period, on = self._window(ci)
        return (rnd + ci.client_id) % period < on

    def available(self, rnd, clients, rng):
        return [ci for ci in clients if self.is_available(rnd, ci)]


class BernoulliChurn(AvailabilityModel):
    """Independent churn: client ``i`` answers with probability ``p *
    profile.availability`` (``per_profile`` overrides it per class); one
    uniform draw per client per round."""

    name = "bernoulli"

    def __init__(self, p: float = 1.0,
                 per_profile: Optional[Dict[str, float]] = None):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.p = p
        self.per_profile = per_profile or {}

    def prob(self, ci: ClientInfo) -> float:
        if ci.profile.name in self.per_profile:
            return self.per_profile[ci.profile.name]
        return self.p * ci.profile.availability

    def available(self, rnd, clients, rng):
        draws = rng.random(len(clients))
        return [ci for ci, u in zip(clients, draws) if u < self.prob(ci)]


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


class FullParticipation(ClientSampler):
    """Every available client trains."""

    name = "full"

    def sample(self, rnd, available, rng, duals):
        return list(available)


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


class RoundRobinSampler(ClientSampler):
    """A cyclic cursor over client ids: each round takes the next ``k``
    available clients in id order. Draws nothing."""

    name = "round_robin"

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = k
        self._cursor = 0

    def reset(self) -> None:
        self._cursor = 0

    def sample(self, rnd, available, rng, duals):
        if not available:
            return []
        ordered = sorted(available, key=lambda ci: ci.client_id)
        start = 0
        for i, ci in enumerate(ordered):
            if ci.client_id >= self._cursor:
                start = i
                break
        picked = [ordered[(start + j) % len(ordered)]
                  for j in range(min(self.k, len(ordered)))]
        self._cursor = (picked[-1].client_id + 1) if picked else 0
        return picked


class ResourceAwareSampler(ClientSampler):
    """Prefers device classes with dual headroom: a client's score is the
    sum of its profile's duals, and the ``k`` lowest scores are picked,
    ties broken by one random permutation. ``explore`` keeps a share of
    the cohort uniform, so a pressed tier keeps reporting (its duals only
    move when it does)."""

    name = "resource_aware"

    def __init__(self, k: int, explore: float = 0.25):
        if not (k >= 1 and 0.0 <= explore <= 1.0):
            raise ValueError(f"need k >= 1 and explore in [0, 1], got "
                             f"{k}, {explore}")
        self.k = k
        self.explore = explore

    @staticmethod
    def pressure(ci: ClientInfo,
                 duals: Dict[str, Dict[str, float]]) -> float:
        lam = duals.get(ci.profile.name)
        return float(sum(lam.values())) if lam else 0.0

    def sample(self, rnd, available, rng, duals):
        if len(available) <= self.k:
            return list(available)
        n_explore = math.ceil(self.k * self.explore) if self.explore else 0
        perm = [int(i) for i in rng.permutation(len(available))]
        picked = perm[:n_explore]                    # uniform explore slots
        rest = perm[n_explore:]
        # stable sort over a random permutation = random tie-breaks
        order = sorted(rest,
                       key=lambda i: self.pressure(available[i], duals))
        picked += order[:self.k - n_explore]
        return [available[i] for i in picked]


class StragglerModel:
    """Splits the sampled cohort into (survivor_idx, dropped_idx, times);
    ``deadline`` is None for a model that keeps no clock."""

    name = "base"
    deadline: Optional[float] = None

    def split(self, rnd: int, sampled: Sequence[ClientInfo],
              knobs: Sequence[Knobs], rng: np.random.Generator
              ) -> Tuple[List[int], List[int], List[float]]:
        raise NotImplementedError

    def late_rounds(self, time: float) -> Optional[int]:
        """Rounds after its training round that a deadline-missing report
        reaches the server, or None (lost): the base model keeps no
        clock."""
        return None


class NoStragglers(StragglerModel):
    """Every sampled client finishes; draws nothing."""

    name = "none"

    def split(self, rnd, sampled, knobs, rng):
        return list(range(len(sampled))), [], []


class DeadlineStragglers(StragglerModel):
    """Per-client wall-clock draw against a fixed round deadline:
    ``compute_scale * (s * grad_accum * b) / work_unit`` times a
    log-normal jitter (one ``rng.normal`` vector per round), so time 1.0
    is one baseline round (``work_unit = s_base * b_base`` sequences) on
    the calibration device. Clients past the deadline trained but did not
    report in time."""

    name = "deadline"

    def __init__(self, deadline: float, jitter: float = 0.25,
                 work_unit: float = 1.0):
        if not (deadline >= 0.0 and jitter >= 0.0 and work_unit > 0):
            raise ValueError(f"need deadline >= 0, jitter >= 0, work_unit "
                             f"> 0, got {deadline}, {jitter}, {work_unit}")
        self.deadline = deadline
        self.jitter = jitter
        self.work_unit = work_unit

    @classmethod
    def for_config(cls, fl: FLConfig, deadline: float = 1.5,
                   jitter: float = 0.25) -> "DeadlineStragglers":
        """Deadline in baseline-knob rounds on the calibration device."""
        return cls(deadline, jitter, work_unit=float(fl.s_base * fl.b_base))

    def draw_times(self, sampled, knobs, rng) -> List[float]:
        noise = (np.exp(rng.normal(0.0, self.jitter, size=len(sampled)))
                 if self.jitter > 0 else np.ones(len(sampled)))
        return [float(ci.profile.compute_scale
                      * (kn.s * kn.grad_accum * kn.b) / self.work_unit * z)
                for ci, kn, z in zip(sampled, knobs, noise)]

    def split(self, rnd, sampled, knobs, rng):
        times = self.draw_times(sampled, knobs, rng)
        survivors = [i for i, t in enumerate(times) if t <= self.deadline]
        dropped = [i for i, t in enumerate(times) if t > self.deadline]
        return survivors, dropped, times

    def late_rounds(self, time):
        """A round lasts one deadline, so a client finishing at ``time``
        delivers ``ceil(time / deadline) - 1`` rounds after its own (None
        below 1, or when the deadline is 0)."""
        if self.deadline <= 0.0:
            return None
        late = math.ceil(time / self.deadline) - 1
        return late if late >= 1 else None


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


def make_dynamics(fl: FLConfig, sampler: str = "uniform",
                  availability: str = "always", stragglers: str = "none",
                  deadline: float = 1.5, jitter: float = 0.25,
                  churn_p: float = 0.8, period: int = 4, on_rounds: int = 2
                  ) -> FleetDynamics:
    """String-spec constructor: sampler "full" | "uniform" |
    "round_robin" | "resource_aware", availability "always" |
    "periodic" | "bernoulli", stragglers "none" | "deadline"."""
    samplers = {
        "full": lambda: FullParticipation(),
        "uniform": lambda: UniformSampler(fl.clients_per_round),
        "round_robin": lambda: RoundRobinSampler(fl.clients_per_round),
        "resource_aware": lambda: ResourceAwareSampler(fl.clients_per_round),
    }
    avails = {
        "always": lambda: AlwaysAvailable(),
        "periodic": lambda: PeriodicAvailability(period, on_rounds),
        "bernoulli": lambda: BernoulliChurn(churn_p),
    }
    stragglerss = {
        "none": lambda: NoStragglers(),
        "deadline": lambda: DeadlineStragglers.for_config(fl, deadline,
                                                          jitter),
    }
    try:
        return FleetDynamics(sampler=samplers[sampler](),
                             availability=avails[availability](),
                             stragglers=stragglerss[stragglers]())
    except KeyError as e:
        raise ValueError(f"unknown dynamics component {e.args[0]!r}") from None
