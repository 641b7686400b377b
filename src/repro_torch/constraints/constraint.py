"""First-class constraints: what is budgeted, how it is measured.

A ``Constraint`` names one dual variable, measures a client report's
usage of it, reads its bound from a profile's ``Budgets`` and says which
Eq. 5-7 dual group (``knob_group``) its multiplier joins. Registered by
name: the paper's four Appendix-A.1 proxies (energy, comm, memory,
temp) and three more, as in the reference: ``wire_mb`` (the measured
wire bytes, held to the comm budget, in the comm group),
``energy_true`` (energy with the grad-accum microbatches Eq. 8 adds, in
the energy group) and ``latency`` (the client's simulated arrival time
against one deadline unit; observational, no group).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import Budgets

# the Eq. 5-7 dual groups (== the paper's four constraints)
KNOB_GROUPS = ("energy", "comm", "memory", "temp")


@dataclass(frozen=True)
class Constraint:
    """One budgeted resource: measurement + bound + knob coupling."""

    name: str
    measure: Callable[[Any], float]          # ClientReport -> usage
    budget_of: Callable[[Budgets], float]    # profile budgets -> b_j
    knob_group: Optional[str] = None         # Eq. 5-7 group or None

    def __post_init__(self) -> None:
        if self.knob_group is not None and self.knob_group not in KNOB_GROUPS:
            raise ValueError(
                f"constraint {self.name!r}: unknown knob_group "
                f"{self.knob_group!r}; options: {', '.join(KNOB_GROUPS)}, None")


@dataclass(frozen=True)
class ConstraintReport:
    """One constraint's accounting for one dual update (per profile).
    ``violated`` is the hard budget test u > b."""

    name: str
    profile: str
    usage: float
    budget: float
    ratio: float
    lam_prev: float
    lam: float
    violated: bool

    def as_dict(self) -> Dict[str, float]:
        return {"usage": self.usage, "budget": self.budget,
                "ratio": self.ratio, "lam": self.lam,
                "violated": self.violated}


class ConstraintSet:
    """An ordered collection of constraints, shared by the strategy, the
    engine and the knob policy. Order is the dual-state key order."""

    def __init__(self, constraints: Sequence[Constraint]):
        names = [c.name for c in constraints]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate constraint names: {names}")
        self.constraints: Tuple[Constraint, ...] = tuple(constraints)

    def __iter__(self) -> Iterator[Constraint]:
        return iter(self.constraints)

    def __len__(self) -> int:
        return len(self.constraints)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(c.name for c in self.constraints)

    def measure(self, report: Any) -> Dict[str, float]:
        """Per-client measurement dict, keyed by constraint name."""
        return {c.name: float(c.measure(report)) for c in self.constraints}

    def budgets_dict(self, budgets: Budgets) -> Dict[str, float]:
        return {c.name: float(c.budget_of(budgets)) for c in self.constraints}

    def ratios(self, usage: Dict[str, float],
               budgets: Budgets) -> Dict[str, float]:
        return {c.name: usage[c.name] / c.budget_of(budgets)
                for c in self.constraints}

    def zero_usage(self) -> Dict[str, float]:
        return {c.name: 0.0 for c in self.constraints}

    def init_lam(self) -> Dict[str, float]:
        return {c.name: 0.0 for c in self.constraints}

    def grouped_lam(self, lam: Dict[str, float]) -> Dict[str, float]:
        """Fold per-constraint duals into the four Eq. 5-7 groups (the
        identity for the paper's set)."""
        out = {g: 0.0 for g in KNOB_GROUPS}
        for c in self.constraints:
            if c.knob_group is not None:
                out[c.knob_group] += lam.get(c.name, 0.0)
        return out


def _proxy(name: str, budget_of: Callable[[Budgets], float]) -> Constraint:
    """One of the paper's Appendix-A.1 proxy constraints, read from the
    usage dict the engine stamps on every report."""
    return Constraint(name=name, budget_of=budget_of,
                      measure=lambda rep, _n=name: rep.usage[_n],
                      knob_group=name)


def paper_constraints() -> ConstraintSet:
    """The paper's (E, C, M, T) tuple: the default stack."""
    return ConstraintSet([
        _proxy("energy", lambda b: b.energy),
        _proxy("comm", lambda b: b.comm_mb),
        _proxy("memory", lambda b: b.memory),
        _proxy("temp", lambda b: b.temp),
    ])


# registered constraints, instantiable by name; each factory returns a
# fresh Constraint
CONSTRAINT_REGISTRY: Dict[str, Callable[[], Constraint]] = {}


def register_constraint(name: str,
                        factory: Callable[[], Constraint]) -> None:
    """Make ``name`` resolvable by ``make_constraints`` specs (last
    registration wins)."""
    CONSTRAINT_REGISTRY[name] = factory


register_constraint("energy", lambda: _proxy("energy", lambda b: b.energy))
register_constraint("comm", lambda: _proxy("comm", lambda b: b.comm_mb))
register_constraint("memory", lambda: _proxy("memory", lambda b: b.memory))
register_constraint("temp", lambda: _proxy("temp", lambda b: b.temp))
register_constraint("wire_mb", lambda: Constraint(
    name="wire_mb", measure=lambda rep: rep.wire_mb_actual,
    budget_of=lambda b: b.comm_mb, knob_group="comm"))
register_constraint("energy_true", lambda: Constraint(
    name="energy_true", measure=lambda rep: rep.energy_true,
    budget_of=lambda b: b.energy, knob_group="energy"))
register_constraint("latency", lambda: Constraint(
    name="latency", measure=lambda rep: rep.arrival_time,
    budget_of=lambda b: 1.0, knob_group=None))


ConstraintSpec = Union[str, Constraint, ConstraintSet,
                       Sequence[Union[str, Constraint]], None]


def make_constraints(spec: ConstraintSpec = "paper") -> ConstraintSet:
    """Resolve a constraint-stack spec: ``"paper"``, ``"paper+name"``,
    a sequence of names / ``Constraint`` instances, or a ``ConstraintSet``
    (passed through)."""
    if spec is None:
        return paper_constraints()
    if isinstance(spec, ConstraintSet):
        return spec
    if isinstance(spec, Constraint):
        return ConstraintSet([spec])
    if isinstance(spec, str):
        spec = spec.split("+")
    out: list = []
    for item in spec:
        if isinstance(item, Constraint):
            out.append(item)
        elif item == "paper":
            out.extend(paper_constraints())
        elif item in CONSTRAINT_REGISTRY:
            out.append(CONSTRAINT_REGISTRY[item]())
        else:
            raise ValueError(
                f"unknown constraint {item!r}; options: paper, "
                f"{', '.join(sorted(CONSTRAINT_REGISTRY))}, or a "
                f"Constraint instance")
    return ConstraintSet(out)
