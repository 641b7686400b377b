"""Device profiles: per-client budgets + resource models.

A ``DeviceProfile`` carries a device class's budgets and its
resource-model calibration; the engine maps every simulated client onto
one profile so the CAFL-L duals and policy can run per device class. The
paper's homogeneous fleet is ``uniform_fleet``; ``make_fleet`` splits the
clients into tiers (``FleetClass``) of scaled budgets, efficiency and
reachability.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import Budgets, FLConfig
from repro_torch.core.resources import ResourceModel

DEFAULT_PROFILE = "default"


@dataclass(frozen=True)
class DeviceProfile:
    """One device class in the fleet. ``resources=None`` means the
    engine's calibrated base model scaled by ``compute_scale`` (>1 = more
    energy and heat per token than the calibration device).
    ``availability`` is the share of rounds a device of the class answers
    (read by the churn model)."""
    name: str
    budgets: Budgets
    resources: Optional[ResourceModel] = None
    compute_scale: float = 1.0
    availability: float = 1.0

    def with_resources(self, base: ResourceModel) -> "DeviceProfile":
        if self.resources is not None:
            return self
        return dataclasses.replace(
            self, resources=base.scaled(energy=self.compute_scale,
                                        temp=self.compute_scale))


@dataclass(frozen=True)
class ClientInfo:
    """A sampled client as the strategy sees it."""
    client_id: int
    profile: DeviceProfile
    shard_size: int = 0


@dataclass(frozen=True)
class FleetClass:
    """Spec for one tier of a heterogeneous fleet."""
    name: str
    fraction: float               # share of clients in this tier
    budget_scale: float = 1.0     # tier budgets = base budgets * scale
    compute_scale: float = 1.0    # tier efficiency (see DeviceProfile)
    availability: float = 1.0     # tier reachability (see DeviceProfile)


def uniform_fleet(fl: FLConfig) -> Tuple[Dict[str, DeviceProfile], List[str]]:
    """The paper's setting: every client is the same device."""
    profiles = {DEFAULT_PROFILE: DeviceProfile(DEFAULT_PROFILE, fl.budgets)}
    return profiles, [DEFAULT_PROFILE] * fl.num_clients


def make_fleet(fl: FLConfig, classes: Sequence[FleetClass]
               ) -> Tuple[Dict[str, DeviceProfile], List[str]]:
    """Partition ``fl.num_clients`` into device classes by fraction
    (contiguous blocks, the remainder to the last class)."""
    if not classes:
        raise ValueError("need at least one FleetClass")
    profiles = {
        c.name: DeviceProfile(c.name, fl.budgets.scaled(c.budget_scale),
                              compute_scale=c.compute_scale,
                              availability=c.availability)
        for c in classes}
    assignment: List[str] = []
    for c in classes[:-1]:
        assignment += [c.name] * int(round(c.fraction * fl.num_clients))
    assignment = assignment[:fl.num_clients]
    assignment += [classes[-1].name] * (fl.num_clients - len(assignment))
    return profiles, assignment
