"""Device profiles: per-client budgets + resource models.

A ``DeviceProfile`` carries a device class's budgets and its
resource-model calibration; the engine maps every simulated client onto
one profile so the CAFL-L duals and policy can run per device class. The
paper's homogeneous fleet is ``uniform_fleet``. The reference's
``FleetClass`` / ``make_fleet`` are not ported yet (ROADMAP queue 8).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import Budgets, FLConfig
from repro_torch.core.resources import ResourceModel

DEFAULT_PROFILE = "default"


@dataclass(frozen=True)
class DeviceProfile:
    """One device class in the fleet. ``resources=None`` means the
    engine's calibrated base model scaled by ``compute_scale`` (>1 = more
    energy and heat per token than the calibration device)."""
    name: str
    budgets: Budgets
    resources: Optional[ResourceModel] = None
    compute_scale: float = 1.0

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


def uniform_fleet(fl: FLConfig) -> Tuple[Dict[str, DeviceProfile], List[str]]:
    """The paper's setting: every client is the same device."""
    profiles = {DEFAULT_PROFILE: DeviceProfile(DEFAULT_PROFILE, fl.budgets)}
    return profiles, [DEFAULT_PROFILE] * fl.num_clients
