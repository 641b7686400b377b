"""The mesh and the device rates of the dry-run's roofline, on one H100.

The reference lays its steps over v5e pods (``repro.launch.mesh``:
(data 16, model 16) on one pod, (pod 2, data 16, model 16) on two) and
prices them at the v5e's rates. The port's dry-run records one step on
one card, the ``card`` mesh: one device and no collectives, priced at
the H100's datasheet rates (SXM, dense, at its 700 W limit). The
production meshes, their batch and model axes and the sharding recipe
are not ported (ROADMAP queue 1 item 13c).
"""
from __future__ import annotations

# NVIDIA H100 SXM datasheet rates (per card)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # B


def make_mesh(name: str = "card") -> int:
    """The named mesh's device count: ``"card"`` is one device. The
    reference's ``"single"`` (256 chips) and ``"multi"`` (512) meshes
    are not ported."""
    if name == "card":
        return 1
    if name in ("single", "multi"):
        raise NotImplementedError(
            f"the {name!r} production mesh and its sharding recipe are not "
            "ported (ROADMAP queue 1 item 13c: DTensor over a fake process "
            "group)")
    raise ValueError(f"unknown mesh {name!r}")
