"""Pins for the seeded fixture kernels (one kernel has none)."""
from repro_torch.kernels import ops


def test_pins():
    for kernel in ("good_kernel", "no_extern", "no_counter", "no_twin",
                   "no_dispatch", "twin_undispatched"):
        assert kernel
    assert ops.good(1.0, False) == 1.0
