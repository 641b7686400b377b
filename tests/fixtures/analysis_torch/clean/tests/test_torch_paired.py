"""Pin for the clean fixture kernel and its twin."""
from repro_torch.kernels.ops import paired
from repro_torch.kernels.ref import paired_kernel_ref


def test_paired_kernel_matches_ref():
    assert paired(1.0, True) == paired_kernel_ref(1.0)
