"""Dispatch point for the clean fixture kernel, by device."""
from repro_torch.kernels import ref
from repro_torch.kernels import wire as wk


def paired(x, card):
    return wk.paired_kernel_bshd(x) if card else ref.paired_kernel_ref(x)
