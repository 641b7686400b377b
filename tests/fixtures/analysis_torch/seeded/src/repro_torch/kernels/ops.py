"""Seeded REPRO001 fixture: the dispatch point."""
from repro_torch.kernels import ref
from repro_torch.kernels import wire as wk


def good(x, card):
    return wk.good_kernel(x) if card else ref.good_kernel_ref(x)


def extern(x, card):
    return wk.no_extern(x) if card else ref.no_extern_ref(x)


def counter(x, card):
    return wk.no_counter(x) if card else ref.no_counter_ref(x)


def twin(x, card):
    return wk.no_twin(x)


def dispatch(x, card):
    return ref.no_dispatch_ref(x)         # the kernel is never called


def undispatched(x, card):
    return wk.twin_undispatched(x)        # the twin is never called


def untested(x, card):
    return wk.no_test(x) if card else ref.no_test_ref(x)
