"""Seeded REPRO001 fixture: plain twins (no_twin has none)."""


def good_kernel_ref(x):
    return x


def no_extern_ref(x):
    return x


def no_counter_ref(x):
    return x


def no_dispatch_ref(x):
    return x


def twin_undispatched_ref(x):
    return x


def no_test_ref(x):
    return x
