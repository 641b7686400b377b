"""Seeded REPRO001 violations: each kernel but the first loses one piece
of its contract (entry point, counter, twin, dispatch, twin dispatch,
test)."""
LAUNCHES = {"good_kernel": 0, "no_extern": 0, "no_twin": 0,
            "no_dispatch": 0, "twin_undispatched": 0, "no_test": 0}

_SIGNATURES = {
    "good_kernel_launch": [],
    "no_extern_launch": [],               # REPRO001: no extern "C" def
    "no_counter_launch": [],              # REPRO001: no LAUNCHES key
    "no_twin_launch": [],                 # REPRO001: no ref.py twin
    "no_dispatch_launch": [],             # REPRO001: ops never calls it
    "twin_undispatched_launch": [],       # REPRO001: ops skips its twin
    "no_test_launch": [],                 # REPRO001: no test pins it
}


def launch_on(index, name, *args):
    return 0
