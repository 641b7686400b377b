"""Share of the MoE's capacity slots that real tokens fill: the program's
counters ``moe.pairs_kept`` (kept (token, expert) pairs, padding rows
left out) over ``moe.slots`` (groups x experts x capacity), summed over
the traced window's layers and requests."""
from portbench import spans


def read(rec):
    got = spans.program(rec)
    if got is None or not got["counters"].get("moe.slots"):
        return None
    c = got["counters"]
    return 100.0 * c.get("moe.pairs_kept", 0.0) / c["moe.slots"]
