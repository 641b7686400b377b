"""Share of the rows the MoE's grouped products run over that hold a
real token's kept pair: the program's counters ``moe.pairs_kept`` (kept
(token, expert) pairs of real tokens) over ``moe.rows`` (the rows the
products ran over), summed over the traced window's layers and
requests; None where the program counts no rows."""
from portbench import spans


def read(rec):
    got = spans.program(rec)
    if got is None or not got["counters"].get("moe.rows"):
        return None
    c = got["counters"]
    return 100.0 * c.get("moe.pairs_kept", 0.0) / c["moe.rows"]
