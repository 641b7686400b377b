"""Synchronising CUDA calls a round, by the program's
``analysis.runtime.SyncGuardCallback`` summed over its call sites,
averaged over the traced window's rounds (none without a card)."""


def read(rec):
    n = rec["counters"].get("rounds", 0)
    if "host_syncs" not in rec["counters"] or not n:
        return None
    return rec["counters"]["host_syncs"] / n
