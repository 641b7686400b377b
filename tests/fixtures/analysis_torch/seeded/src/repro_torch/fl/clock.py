"""Seeded SCHED002/SCHED003 violations: unordered-container iteration
and timestamp ordering without a tie-break."""


def expire(busy_until, now):
    # SCHED002: items() on a schedule-tracking dict, order = insertion
    return [c for c, due in busy_until.items() if due < now]


def drain(pending):
    ready = {p for p in pending}
    out = []
    for p in ready:                   # SCHED002: set iteration order
        out.append(p)
    return out


def next_event(events):
    events.sort(key=lambda e: e.arrival)    # SCHED003: bare timestamp
    return min(events, key=lambda e: e.t)   # SCHED003: ties possible
