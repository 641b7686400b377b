"""Clean SCHED patterns: sorted iteration, total-order event keys."""


def expire(busy_until, now):
    return sorted(c for c, due in busy_until.items() if due < now)


def drain(pending):
    ready = {p for p in pending}
    return list(sorted(ready))


def next_event(events):
    events.sort(key=lambda e: e.sort_key())
    return min(events, key=lambda e: (e.arrival, e.tie, e.seq))
