"""Share of the traced window in which no operation ran on the device:
one minus the union of the profiler's device intervals over the
window."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
