"""The program's own spans and counters (``repro_torch.telemetry``, on
while the traced window's profiler runs), read against the window's
device operations.

A span's host interval and the profiler's events share one clock (the
unix clock in ns), so a span's interval can be laid over the union of
the device operations (``rec["trace"]["ops"]``) within the traced window
(``rec["trace"]["window_ns"]``):

- the device idle under a span is the part of its self intervals (the
  span minus its child spans; with ``inclusive``, the whole span) inside
  the window where no device operation ran;
- a span's device share is the seconds between its two CUDA events,
  summed over the window's spans, over the window's busy seconds.

Every function returns None where there is nothing to read: no traced
window with device operations (a CPU run), or a program without the
spans (a commit before them).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same points."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """``a`` minus ``b``, both merged -> merged."""
    out: List[Interval] = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def length(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def program(rec) -> Optional[Dict]:
    """The program's spans and counters of a traced run with device
    operations (``telemetry.collect()``), or None."""
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:                 # a program without the spans
        return None
    got = telemetry.collect()
    return got if got["spans"] else None


def self_intervals(spans: List[Dict], names: Iterable[str],
                   inclusive: bool = False) -> List[Interval]:
    """The merged intervals of the spans named ``names``, less their
    child spans' intervals unless ``inclusive``."""
    names = set(names)
    children: Dict[int, List[Interval]] = {}
    for sp in spans:
        if sp["parent"] is not None:
            children.setdefault(sp["parent"], []).append(
                (sp["start_ns"], sp["end_ns"]))
    out: List[Interval] = []
    for sp in spans:
        if sp["name"] in names:
            own = [(sp["start_ns"], sp["end_ns"])]
            if not inclusive:
                own = subtract(own, merge(children.get(sp["id"], ())))
            out += own
    return merge(out)


def clip(intervals: Iterable[Interval], w0: int, w1: int
         ) -> List[Interval]:
    """The parts of ``intervals`` inside [w0, w1]."""
    return [(max(s, w0), min(e, w1)) for s, e in intervals
            if e > w0 and s < w1]


def busy(tr) -> List[Interval]:
    """The union of the device operations' intervals in the window."""
    return merge(clip(((s, e) for _, s, e in tr["ops"]), *tr["window_ns"]))


def idle_seconds(tr, spans: List[Dict], names: Iterable[str],
                 inclusive: bool = False) -> float:
    """Seconds of the window under the spans ``names`` (their self
    intervals, or whole with ``inclusive``) with no device operation."""
    under = clip(self_intervals(spans, names, inclusive), *tr["window_ns"])
    return length(subtract(under, busy(tr))) * 1e-9


def idle_per(rec, names: Iterable[str], per: str, scale: float = 1.0,
             inclusive: bool = False) -> Optional[float]:
    """``idle_seconds`` over the window's counter ``per`` (its rounds or
    requests), times ``scale``, or None."""
    got = program(rec)
    n = rec["counters"].get(per, 0)
    if got is None or not n:
        return None
    return scale * idle_seconds(rec["trace"], got["spans"], names,
                                inclusive) / n


def device_share(rec, name: str) -> Optional[float]:
    """The spans named ``name`` in the window: their CUDA-event seconds
    over the window's busy seconds, in %, or None."""
    got = program(rec)
    tr = rec.get("trace")
    if got is None or tr["busy_s"] <= 0:
        return None
    w0, w1 = tr["window_ns"]
    secs = [sp["device_s"] for sp in got["spans"] if sp["name"] == name
            and sp["device_s"] is not None
            and sp["end_ns"] > w0 and sp["start_ns"] < w1]
    if not secs:
        return None
    return 100.0 * sum(secs) / tr["busy_s"]
