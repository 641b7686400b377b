"""Seeded REPRO002 violations: undeclared metric + bad direction."""
from repro.bench import MetricSpec, benchmark

_PRESETS = {"tiny": {}, "smoke": {}, "full": {}}


@benchmark("seeded.bad", "fixtures",
           metrics=[MetricSpec("time_us", "us", direction="sideways")],
           presets=_PRESETS)
def bench_bad(params):
    return {"time_us": 1.0,
            "surprise_metric": 2.0}       # REPRO002: no MetricSpec
