"""Clean REPRO002 pattern: every emitted metric is declared."""
from repro.bench import MetricSpec, benchmark

_PRESETS = {"tiny": {}, "smoke": {}, "full": {}}


@benchmark("fixtures.good", "fixtures",
           metrics=[MetricSpec("time_us", "us", direction="lower"),
                    MetricSpec("speedup", "x", direction="higher")],
           presets=_PRESETS)
def bench_good(params):
    return {"time_us": 1.0, "speedup": 2.0,
            "context": {"note": "context is the non-metric channel"}}
