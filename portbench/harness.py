"""The benchmark's harness: one cell of ``BENCHMARK.json``, run once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Everything a cell needs is found by name, so that a later change adds a
cell or a metric by adding files alone:

    BENCHMARK.json                  the cells and the metrics
    portbench/configs/<config>.json the configuration as it is run
    portbench/traffic/<mix>.json    the traffic: ``driver`` names the
                                    program path, the rest are its
                                    parameters (and ``limits``, the
                                    bounds of the correctness check)
    portbench/drivers/<driver>.py   ``Driver(ctx)``: ``setup()``,
                                    ``window()``, ``release()``,
                                    ``check()``
    portbench/metrics/<metric>.py   ``read(rec)`` -> a number, or None
                                    where there is nothing to read

A run sets up the cell (what it pays counts as ``setup_s``, from the
start of the process), measures its window, reads the peak device
memory, frees the program's state and decides ``correct`` against the
plain reference under ``portbench/reference``. With ``--trace 1`` the
window runs under ``torch.profiler`` and the line carries the cell's
per-layer metrics instead of its end-to-end ones. The last line of
standard output is the result; the numbers compared for ``correct`` are
also the last lines of standard error.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

#: the start of the process, as near as Python lets us: set-up runs from here
T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
#: top-level module names the measured process may not hold once its
#: window has closed (the JAX reference package and JAX itself)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: build and kernel caches, at fixed paths inside the checkout
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": "build/portbench_cache/torch_extensions",
    "TRITON_CACHE_DIR": "build/portbench_cache/triton",
    "TORCHINDUCTOR_CACHE_DIR": "build/portbench_cache/inductor",
    "CUDA_CACHE_PATH": "build/portbench_cache/cuda",
}


class NoCard(RuntimeError):
    """The cell asks for more CUDA devices than the machine has."""


# ---------------------------------------------------------------------------
# the specification, found by name
# ---------------------------------------------------------------------------


def load_spec(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    driver_path: str
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: str = BENCH_DIR


def resolve(spec: Dict[str, Any], workload: str,
            bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``spec`` with its configuration, traffic,
    driver and the metrics it reports, each found by name under
    ``bench_dir``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    cfg_file = os.path.join(os.path.dirname(bench_dir), cfg_entry["file"])
    config = _read_json(cfg_file)
    traffic = _read_json(os.path.join(bench_dir, "traffic",
                                      w["traffic"] + ".json"))
    driver_path = os.path.join(bench_dir, "drivers",
                               traffic["driver"] + ".py")
    if not os.path.exists(driver_path):
        raise FileNotFoundError(driver_path)

    def reports(metric) -> bool:
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m)
                 and m["moves"] in e2e_names]
    for m in per_layer:
        path = metric_path(m["name"], bench_dir)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
    return Cell(workload, w, config, traffic, driver_path, e2e, per_layer,
                bench_dir)


def metric_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    """A metric's reader: ``metrics/<name>.py``, the name's dots as
    underscores (``step_mfu.fl`` -> ``metrics/step_mfu_fl.py``)."""
    return os.path.join(bench_dir, "metrics", name.replace(".", "_") + ".py")


# ---------------------------------------------------------------------------
# what a driver gets: the cell's parameters, spans and counters
# ---------------------------------------------------------------------------


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                       # torch.device
    #: set by tests: a fault planted in the timed path (see drivers)
    fault: Optional[str] = None
    spans: Dict[str, List[tuple]] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, float] = field(default_factory=dict)
    t_start: float = T_START
    setup_s: Optional[float] = None
    window_start: Optional[float] = None
    window_end: Optional[float] = None
    _prof: Any = None
    _mark: Any = None

    @property
    def config(self) -> Dict[str, Any]:
        return self.cell.config

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the benchmark's own around a call into the program.
        Traced runs synchronise at its ends (so that it covers the
        device work it started) and mark it in the profiler's trace."""
        if not self.trace:
            t0 = time.perf_counter()
            yield
            self.spans.setdefault(name, []).append(
                (t0, time.perf_counter()))
            return
        from torch.profiler import record_function
        self.sync()
        t0 = time.perf_counter()
        with record_function("portbench." + name):
            yield
            self.sync()
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def open_window(self) -> None:
        """Set-up ends, the measured window begins (after a device
        synchronise); a traced run starts the profiler here and marks
        the window in its trace."""
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._mark = record_function("portbench.window")
            self._mark.__enter__()
        self.window_start = time.perf_counter()

    def close_window(self) -> None:
        """The window closes (after a device synchronise)."""
        if self.window_end is not None:
            return
        self.sync()
        self.window_end = time.perf_counter()
        if self._prof is not None:
            self._mark.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)

    def window_over(self, now: Optional[float] = None) -> bool:
        now = time.perf_counter() if now is None else now
        return now - self.window_start >= self.seconds


# ---------------------------------------------------------------------------
# the trace: device time from torch.profiler
# ---------------------------------------------------------------------------


def _ev_times(e):
    try:
        start = e.start_ns()
        return start, start + e.duration_ns()
    except AttributeError:             # older releases: microseconds
        start = e.start_us() * 1000
        return start, start + e.duration_us() * 1000


def union_seconds(intervals: List[tuple]) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(prof) -> Dict[str, Any]:
    """The profiler's events -> device operations (name, start, end in
    ns), the benchmark's own spans on the host, the traced window and
    the union of device-busy intervals within it."""
    from torch.autograd import DeviceType
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = _ev_times(e)
        if e.device_type() == DeviceType.CUDA:
            # a span's mark on the device's timeline is no operation
            if not (e.name().startswith("portbench.")
                    or getattr(e, "is_user_annotation", lambda: False)()):
                ops.append((e.name(), s, t))
        elif e.name().startswith("portbench."):
            host.append((e.name()[len("portbench."):], s, t))
    win = [h for h in host if h[0] == "window"]
    if win:
        w0, w1 = win[0][1], win[0][2]
    elif ops:
        w0, w1 = min(o[1] for o in ops), max(o[2] for o in ops)
    else:
        w0 = w1 = 0
    clipped = [(max(s, w0), min(t, w1)) for _, s, t in ops
               if t > w0 and s < w1]
    busy = union_seconds(clipped)
    return {"ops": ops, "host": [h for h in host if h[0] != "window"],
            "window_ns": (w0, w1), "busy_s": busy * 1e-9,
            "window_s": (w1 - w0) * 1e-9}


#: characters of a kernel's name kept in the breakdown (templated
#: kernels' names run to thousands)
NAME_CHARS = 160


def breakdown(tr: Dict[str, Any], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time (names cut to
    ``NAME_CHARS``), and the longest idle gaps on the device by the
    innermost span of the benchmark's that held the host meanwhile
    ("host" where none did)."""
    by_name: Dict[str, int] = {}
    for name, s, t in tr["ops"]:
        by_name[name] = by_name.get(name, 0) + (t - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = tr["window_ns"]
    busy = sorted((max(s, w0), min(t, w1)) for _, s, t in tr["ops"]
                  if t > w0 and s < w1)
    gaps, cur = [], w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    by_span: Dict[str, int] = {}
    host = sorted(tr["host"], key=lambda h: h[2] - h[1])
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        owner = next((h[0] for h in host if h[1] <= mid <= h[2]), "host")
        by_span[owner] = by_span.get(owner, 0) + (g1 - g0)
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], v * 1e-9]
                           for n, v in device_ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in idle]}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def _environment() -> None:
    for key, rel in CACHE_DIRS.items():
        path = os.path.join(ROOT, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[key] = path
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA devices, the cell "
                     f"asks for {chips}")
    torch.cuda.init()
    torch.cuda.set_device(0)
    torch.empty(0, device="cuda:0")
    return torch.device("cuda", 0)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device=None, fault: Optional[str] = None,
             t_start: float = T_START) -> Dict[str, Any]:
    """The driver sets up, measures its window (opening and closing it
    on the context) and checks: -> the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``,
    ``read``, ``checks``). ``device`` None means the card the cell asks for."""
    import torch
    if device is None:
        device = card(cell.workload["chips"])
    device = torch.device(device)
    driver_mod = load_module(cell.driver_path,
                             "portbench_driver_" + cell.traffic["driver"])
    ctx = Context(cell, seed, seconds, trace, device, fault,
                  t_start=t_start)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    drv = driver_mod.Driver(ctx)
    out = drv.run()
    ctx.close_window()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec: Dict[str, Any] = {"e2e": dict(out.get("e2e", {})),
                           "spans": ctx.spans, "counters": ctx.counters,
                           "counts": ctx.counts,
                           "memory_peak_bytes": peak, "trace": None}
    result_device = {"platform": "gpu" if device.type == "cuda" else
                     device.type,
                     "kind": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                     "count": cell.workload["chips"],
                     "memory_peak_bytes": peak}
    bd = None
    if trace:
        tr = reduce_trace(ctx._prof)
        ctx._prof = None
        rec["trace"] = tr
        result_device["busy_s"] = tr["busy_s"]
        result_device["window_s"] = tr["window_s"]
        bd = breakdown(tr)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = drv.check()
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(metric_path(m["name"], cell.bench_dir),
                                 "portbench_metric_" + m["name"].replace(
                                     ".", "_"))
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        rec["e2e"]["setup_s"] = ctx.setup_s
        for m in cell.end_to_end:
            if m["name"] in rec["e2e"]:
                metrics[m["name"]] = {"value": float(rec["e2e"][m["name"]]),
                                      "unit": m["unit"]}
    correct = (failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(failed), "metrics": metrics,
              "device": result_device}
    if bd is not None:
        result["breakdown"] = bd
    # numbers the check reads but does not compare (no limit), then the
    # compared ones, last
    result["read"] = dict(getattr(drv, "read_only", {}))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    cell = resolve(load_spec(), args.workload)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except NoCard as exc:
        print(f"portbench: no card: {exc}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 6
    for name, v in result["read"].items():
        print(f"read {name} = {v!r} (no limit)", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
