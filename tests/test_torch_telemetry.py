"""The port's spans and counters (``repro_torch.telemetry``): inert with
the profiler off, on while a ``torch.profiler`` session runs, nested and
stamped on the profiler's clock; placed in the federated engine (both
executors), the prefill step, the MoE and the train step; and the
benchmark's readers of them (``portbench/spans.py``), held to intervals
worked out by hand.

The ``cuda`` case runs on the card only: a ``torch.cuda._sleep`` kernel
waited for inside a span lies within 1 ms of the span's ends in the same
profiler run. This file imports no JAX."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, spans
from repro_torch import telemetry

# the tiny models gain nothing from intra-op threads, and the suite runs
# in several worker processes at once
torch.set_num_threads(1)

MS = 1_000_000                          # ns


@pytest.fixture(autouse=True)
def clean():
    telemetry.reset()
    yield
    telemetry.reset()


def _host_events(prof, names):
    """The profiler's host events named ``names`` -> [(name, start, end)]
    in start order (ns, the profiler's clock)."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name() in names
           and e.device_type() == torch.autograd.DeviceType.CPU]
    return sorted(out, key=lambda t: t[1])


def _best_ns(fn, n=20_000, repeats=5):
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    """With no profiler running, spans and counters record nothing and
    never enter ``record_function``; a span off costs less than one
    ``record_function`` call (printed: both, in ns)."""
    calls = []
    real = telemetry._autograd_profiler.record_function

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(telemetry._autograd_profiler, "record_function",
                        counting)
    assert not telemetry.enabled()
    with telemetry.span("fl.round"):
        with telemetry.span("fl.eval"):
            telemetry.count("moe.slots", 3)
            telemetry.count("moe.pairs_kept", torch.tensor(2))
    assert calls == []
    assert telemetry.collect() == {"spans": [], "counters": {}}

    def off():
        with telemetry.span("x"):
            pass

    monkeypatch.setattr(telemetry._autograd_profiler, "record_function",
                        real)

    def marked():
        with real("x"):
            pass

    off_ns, mark_ns = _best_ns(off), _best_ns(marked, n=2_000)
    print(f"span off: {off_ns:.0f} ns a span; record_function: "
          f"{mark_ns:.0f} ns a call")
    assert off_ns < mark_ns
    assert telemetry.collect()["spans"] == []


def test_nesting_roots_and_the_profilers_clock():
    """Under torch.profiler: parents and roots follow the nesting, and
    each span's stamps lie within 1 ms of the profiler's own event of the
    same name (its ``record_function``). A span goes first: a session's
    first ``record_function`` pays a one-off set-up (~1 ms on an H100
    host) between the span's stamp and the profiler's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert telemetry.enabled()
        with telemetry.span("t.first"):
            pass
        with telemetry.span("t.round"):
            with telemetry.span("t.eval"):
                torch.ones(64).sum()
            with telemetry.span("t.train"):
                with telemetry.span("t.step"):
                    torch.ones(64).sum()
        with telemetry.span("t.request"):
            time.sleep(0.002)
    got = {s["name"]: s for s in telemetry.collect()["spans"]
           if s["name"] != "t.first"}
    assert set(got) == {"t.round", "t.eval", "t.train", "t.step",
                        "t.request"}
    rnd, req = got["t.round"], got["t.request"]
    assert rnd["parent"] is None and rnd["root"] == rnd["id"]
    assert req["parent"] is None and req["root"] == req["id"]
    assert got["t.eval"]["parent"] == rnd["id"]
    assert got["t.train"]["parent"] == rnd["id"]
    assert got["t.step"]["parent"] == got["t.train"]["id"]
    assert {got[n]["root"] for n in ("t.eval", "t.train", "t.step")} == {
        rnd["id"]}
    for s in got.values():
        assert s["start_ns"] <= s["end_ns"] and s["device_s"] is None
    assert rnd["start_ns"] <= got["t.eval"]["start_ns"]
    assert got["t.step"]["end_ns"] <= rnd["end_ns"] <= req["start_ns"]
    events = _host_events(prof, set(got))
    assert sorted(n for n, _, _ in events) == sorted(got)
    for name, start, end in events:
        assert abs(start - got[name]["start_ns"]) < MS, name
        assert abs(end - got[name]["end_ns"]) < MS, name


def test_a_span_left_by_an_exception_is_closed():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with telemetry.span("t.outer"):
                with telemetry.span("t.inner"):
                    raise ValueError("boom")
        with telemetry.span("t.after"):
            pass
    got = {s["name"]: s for s in telemetry.collect()["spans"]}
    assert set(got) == {"t.outer", "t.inner", "t.after"}
    assert got["t.inner"]["parent"] == got["t.outer"]["id"]
    assert got["t.inner"]["end_ns"] <= got["t.outer"]["end_ns"]
    # the stack unwound: the next span is a root
    assert got["t.after"]["parent"] is None


def test_counters_sum_numbers_and_tensors():
    with profile(activities=[ProfilerActivity.CPU]):
        telemetry.count("t.kept", torch.tensor(3))
        telemetry.count("t.kept", torch.tensor(4))
        telemetry.count("t.kept", torch.tensor(5.5))
        telemetry.count("t.slots", 8)
        telemetry.count("t.slots", 2.5)
    first = telemetry.collect()
    assert first["counters"] == {"t.kept": 12.5, "t.slots": 10.5}
    assert telemetry.collect() == first            # resolved once
    telemetry.reset()
    assert telemetry.collect() == {"spans": [], "counters": {}}


# ---------------------------------------------------------------------------
# the program's spans
# ---------------------------------------------------------------------------


def _tree(spans_, root):
    """{name: count} of the spans under ``root`` (any depth), and each
    span's parent's name."""
    by_id = {s["id"]: s for s in spans_}
    under = [s for s in spans_ if s["root"] == root["id"] and s is not root]
    return ({n: sum(s["name"] == n for s in under)
             for n in {s["name"] for s in under}},
            {s["name"]: by_id[s["parent"]]["name"] for s in under})


@pytest.mark.parametrize("executor", ["sequential", "batched"])
def test_engine_rounds_nest_their_spans(executor):
    """Two tiny CPU rounds of ``FederatedEngine``: each round one
    ``fl.round`` holding ``fl.eval`` and ``fl.localtrain``, which holds
    the draws, steps and wire of the round (per knob group, or per local
    step and client)."""
    from repro_torch.configs.charlm_shakespeare import CONFIG, FL
    from repro_torch.data import load_corpus
    from repro_torch.fl import FederatedEngine
    from repro_torch.models import build
    ds = load_corpus(target_bytes=60_000)
    cfg = CONFIG.replace(vocab_size=max(ds.vocab_size, 64), num_layers=2,
                         d_model=32, num_heads=2, num_kv_heads=2,
                         head_dim=16, d_ff=64)
    fl = FL.replace(num_clients=4, clients_per_round=2, s_base=2, b_base=4,
                    seq_len=16, eval_batches=1, eval_batch_size=8, rounds=2)
    engine = FederatedEngine(build(cfg), fl, ds, strategy="cafl",
                             executor=executor, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        result = engine.run()
    got = telemetry.collect()["spans"]
    rounds = [s for s in got if s["name"] == "fl.round"]
    assert len(rounds) == len(result.history) == 2
    assert all(s["parent"] is None for s in rounds)
    for rnd, rec in zip(rounds, result.history):
        counts, parents = _tree(got, rnd)
        assert counts["fl.eval"] == counts["fl.localtrain"] == 1
        assert parents["fl.eval"] == parents["fl.localtrain"] == "fl.round"
        for name in ("fl.draw", "fl.step", "fl.wire"):
            assert parents[name] == "fl.localtrain", name
        clients, steps = fl.clients_per_round, rec.knobs["s"]
        if executor == "batched":          # one knob group a round
            assert counts == {"fl.eval": 1, "fl.localtrain": 1,
                              "fl.draw": 1, "fl.step": 1, "fl.wire": 1}
        else:
            assert counts == {"fl.eval": 1, "fl.localtrain": 1,
                              "fl.draw": clients * steps,
                              "fl.step": clients * steps,
                              "fl.wire": clients}
        inside = [s for s in got if s["root"] == rnd["id"]]
        assert all(rnd["start_ns"] <= s["start_ns"] <= s["end_ns"]
                   <= rnd["end_ns"] for s in inside)


def test_moe_prefill_and_train_step_spans_and_counters():
    """A SMOKE Phi-3.5-MoE prefill: ``serve.prefill`` holding one
    ``model.moe`` a layer, the MoE's kept pairs within its slots; its
    train step in two microbatches: ``train.accumulate`` at the zeros,
    after each microbatch and at the scale, and one ``train.optimizer``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.freezing import mask_tree
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import make_prefill_step, make_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").params()
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(cfg, 2, 40, seed=5).items()}
    prefill = make_prefill_step(model, InputShape("prefill", 40, 2,
                                                  "prefill"))
    with profile(activities=[ProfilerActivity.CPU]):
        prefill(params, {"tokens": batch["tokens"]})
    got = telemetry.collect()
    (root,) = [s for s in got["spans"] if s["parent"] is None]
    assert root["name"] == "serve.prefill"
    counts, parents = _tree(got["spans"], root)
    assert counts == {"model.moe": cfg.num_layers}
    assert parents == {"model.moe": "serve.prefill"}
    c = got["counters"]
    tokens, m = 2 * 40, cfg.moe
    groups = -(-tokens // min(m.group_size, tokens))
    assert 0 < c["moe.pairs_kept"] <= c["moe.slots"]
    assert c["moe.pairs_kept"] <= cfg.num_layers * tokens * m.top_k
    assert c["moe.slots"] % (cfg.num_layers * groups * m.num_experts) == 0
    # the grouped products' rows: one per kept pair
    assert c["moe.rows"] == c["moe.pairs_kept"]

    telemetry.reset()
    opt = adamw(1e-3)
    state = opt.init(params)
    step = make_train_step(model, opt, True, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, state, batch, mask_tree(params, cfg, 1))
    names = [s["name"] for s in telemetry.collect()["spans"]]
    assert names.count("train.accumulate") == 1 + 2 + 1
    assert names.count("train.optimizer") == 1
    assert names.count("model.moe") >= 2 * cfg.num_layers
    assert set(names) == {"train.accumulate", "train.optimizer",
                          "model.moe"}


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

S = 10 ** 9                               # a second in ns


def _span(ident, name, start, end, parent=None, root=None, device_s=None):
    return {"name": name, "id": ident, "parent": parent,
            "root": ident if root is None else root,
            "start_ns": start * S, "end_ns": end * S, "device_s": device_s}


def _rec(ops, window, counters):
    busy = sum(e - s for s, e in spans.merge(
        spans.clip(((s * S, e * S) for s, e in ops), window[0] * S,
                   window[1] * S)))
    return {"spans": {}, "counts": {}, "counters": counters,
            "memory_peak_bytes": 0,
            "trace": {"ops": [("k", s * S, e * S) for s, e in ops],
                      "host": [], "window_ns": (window[0] * S,
                                                window[1] * S),
                      "busy_s": busy * 1e-9,
                      "window_s": (window[1] - window[0]) * 1.0}}


def _read(metric, rec):
    mod = harness.load_module(harness.metric_path(metric),
                              "reader_" + metric.replace(".", "_"))
    return mod.read(rec)


#: two rounds in a window of 100 s (the second's end past it), and the
#: device's operations: idle under each span worked out by hand
FL_SPANS = [
    _span(1, "fl.round", 10, 50), _span(2, "fl.eval", 10, 14, 1, 1),
    _span(3, "fl.localtrain", 15, 45, 1, 1),
    _span(4, "fl.draw", 15, 20, 3, 1), _span(5, "fl.step", 20, 35, 3, 1),
    _span(6, "fl.wire", 36, 44, 3, 1),
    _span(7, "fl.round", 60, 105), _span(8, "fl.eval", 60, 62, 7, 7),
    _span(9, "fl.localtrain", 63, 99, 7, 7),
    _span(10, "fl.draw", 63, 65, 9, 7), _span(11, "fl.step", 65, 90, 9, 7),
    _span(12, "fl.wire", 91, 99, 9, 7)]
FL_OPS = [(0, 12), (16, 18), (21, 30), (37, 40), (46, 48), (55, 61),
          (70, 80), (95, 103)]
#: per round: eval 2 + 1, draw 3 + 2, step 6 + 15, wire 5 + 4, server
#: (round and LocalTrain self time) 6 + 2; 5 s idle outside every span
FL_IDLE = {"eval_idle_s_per_round.fl": 1.5, "draw_idle_s_per_round.fl": 2.5,
           "step_idle_s_per_round.fl": 10.5,
           "wire_idle_s_per_round.fl": 4.5,
           "server_idle_s_per_round.fl": 4.0}


def test_fl_readers_match_the_hand_worked_idle(monkeypatch):
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": FL_SPANS, "counters": {}})
    rec = _rec(FL_OPS, (0, 100), {"rounds": 2})
    for name, want in FL_IDLE.items():
        assert _read(name, rec) == pytest.approx(want, abs=1e-9), name
    # with the idle outside every fl.* span, they add up to the window's
    idle = (1.0 - rec["trace"]["busy_s"] / rec["trace"]["window_s"]) * 100
    outside = spans.length(spans.subtract(spans.subtract(
        [(0, 100 * S)], spans.self_intervals(FL_SPANS, ["fl.round"], True)),
        spans.busy(rec["trace"]))) * 1e-9
    assert outside == pytest.approx(5.0)
    assert 2 * sum(FL_IDLE.values()) + outside == pytest.approx(idle)


def test_prefill_and_train_readers_match_the_hand_worked_numbers(
        monkeypatch):
    prefill = [
        _span(1, "serve.prefill", 10, 40),
        _span(2, "model.moe", 15, 20, 1, 1, device_s=0.004),
        _span(3, "model.moe", 25, 30, 1, 1, device_s=0.006),
        _span(4, "serve.prefill", 50, 90),
        _span(5, "model.moe", 60, 70, 4, 4, device_s=0.010)]
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": prefill, "counters": {"moe.pairs_kept": 30.0,
                                       "moe.slots": 40.0,
                                       "moe.rows": 32.0}})
    rec = _rec([(12, 38), (55, 60), (65, 85)], (0, 100), {"requests": 2})
    assert rec["trace"]["busy_s"] == pytest.approx(51.0)
    # idle under the whole request span (its MoE layers included):
    # 2 + 2 s, then 5 + 5 + 5 s
    assert _read("step_idle_ms_per_request.prefill", rec) == \
        pytest.approx(9500.0)
    assert _read("moe_device_share.prefill", rec) == pytest.approx(
        100 * 0.020 / 51.0)
    assert _read("moe_slot_fill.prefill", rec) == pytest.approx(75.0)
    assert _read("moe_row_fill.prefill", rec) == pytest.approx(93.75)
    # a program whose MoE counts no rows: no row fill, the rest as before
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": prefill, "counters": {"moe.pairs_kept": 30.0,
                                       "moe.slots": 40.0}})
    assert _read("moe_row_fill.prefill", rec) is None
    assert _read("moe_slot_fill.prefill", rec) == pytest.approx(75.0)

    train = [
        _span(1, "train.accumulate", 1, 2, device_s=0.1),
        _span(2, "train.accumulate", 3, 4, device_s=0.2),
        _span(3, "train.accumulate", 5, 6, device_s=0.3),
        _span(4, "train.optimizer", 7, 8, device_s=0.5),
        _span(5, "train.optimizer", 120, 130, device_s=9.0)]   # after it
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": train, "counters": {}})
    rec = _rec([(0, 10)], (0, 100), {"steps": 1})
    assert _read("accumulate_device_share.train", rec) == \
        pytest.approx(6.0)
    assert _read("optimizer_device_share.train", rec) == pytest.approx(5.0)


NEW_METRICS = list(FL_IDLE) + [
    "step_idle_ms_per_request.prefill", "moe_device_share.prefill",
    "moe_slot_fill.prefill", "accumulate_device_share.train",
    "optimizer_device_share.train", "moe_row_fill.prefill"]


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_readers_read_nothing_without_device_operations(metric,
                                                        monkeypatch):
    """None on a CPU run (no device operations), without the program's
    spans (a commit before them), and without a traced window."""
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": FL_SPANS, "counters": {"moe.slots": 1.0,
                                        "moe.rows": 1.0}})
    counters = {"rounds": 2, "requests": 2, "steps": 1}
    assert _read(metric, _rec([], (0, 100), counters)) is None
    assert _read(metric, {"spans": {}, "counters": counters, "counts": {},
                          "trace": None, "memory_peak_bytes": 0}) is None
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": [], "counters": {}})
    assert _read(metric, _rec(FL_OPS, (0, 100), counters)) is None


def test_interval_arithmetic():
    assert spans.merge([(5, 7), (1, 3), (2, 4), (9, 9)]) == [(1, 4), (5, 7)]
    assert spans.subtract([(0, 10), (20, 30)], [(2, 3), (5, 22), (29, 40)]
                          ) == [(0, 2), (3, 5), (22, 29)]
    assert spans.clip([(0, 5), (8, 12), (20, 30)], 4, 10) == [(4, 5),
                                                              (8, 10)]
    rng = np.random.default_rng(1)
    for _ in range(50):
        a = spans.merge((int(s), int(s + d)) for s, d in
                        rng.integers(0, 50, size=(6, 2)))
        b = spans.merge((int(s), int(s + d)) for s, d in
                        rng.integers(0, 50, size=(6, 2)))
        pts_a = {p for s, e in a for p in range(s, e)}
        pts_b = {p for s, e in b for p in range(s, e)}
        left = spans.subtract(a, b)
        assert {p for s, e in left for p in range(s, e)} == pts_a - pts_b
        assert spans.length(left) == len(pts_a - pts_b)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the clock check reads the card's "
                    "own trace)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_kernel_lies_within_its_span_on_the_card(card):
    """A ``torch.cuda._sleep`` kernel launched and waited for inside a
    span: in the same profiler run its device interval lies within 1 ms
    of the span's host stamps at both ends, the span's CUDA events time
    it within 1 ms, and the harness counts the span's mark on the
    device's timeline as no operation. A short span goes first: a
    session's first span pays its host set-up (the first CUDA events
    and the profiler's first launch callback, ~2.5 ms on an H100 host)
    before its kernel starts."""
    torch.cuda._sleep(1000)                         # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with telemetry.span("t.first"):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        with telemetry.span("t.sleep"):
            torch.cuda._sleep(20_000_000)           # ~10 ms
            torch.cuda.synchronize()
    got = {s["name"]: s for s in telemetry.collect()["spans"]}
    sp = got["t.sleep"]
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "sleep" in e.name().lower()
               and e.duration_ns() > 5 * MS]
    assert len(kernels) == 1, kernels
    k0, k1 = kernels[0]
    print(f"span {sp['start_ns']}-{sp['end_ns']} kernel {k0}-{k1}: "
          f"start {(k0 - sp['start_ns']) / 1e3:.1f} us after, end "
          f"{(sp['end_ns'] - k1) / 1e3:.1f} us before; events "
          f"{sp['device_s'] * 1e3:.3f} ms, kernel {(k1 - k0) / 1e6:.3f} ms")
    assert abs(k0 - sp["start_ns"]) < MS and abs(sp["end_ns"] - k1) < MS
    assert abs(sp["device_s"] * 1e9 - (k1 - k0)) < MS
    tr = harness.reduce_trace(prof)
    assert not [n for n, _, _ in tr["ops"] if n.startswith("t.")]


def test_span_sums_split_the_window_idle():
    """``portbench.tools.span_sums``: the hand-made rounds' idle split by
    span name in self time, plus the idle outside every span, adds up to
    the window's idle."""
    from portbench.tools.span_sums import sums
    rec = _rec(FL_OPS, (0, 100), {"rounds": 2})
    out = sums(rec["trace"], {"spans": FL_SPANS, "counters": {}})
    assert out["idle_s"] == pytest.approx(51.0)
    assert out["idle_outside_s"] == pytest.approx(5.0)
    assert out["idle_self_s"]["fl.eval"] == pytest.approx(3.0)
    assert out["idle_self_s"]["fl.step"] == pytest.approx(21.0)
    assert out["idle_self_s"]["fl.round"] + out["idle_self_s"][
        "fl.localtrain"] == pytest.approx(8.0)
    assert out["sum_s"] == pytest.approx(51.0) and abs(out["sum_gap"]) < 1e-9
    assert out["count"] == {"fl.round": 2, "fl.eval": 2, "fl.localtrain": 2,
                            "fl.draw": 2, "fl.step": 2, "fl.wire": 2}


def test_optimizer_roofline_reads_bytes_over_the_optimizers_device_time(
        monkeypatch):
    """``optimizer_roofline.train``: the counter ``optim.bytes`` over
    3.35 TB/s against the ``train.optimizer`` spans' CUDA-event seconds
    in the window; None without the counter (a program before it),
    without device operations, or without the spans."""
    train = [
        _span(1, "train.accumulate", 1, 2, device_s=0.1),
        _span(2, "train.optimizer", 3, 4, device_s=0.02),
        _span(3, "train.optimizer", 5, 6, device_s=0.03),
        _span(4, "train.optimizer", 120, 130, device_s=9.0)]   # after it
    nbytes = 0.5 * 3.35e12 * 0.05           # half the bound's time
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": train, "counters": {"optim.bytes": nbytes}})
    rec = _rec([(0, 10)], (0, 100), {"steps": 2})
    assert _read("optimizer_roofline.train", rec) == pytest.approx(50.0)
    assert _read("optimizer_roofline.train", _rec([], (0, 100), {})) is None
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": train, "counters": {}})
    assert _read("optimizer_roofline.train", rec) is None
    assert _read("optimizer_device_share.train", rec) == pytest.approx(0.5)
    monkeypatch.setattr(telemetry, "collect", lambda: {
        "spans": train[:1], "counters": {"optim.bytes": nbytes}})
    assert _read("optimizer_roofline.train", rec) is None
