"""The port's engine on the wall clock against the reference's:
``time_mode="wall_clock"`` with barrier and FedBuff rounds, late
reports landing at their simulated arrival, horizons (argument and
config), the time-mode resolution rules and the latency closed loop,
replaying ``tests/test_fl_clock.py``'s engine scenarios (314-560) in
both packages from the same parameters.

Tolerances: ``torch_tiny.assert_histories_match``: every schedule
(participants, dropped, late arrivals, update and report counts,
``sim_time``, ``round_seconds``) and the knobs exact, duals 1e-9, usage
1e-6 relative, losses and wire MB 5e-3; deadlines exact.
"""
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_tiny import (CLOCK_FL, CLOCK_MODEL, assert_histories_match,  # noqa: E402
                        run_pair, run_port, straggler_dynamics, tiny_pair)

import repro.fl as J  # noqa: E402
import repro_torch.fl as T  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(model=CLOCK_MODEL, fl=CLOCK_FL)


def _stream(res):
    return [(r.round, r.participants, r.dropped, r.val_loss, r.duals)
            for r in res.history]


def _hetero(mod, fl):
    return mod.make_fleet(fl, [mod.FleetClass("fast", 0.5),
                               mod.FleetClass("slow", 0.5,
                                              compute_scale=2.0)])


def _wall(agg, deadline=1.1):
    def make(mod, fl):
        profiles, cp = _hetero(mod, fl)
        return dict(profiles=profiles, client_profiles=cp,
                    dynamics=straggler_dynamics(mod, fl, deadline),
                    aggregator=agg(mod))
    return make


class _UpdateCatcher(T.RoundCallback):
    def __init__(self):
        self.reports = []
        self.deltas_held = []

    def on_server_update(self, engine, update):
        self.reports.extend(update.reports)
        self.deltas_held.append(all(r.delta is not None
                                    for r in update.reports))


def _with_catcher(make, catcher):
    def kw(mod, fl):
        out = make(mod, fl)
        if mod is T:
            out["callbacks"] = [catcher]
        return out
    return kw


@pytest.mark.parametrize("method", ["fedavg", "cafl"])
def test_rounds_mode_is_the_default_and_explicit(setup, method):
    (_, jres), (_, tres) = run_pair(setup, strategy=method)
    assert_histories_match(jres, tres)
    eng, explicit = run_port(setup, strategy=method,
                             run=dict(time_mode="rounds"))
    assert eng.time_mode == "rounds"
    assert _stream(explicit) == _stream(tres)
    assert all(r.round_seconds > 0 for r in tres.history)
    assert [r.sim_time for r in tres.history] == \
        sorted(r.sim_time for r in tres.history)


@pytest.mark.parametrize("method", ["fedavg", "cafl"])
def test_wall_clock_stream_equals_rounds_without_stragglers(setup, method):
    """No straggler clock and a sync barrier: wall-clock mode has nothing
    to reorder, so its stream is the rounds-mode one."""
    (_, jres), (eng, tres) = run_pair(setup, strategy=method,
                                      run=dict(time_mode="wall_clock"))
    assert eng.time_mode == "wall_clock"
    assert_histories_match(jres, tres)
    _, rounds = run_port(setup, strategy=method)
    assert _stream(rounds) == _stream(tres)


def test_wall_clock_barrier_rounds_are_deadline_bounded(setup):
    (_, jres), (eng, tres) = run_pair(
        setup, _wall(lambda m: "sync"), strategy="fedavg",
        run=dict(time_mode="wall_clock"))
    assert_histories_match(jres, tres)
    for r in tres.history:
        assert 0.0 < r.round_seconds <= 1.1 + 1e-9
    times = [r.sim_time for r in tres.history]
    assert times == sorted(times) and times[0] > 0.0
    assert eng.clock.now == times[-1]


def test_wall_clock_late_delivery_at_arrival_time(setup):
    """Every report delivered after its training round lands in the round
    whose window holds its simulated arrival, never later than the
    rounds-mode quantization; and its delta is released once applied."""
    catcher = _UpdateCatcher()
    deadline = 1.1
    (_, jres), (_, tres) = run_pair(
        setup, _with_catcher(_wall(lambda m: m.FedBuffAggregator(2)),
                             catcher),
        strategy="fedavg", fl=dict(rounds=5),
        run=dict(time_mode="wall_clock"))
    assert_histories_match(jres, tres)
    starts = {r.round: r.sim_time - r.round_seconds for r in tres.history}
    ends = {r.round: r.sim_time for r in tres.history}
    late = [rep for rep in catcher.reports
            if rep.round_submitted > rep.round_trained
            and rep.arrival_time > 0.0]
    assert late and any(r.late_arrivals for r in tres.history)
    for rep in late:
        t0, rnd = rep.round_trained, rep.round_submitted
        abs_arrival = starts[t0] + rep.arrival_time
        assert starts[rnd] <= abs_arrival + 1e-9
        assert abs_arrival <= ends[rnd] + 1e-9
        assert abs_arrival <= starts[t0] + \
            math.ceil(rep.arrival_time / deadline) * deadline + 1e-9
    assert all(catcher.deltas_held)
    assert all(rep.delta is None for rep in catcher.reports)


def test_wall_clock_fedbuff_rounds_end_at_buffer_events(setup):
    """A buffered-async round ends at its first mid-round update, so
    FedBuff's simulated time runs ahead of the barrier's."""
    runs = {}
    for name, agg in (("sync", lambda m: "sync"),
                      ("fedbuff", lambda m: m.FedBuffAggregator(2))):
        (_, jres), (_, tres) = run_pair(setup, _wall(agg),
                                        strategy="fedavg", fl=dict(rounds=5),
                                        run=dict(time_mode="wall_clock"))
        assert_histories_match(jres, tres)
        runs[name] = tres
    assert runs["fedbuff"].history[-1].sim_time < \
        runs["sync"].history[-1].sim_time
    assert sum(r.updates_applied for r in runs["fedbuff"].history) >= 1


def test_wall_clock_horizon_bounds_the_run(setup):
    horizon = 3.0
    (_, jres), (eng, tres) = run_pair(
        setup, _wall(lambda m: "sync"), strategy="fedavg",
        run=dict(horizon_seconds=horizon))
    assert eng.time_mode == "wall_clock"
    assert_histories_match(jres, tres)
    for r in tres.history:
        assert r.sim_time - r.round_seconds < horizon
    assert tres.history[-1].sim_time >= min(horizon, 1.1)
    assert len(tres.history) != setup["tfl"].rounds or \
        tres.history[-1].sim_time >= horizon


def test_wall_clock_horizon_from_the_config_loses_late_leftovers(setup):
    """``fl.horizon_seconds`` implies wall clock; FedBuff reports still in
    flight when the run ends join the last record's dropped list."""
    (_, jres), (_, tres) = run_pair(
        setup, _wall(lambda m: m.FedBuffAggregator(2), deadline=0.9),
        strategy="fedavg", fl=dict(horizon_seconds=2.5))
    assert_histories_match(jres, tres)


def test_unknown_time_mode_rejected(setup):
    from repro_torch.models import build
    eng = T.FederatedEngine(build(setup["tcfg"]), setup["tfl"],
                            setup["tds"], strategy="fedavg", device="cpu")
    with pytest.raises(ValueError, match="time_mode"):
        eng.run(time_mode="sundial")


def test_explicit_rounds_mode_beats_config_horizon(setup):
    """An explicit ``time_mode="rounds"`` ignores ``fl.horizon_seconds``;
    an explicit horizon with rounds mode raises; an explicit round count
    caps a horizon run."""
    from repro_torch.models import build, params_from_numpy
    _, base = run_port(setup, strategy="fedavg")
    fl_h = setup["tfl"].replace(horizon_seconds=50.0)
    eng = T.FederatedEngine(build(setup["tcfg"]), fl_h, setup["tds"],
                            strategy="fedavg", device="cpu")
    init = params_from_numpy(setup["p"], "cpu")
    res = eng.run(time_mode="rounds", init_params=init)
    assert eng.time_mode == "rounds"
    assert len(res.history) == setup["tfl"].rounds
    assert _stream(res) == _stream(base)
    with pytest.raises(ValueError, match="horizon_seconds"):
        eng.run(time_mode="rounds", horizon_seconds=5.0)
    res = eng.run(rounds=2, horizon_seconds=50.0, init_params=init)
    assert len(res.history) == 2 and eng.time_mode == "wall_clock"


class _ZeroRoundTime(T.KnobRoundTime):
    def round_seconds(self, *a, **kw):
        return 0.0


def test_wall_clock_rejects_non_positive_round_durations(setup):
    from repro_torch.models import build
    eng = T.FederatedEngine(build(setup["tcfg"]), setup["tfl"],
                            setup["tds"], strategy="fedavg", device="cpu",
                            round_time=_ZeroRoundTime.for_config(
                                setup["tfl"]))
    with pytest.raises(ValueError, match="positive"):
        eng.run(time_mode="wall_clock")


def test_wall_clock_misser_never_delivered_in_own_round(setup):
    """A deadline-misser whose arrival falls in the round's server-cost
    tail is still delivered a round late, with staleness >= 1."""
    catcher = _UpdateCatcher()

    def make(mod, fl):
        profiles, cp = mod.make_fleet(fl, [
            mod.FleetClass("fast", 0.5),
            mod.FleetClass("slow", 0.5, compute_scale=1.15)])
        return dict(profiles=profiles, client_profiles=cp,
                    dynamics=straggler_dynamics(mod, fl, 1.1, jitter=0.0),
                    aggregator=mod.FedBuffAggregator(buffer_size=100),
                    round_time=mod.KnobRoundTime.for_config(
                        fl, server_seconds=0.2))

    (_, jres), (_, tres) = run_pair(setup, _with_catcher(make, catcher),
                                    strategy="fedavg",
                                    run=dict(time_mode="wall_clock"))
    assert_histories_match(jres, tres)
    missers = [rep for rep in catcher.reports if rep.arrival_time > 1.1]
    assert missers
    for rep in missers:
        assert rep.round_submitted > rep.round_trained
        assert rep.staleness >= 1


def test_latency_closed_loop_tightens_deadline_in_wall_clock(setup):
    """Latency constraint -> dual -> deadline-aware policy -> deadline ->
    simulated round length, in both packages."""
    dyns = {}

    def make(mod, fl):
        dyns[mod.__name__] = dyn = mod.FleetDynamics(
            sampler=mod.FullParticipation(),
            stragglers=mod.DeadlineStragglers.for_config(fl, deadline=4.0,
                                                         jitter=0.0))
        profiles, cp = _hetero(mod, fl)
        strat = mod.CAFLL(fl, knob_policy=mod.DeadlineAwareKnobPolicy(
            min_report_frac=0.4))
        return dict(strategy=strat, profiles=profiles, client_profiles=cp,
                    dynamics=dyn, aggregator="sync")

    (_, jres), (_, tres) = run_pair(
        setup, make, run=dict(time_mode="wall_clock"),
        fl=dict(rounds=6, constraints="paper+latency",
                dual_overrides={"latency": {"eta": 1.0, "deadzone": 0.0}}))
    assert_histories_match(jres, tres)
    assert any(r.constraints["latency"]["lam"] > 0.0 for r in tres.history)
    deadline = dyns["repro_torch.fl"].stragglers.deadline
    assert deadline == dyns["repro.fl"].stragglers.deadline
    assert deadline < 4.0
    assert min(r.round_seconds for r in tres.history[1:]) < \
        tres.history[0].round_seconds


def test_seconds_to_target_matches_reference(setup):
    (_, jres), (_, tres) = run_pair(
        setup, _wall(lambda m: m.FedBuffAggregator(2)), strategy="fedavg",
        run=dict(time_mode="wall_clock"))
    assert_histories_match(jres, tres)
    losses = sorted(r.val_loss for r in tres.history)
    hits = []
    for target in (losses[0] - 1.0, *losses, 1e9):
        hits.append(T.seconds_to_target(tres, target))
        assert hits[-1] == J.seconds_to_target(tres, target)
    assert hits[0] is None and hits[-1] == 0.0
    assert T.seconds_to_target(T.FLResult("x"), 1.0) is None


def test_logging_marks_the_wall_clock(setup):
    lines = []

    def make(mod, fl):
        kw = _wall(lambda m: m.FedBuffAggregator(2))(mod, fl)
        if mod is T:
            kw["callbacks"] = [T.LoggingCallback(lines.append)]
        return kw

    _, tres = run_port(setup, make, strategy="fedavg",
                       run=dict(time_mode="wall_clock"))
    assert len(lines) == len(tres.history)
    for line, r in zip(lines, tres.history):
        assert line.endswith(f" sim={r.sim_time:.2f}(+{r.round_seconds:.2f})")
