"""Asynchronous delivery in the port against the reference: the
staleness policies, the FedBuff and staleness-weighted aggregators, the
wall-clock ``EventQueue`` / ``TimedReport``, and the engine with late
reports in rounds mode (``tests/test_fl_aggregator.py``'s late-delivery
scenarios; the wall-clock engine is ``tests/test_torch_wallclock.py``).

Tolerances:
- exact: staleness discounts, the event order, every schedule of the
  engine (participants, dropped, late arrivals, update and report
  counts, ``sim_time``, ``round_seconds``) and the aggregators' combined
  deltas on the same inputs (the same fp32 operations in the same
  order);
- the engine runs: ``torch_tiny.assert_histories_match`` (duals 1e-9,
  usage 1e-6 relative, losses 5e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import (CLOCK_FL, CLOCK_MODEL, assert_histories_match,  # noqa: E402
                        run_pair, straggler_dynamics, tiny_pair)

import repro.fl as J  # noqa: E402
import repro_torch.fl as T  # noqa: E402
from repro.configs import get_fl_config as j_fl  # noqa: E402
from repro.core.policy import Knobs as JKnobs  # noqa: E402
from repro_torch.configs import get_fl_config as t_fl  # noqa: E402
from repro_torch.core.policy import Knobs as TKnobs  # noqa: E402

PKGS = {"jax": (J, j_fl, JKnobs, lambda a: jnp.asarray(a)),
        "torch": (T, t_fl, TKnobs, lambda a: torch.from_numpy(a.copy()))}


# ---------------------------------------------------------------------------
# staleness policies and the aggregators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["polynomial", "poly", "constant", "none"])
def test_staleness_policy_discounts(spec):
    got = [[mod.make_staleness_policy(spec).discount(tau)
            for tau in range(12)] for mod, *_ in PKGS.values()]
    assert got[0] == got[1]
    assert got[1][0] == 1.0
    assert all(a >= b for a, b in zip(got[1], got[1][1:]))


@pytest.mark.parametrize("policy", [
    ("PolynomialStaleness", (0.0,)), ("PolynomialStaleness", (0.5,)),
    ("PolynomialStaleness", (2.0,)), ("ConstantStaleness", (0.25,)),
    ("ConstantStaleness", (1.0,))])
def test_staleness_policy_classes(policy):
    name, args = policy
    got = [[getattr(mod, name)(*args).discount(tau) for tau in range(20)]
           for mod, *_ in PKGS.values()]
    assert got[0] == got[1]


def test_staleness_policy_rejects_bad_arguments():
    with pytest.raises(ValueError):
        T.PolynomialStaleness(-1.0)
    with pytest.raises(ValueError):
        T.ConstantStaleness(0.0)
    with pytest.raises(ValueError):
        T.PolynomialStaleness().discount(-1)
    with pytest.raises(ValueError):
        T.make_staleness_policy("linear")


def _reports(pkg, specs, seed=0):
    """ClientReports of ``pkg`` from (cid, weight, staleness, round)
    specs, with random fp32 deltas of two leaves (same values in both
    packages)."""
    mod, get_fl, knobs_cls, asarray = PKGS[pkg]
    fl = get_fl()
    kn = knobs_cls(k=2, s=4, b=8, q=0)
    rng = np.random.default_rng(seed)
    out = []
    for cid, weight, stale, rnd in specs:
        delta = {"a": asarray(rng.standard_normal((5, 7)).astype(np.float32)),
                 "b": asarray(rng.standard_normal(300).astype(np.float32))}
        rep = mod.ClientReport(
            client=mod.ClientInfo(cid, mod.DeviceProfile("default",
                                                         fl.budgets), 100),
            delta=delta, weight=float(weight), knobs=kn, policy_knobs=kn,
            round_trained=rnd - stale, arrival_time=0.1 * cid)
        rep.round_submitted = rnd
        rep.staleness = stale
        out.append(rep)
    return out


def _updates(pkg, make_agg, specs, weighted, flush_at):
    """Submit the reports in order, flushing after the indices in
    ``flush_at`` and finalizing at the end -> every emitted update as
    (round, reports' ids, staleness, mean staleness, NumPy delta)."""
    mod, get_fl = PKGS[pkg][:2]
    agg = make_agg(mod)
    agg.reset(mod.FedAvg(get_fl(), weighted=weighted).aggregate)
    ups = []
    for i, rep in enumerate(_reports(pkg, specs)):
        ups.append(agg.submit(rep))
        if i in flush_at:
            ups.append(agg.flush(rep.round_submitted))
    ups.append(agg.finalize(specs[-1][3]))
    return [(u.round, [r.client.client_id for r in u.reports],
             [r.staleness for r in u.reports], u.mean_staleness,
             {k: np.asarray(v) for k, v in u.delta.items()})
            for u in ups if u is not None], agg.state_snapshot()


SPECS = [(0, 1.0, 0, 1), (1, 3.0, 0, 1), (2, 2.0, 2, 3), (3, 1.0, 0, 3),
         (4, 5.0, 1, 4), (5, 1.0, 3, 5), (6, 2.0, 0, 5)]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("make_agg", [
    lambda m: m.FedBuffAggregator(buffer_size=2),
    lambda m: m.FedBuffAggregator(buffer_size=3,
                                  policy=m.ConstantStaleness(0.3)),
    lambda m: m.make_aggregator("fedbuff"),
    lambda m: m.StalenessWeightedAggregator(),
    lambda m: m.StalenessWeightedAggregator(policy=m.ConstantStaleness(0.5),
                                            mode="weight"),
    lambda m: m.make_aggregator("staleness"),
    lambda m: m.SyncAggregator(),
], ids=["fedbuff2", "fedbuff3_constant", "fedbuff_default", "staleness",
        "staleness_weight", "staleness_default", "sync"])
def test_aggregator_updates_match_reference(make_agg, weighted):
    """The same report stream through each policy of both packages:
    the same updates, in the same rounds, with the same staleness and
    the same combined delta bits."""
    flush_at = {1, 3, 6}
    (jups, jsnap), (tups, tsnap) = (
        _updates(pkg, make_agg, SPECS, weighted, flush_at)
        for pkg in ("jax", "torch"))
    assert tsnap == jsnap
    assert len(tups) == len(jups) > 0
    for j, t in zip(jups, tups):
        assert t[:4] == j[:4]
        for k in j[4]:
            np.testing.assert_array_equal(t[4][k], j[4][k])


def test_fedbuff_unit_scenarios():
    """``tests/test_fl_aggregator.py``'s FedBuff cases on the port: every
    K-th arrival fires, the buffer survives the barrier, staleness
    discounts the delta and keeps accruing in the buffer."""
    fl = t_fl()
    kn = TKnobs(k=2, s=4, b=8, q=0)

    def rep(cid, value, staleness=0, rnd=1):
        r = T.ClientReport(
            client=T.ClientInfo(cid, T.DeviceProfile("default", fl.budgets),
                                100),
            delta={"w": torch.full((3,), float(value))}, weight=1.0,
            knobs=kn, policy_knobs=kn, round_trained=rnd - staleness)
        r.round_submitted, r.staleness = rnd, staleness
        return r

    agg = T.FedBuffAggregator(buffer_size=2,
                              policy=T.PolynomialStaleness(0.0))
    agg.reset(T.FedAvg(fl).aggregate)
    assert agg.submit(rep(0, 2.0)) is None
    assert torch.all(agg.submit(rep(1, 4.0)).delta["w"] == 3.0)
    assert agg.submit(rep(2, 8.0)) is None and agg.flush(1) is None
    assert torch.all(agg.submit(rep(3, 2.0, rnd=2)).delta["w"] == 5.0)
    assert agg.state_snapshot()["updates_applied"] == 2

    agg = T.FedBuffAggregator(buffer_size=2,
                              policy=T.PolynomialStaleness(0.5))
    agg.reset(T.FedAvg(fl).aggregate)
    agg.submit(rep(0, 4.0, staleness=0, rnd=1))
    upd = agg.submit(rep(1, 4.0, staleness=0, rnd=3))
    want = np.float32((4.0 * (1 + 2) ** -0.5 + 4.0) / 2)
    assert upd.delta["w"].numpy() == pytest.approx(want, rel=1e-6)
    assert upd.mean_staleness == 1.0


def test_make_aggregator_resolution():
    fl = t_fl().replace(clients_per_round=7)
    assert isinstance(T.make_aggregator("sync", fl), T.SyncAggregator)
    assert T.make_aggregator("fedbuff", fl).buffer_size == 4
    assert T.make_aggregator("fedbuff", fl, buffer_size=9).buffer_size == 9
    assert isinstance(T.make_aggregator("staleness_weighted"),
                      T.StalenessWeightedAggregator)
    inst = T.FedBuffAggregator(3)
    assert T.make_aggregator(inst) is inst
    assert (T.FedBuffAggregator.accepts_late,
            T.FedBuffAggregator.applies_mid_round) == (True, True)
    assert T.StalenessWeightedAggregator.applies_mid_round is False
    with pytest.raises(ValueError):
        T.make_aggregator("gossip")
    with pytest.raises(ValueError):
        T.StalenessWeightedAggregator(mode="add")
    with pytest.raises(ValueError):
        T.FedBuffAggregator(buffer_size=0)


def test_scale_delta_on_the_device():
    """The discount is a 0-d fp32 tensor on the delta's device: the
    reference's weak-typed scalar, bit for bit."""
    from repro.fl.aggregator import _scale_delta as j_scale
    from repro_torch.fl.aggregator import _scale_delta as t_scale
    x = np.random.default_rng(1).standard_normal(999).astype(np.float32)
    for f in (1.0, 0.5, (1 + 3) ** -0.5, 1 / 3):
        want = np.asarray(j_scale({"w": jnp.asarray(x)}, f)["w"])
        got = t_scale({"w": torch.from_numpy(x)}, f)["w"]
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    same = {"w": torch.from_numpy(x)}
    assert t_scale(same, 1.0) is same


# ---------------------------------------------------------------------------
# the event queue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_event_queue_matches_reference(seed):
    """Random pushes, stamps, pops and a drain: the same events in the
    same order, each delivered exactly once."""
    def script(mod):
        rng = np.random.default_rng(seed)
        q = mod.EventQueue()
        log = []
        for step in range(30):
            op = rng.integers(0, 4)
            t = float(np.round(rng.uniform(0, 10), 1))
            if op == 0:
                q.push(t, f"r{step}")
            elif op == 1:
                q.push_event(q.stamp(t, f"s{step}"))
            elif op == 2:
                log.append([(e.arrival, e.report, e.seq, e.sort_key())
                            for e in q.pop_until(t)])
            log.append(len(q))
        log.append([(e.arrival, e.report, e.seq) for e in q.drain()])
        log.append(len(q))
        return log

    jl, tl = script(J), script(T)
    assert tl == jl
    delivered = [e for entry in tl if isinstance(entry, list)
                 for e in entry]
    assert len({e[1] for e in delivered}) == len(delivered)


def test_event_queue_rejects_illegal_arrivals():
    q = T.EventQueue()
    for bad in (float("nan"), float("inf"), -float("inf")):
        with pytest.raises(ValueError, match="finite"):
            q.stamp(bad, "x")
    with pytest.raises(ValueError, match=">= 0"):
        q.push(-0.5, "x")
    assert len(q) == 0
    ev = T.TimedReport(1.0, "r", seq=3, tie=0.5)
    assert ev.sort_key() == (1.0, 0.5, 3)


# ---------------------------------------------------------------------------
# the engine: late reports in rounds mode
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(model=CLOCK_MODEL, fl=CLOCK_FL)


def test_rounds_mode_fedbuff_delivers_late_reports(setup):
    """Rounds mode: deadline-missers land ``ceil(t/deadline) - 1`` rounds
    later as participants with positive staleness; a miss is lost only
    when it would land past the last round; a client in flight is off
    the roster; every executed report is applied."""
    updates, plans = [], []

    class Catcher(T.RoundCallback):
        def on_server_update(self, engine, update):
            updates.append(update)

        def on_round_composed(self, engine, plan):
            plans.append(plan)

    dyns = {}

    def make(mod, fl):
        dyns[mod.__name__] = dyn = straggler_dynamics(mod, fl, 0.95, 0.5)
        kw = dict(dynamics=dyn, aggregator=mod.FedBuffAggregator(2))
        if mod is T:
            kw["callbacks"] = [Catcher()]
        return kw

    (_, jres), (_, res) = run_pair(setup, make, fl=dict(rounds=5))
    assert_histories_match(jres, res)
    dyn = dyns["repro_torch.fl"]
    assert any(r.late_arrivals for r in res.history)
    for r in res.history:
        assert set(r.late_arrivals) <= set(r.participants)
        if r.late_arrivals:
            assert r.mean_staleness > 0.0
    for plan in plans:
        for pos, cid in enumerate(plan.sampled):
            if cid in plan.dropped and cid not in plan.late:
                delay = dyn.stragglers.late_rounds(plan.times[pos])
                assert delay is None or plan.round + delay > 5
    assert sum(r.updates_applied for r in res.history) == len(updates) > 0
    assert all(len(u.reports) == 2 for u in updates[:-1])
    busy = {}
    for plan in plans:
        for cid in plan.sampled:
            assert busy.get(cid, 0) < plan.round
        for cid in plan.late:
            pos = plan.sampled.index(cid)
            busy[cid] = plan.round + dyn.stragglers.late_rounds(
                plan.times[pos])
    assert sum(r.reports_applied for r in res.history) == \
        sum(len(r.participants) for r in res.history)
    lost = {c for r in res.history for c in r.dropped}
    assert all(dyn.debt(cid) == 0 for cid in range(6) if cid not in lost)


def test_engine_staleness_aggregator(setup):
    (_, jres), (_, tres) = run_pair(
        setup, lambda mod, fl: dict(dynamics=straggler_dynamics(mod, fl, 0.95,
                                                            0.5),
                                    aggregator="staleness"),
        fl=dict(rounds=4))
    assert_histories_match(jres, tres)
    assert all(r.updates_applied <= 1 for r in tres.history)
    assert any(r.late_arrivals for r in tres.history)
