"""Fleet dynamics of the port against the reference: the samplers
(full, uniform, round-robin, resource-aware), the availability models
(always, periodic, Bernoulli churn), deadline stragglers, the
token-debt ledger and ``make_fleet``, replaying the scenarios of
``tests/test_fl_dynamics.py``, then the engine under those dynamics.

Tolerances:
- exact: every host draw and schedule (sampled, available, dropped and
  surviving client ids, straggler times, debts, fleet assignments,
  budgets): the same ``default_rng`` calls in the same order, and the
  same host float arithmetic;
- the engine runs: ``torch_tiny.assert_histories_match`` (schedules and
  knobs exact, duals 1e-9, usage 1e-6 relative, losses 5e-3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_tiny import assert_histories_match, run_pair, tiny_pair  # noqa: E402

import repro.fl as J  # noqa: E402
import repro_torch.fl as T  # noqa: E402
from repro.configs import get_fl_config as j_fl  # noqa: E402
from repro.core.policy import Knobs as JKnobs  # noqa: E402
from repro_torch.configs import get_fl_config as t_fl  # noqa: E402
from repro_torch.core.policy import Knobs as TKnobs  # noqa: E402

PKGS = {"jax": (J, j_fl, JKnobs), "torch": (T, t_fl, TKnobs)}

SAMPLERS = ["full", "uniform", "round_robin", "resource_aware"]
AVAILABILITY = ["always", "periodic", "bernoulli"]
STRAGGLERS = ["none", "deadline"]
DUALS = {"fast": {"energy": 0.1, "comm": 0.0, "memory": 0.0, "temp": 0.0},
         "slow": {"energy": 3.0, "comm": 1.0, "memory": 0.0, "temp": 0.5}}


def _fleet(pkg, n=8, het=False):
    mod, get_fl, _ = PKGS[pkg]
    fl = get_fl()
    fast = mod.DeviceProfile("fast", fl.budgets, compute_scale=0.5)
    slow = mod.DeviceProfile("slow", fl.budgets.scaled(0.5),
                             compute_scale=3.0, availability=0.5)
    profiles = [fast if (not het or i % 2 == 0) else slow for i in range(n)]
    return [mod.ClientInfo(i, profiles[i], shard_size=100 + i)
            for i in range(n)]


def _trace(pkg, dynamics, clients, seed, rounds=6, duals=None):
    """Composition, deadline and ledger for several rounds -> per round
    (available, sampled, survivors, dropped, times, debts)."""
    knobs_cls = PKGS[pkg][2]
    rng = np.random.default_rng(seed)
    dynamics.reset()
    kn = knobs_cls(k=2, s=4, b=8, q=0)
    out = []
    for t in range(1, rounds + 1):
        avail, sampled = dynamics.compose(t, clients, rng, duals or {})
        base = [kn] * len(sampled)
        knobs = dynamics.adjust_knobs(sampled, base)
        surv, drop, times = dynamics.finish(t, sampled, knobs, rng)
        dynamics.settle(sampled, base, knobs, surv, drop)
        out.append((tuple(ci.client_id for ci in avail),
                    tuple(ci.client_id for ci in sampled),
                    tuple(sampled[i].client_id for i in surv),
                    tuple(sampled[i].client_id for i in drop),
                    tuple(times),
                    tuple(k.grad_accum for k in knobs),
                    tuple(dynamics.debt(c.client_id) for c in clients)))
    return out


def _both(fn):
    """``fn(pkg)`` for both packages; the two results must be equal."""
    got = {pkg: fn(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


@pytest.mark.parametrize("sampler", SAMPLERS)
@pytest.mark.parametrize("availability", AVAILABILITY)
@pytest.mark.parametrize("stragglers", STRAGGLERS)
def test_participation_matches_reference(sampler, availability, stragglers):
    """Every combination gives the reference's participation, straggler
    times and debts from the same seed, with duals for the
    resource-aware sampler to read."""
    def trace(pkg):
        mod, get_fl, _ = PKGS[pkg]
        fl = get_fl().replace(num_clients=8, clients_per_round=3)
        dyn = mod.make_dynamics(fl, sampler, availability, stragglers,
                                deadline=1.0, churn_p=0.7)
        return _trace(pkg, dyn, _fleet(pkg, 8, het=True), seed=42,
                      duals=DUALS)

    _both(trace)


def test_round_robin_visits_everyone():
    def trace(pkg):
        mod = PKGS[pkg][0]
        dyn = mod.FleetDynamics(sampler=mod.RoundRobinSampler(2))
        return _trace(pkg, dyn, _fleet(pkg, 6), seed=0, rounds=3)

    seen = [cid for r in _both(trace) for cid in r[1]]
    assert sorted(seen) == list(range(6))


def test_full_participation_takes_all_available():
    def trace(pkg):
        mod = PKGS[pkg][0]
        dyn = mod.FleetDynamics(sampler=mod.FullParticipation())
        return _trace(pkg, dyn, _fleet(pkg, 5), seed=0, rounds=1)

    (r,) = _both(trace)
    assert r[1] == tuple(range(5)) and r[3] == ()


def test_periodic_availability_windows():
    def windows(pkg):
        mod = PKGS[pkg][0]
        rng = np.random.default_rng(0)
        av = mod.PeriodicAvailability(period=4, on_rounds=2)
        got = [sorted(ci.client_id for ci in av.available(rnd, _fleet(pkg),
                                                           rng))
               for rnd in range(1, 9)]
        av2 = mod.PeriodicAvailability(period=4, on_rounds=1,
                                       per_profile={"fast": (1, 1)})
        got.append(sorted(ci.client_id for ci in av2.available(
            3, _fleet(pkg, 4, het=True), rng)))
        return got

    got = _both(windows)
    for rnd, ids in enumerate(got[:8], start=1):
        assert ids == [c for c in range(8) if (rnd + c) % 4 < 2]
    assert {0, 2} <= set(got[8])


def test_bernoulli_churn_respects_profile_availability():
    def counts(pkg):
        mod = PKGS[pkg][0]
        churn = mod.BernoulliChurn(p=1.0)
        rng = np.random.default_rng(7)
        clients = _fleet(pkg, 8, het=True)
        n = {c: 0 for c in range(8)}
        for rnd in range(200):
            for ci in churn.available(rnd, clients, rng):
                n[ci.client_id] += 1
        return n

    n = _both(counts)
    assert all(n[c] == 200 for c in range(0, 8, 2))
    assert 60 < np.mean([n[c] for c in range(1, 8, 2)]) < 140


def test_resource_aware_sampler_prefers_headroom():
    def picks(pkg):
        mod = PKGS[pkg][0]
        clients = _fleet(pkg, 8, het=True)
        s = mod.ResourceAwareSampler(4, explore=0.0)
        greedy = [ci.profile.name for ci in
                  s.sample(1, clients, np.random.default_rng(0), DUALS)]
        fallback = [ci.client_id for ci in
                    s.sample(1, clients, np.random.default_rng(0), {})]
        return greedy, fallback

    greedy, fallback = _both(picks)
    assert greedy == ["fast"] * 4 and len(fallback) == 4


def test_resource_aware_explore_avoids_starvation():
    pressed = {"fast": {"energy": 0.0, "comm": 0.0, "memory": 0.0,
                        "temp": 0.0},
               "slow": {"energy": 9.0, "comm": 9.0, "memory": 9.0,
                        "temp": 9.0}}

    def picks(pkg):
        mod = PKGS[pkg][0]
        s = mod.ResourceAwareSampler(4)
        rng = np.random.default_rng(0)
        clients = _fleet(pkg, 8, het=True)
        return [tuple(ci.client_id for ci in s.sample(t, clients, rng,
                                                      pressed))
                for t in range(50)]

    picks_ = _both(picks)
    assert any(c % 2 == 1 for cohort in picks_ for c in cohort)


def test_deadline_stragglers_drop_slow_silicon():
    def split(pkg):
        mod, get_fl, _ = PKGS[pkg]
        from_fl = get_fl()
        model = mod.DeadlineStragglers.for_config(from_fl, deadline=1.5,
                                                  jitter=0.0)
        kn = PKGS[pkg][2](k=from_fl.k_base, s=from_fl.s_base,
                          b=from_fl.b_base, q=0)
        clients = _fleet(pkg, 8, het=True)
        surv, drop, times = model.split(1, clients, [kn] * 8,
                                        np.random.default_rng(0))
        late = [model.late_rounds(t) for t in (0.5, 1.5, 1.6, 3.0, 4.6)]
        return surv, drop, times, late

    surv, drop, times, late = _both(split)
    assert surv == [0, 2, 4, 6] and drop == [1, 3, 5, 7]
    assert times[0] == 0.5 and times[1] == 3.0
    assert late == [None, None, 1, 1, 3]
    assert T.DeadlineStragglers(0.0).late_rounds(5.0) is None


def test_token_debt_ledger():
    """The carry-over scenarios: debts, capped boosts and repayment."""
    def ledger(pkg):
        mod, _, knobs_cls = PKGS[pkg]
        out = []
        for cap in (4, 2):
            dyn = mod.FleetDynamics(sampler=mod.FullParticipation(),
                                    max_carry_accum=cap)
            dyn.reset()
            clients = _fleet(pkg, 2)
            kn = knobs_cls(k=2, s=4, b=8, q=0, grad_accum=1)
            heavy = dataclasses.replace(kn, grad_accum=8)
            base = [kn, kn]
            dyn.settle(clients, [heavy, heavy], [heavy, heavy], [0], [1])
            for _ in range(4):
                adj = dyn.adjust_knobs(clients, base)
                out.append((adj[1].grad_accum, dyn.debt(1)))
                dyn.settle(clients, base, adj, [0, 1], [])
            out.append(dyn.debt(1))
        off = mod.FleetDynamics(sampler=mod.FullParticipation(),
                                carryover_tokens=False)
        off.settle(_fleet(pkg, 2), base, base, [0], [1])
        out.append((off.debt(1), off.adjust_knobs(_fleet(pkg, 2), base)[1]
                    .grad_accum))
        return out

    out = _both(ledger)
    assert out[0] == (1 + 4, 256) and out[4] == 0
    assert out[5] == (1 + 2, 256) and out[6] == (1 + 2, 192)
    assert out[-1] == (0, 1)


def test_make_dynamics_components():
    fl = t_fl()
    dyn = T.make_dynamics(fl, "round_robin", "periodic", "deadline",
                          deadline=2.0, jitter=0.1, period=5, on_rounds=3)
    assert isinstance(dyn.sampler, T.RoundRobinSampler)
    assert (dyn.availability.period, dyn.availability.on_rounds) == (5, 3)
    assert (dyn.stragglers.deadline, dyn.stragglers.jitter) == (2.0, 0.1)
    assert dyn.stragglers.work_unit == fl.s_base * fl.b_base
    assert isinstance(T.make_dynamics(fl, "full", "bernoulli").availability,
                      T.BernoulliChurn)
    for kw in (dict(sampler="psychic"), dict(availability="sometimes"),
               dict(stragglers="quantum")):
        with pytest.raises(ValueError):
            T.make_dynamics(fl, **kw)
    with pytest.raises(ValueError):
        T.PeriodicAvailability(period=2, on_rounds=3)
    with pytest.raises(ValueError):
        T.ResourceAwareSampler(2, explore=1.5)


@pytest.mark.parametrize("classes", [
    [("fast", 0.5, 1.0, 1.0, 1.0), ("slow", 0.5, 0.5, 2.0, 0.5)],
    [("a", 0.3, 1.0, 1.0, 1.0), ("b", 0.3, 0.7, 1.5, 0.9),
     ("c", 0.4, 0.4, 3.0, 0.6)],
    [("solo", 1.0, 2.0, 0.8, 1.0)],
], ids=["two_tiers", "three_tiers", "one_tier"])
@pytest.mark.parametrize("num_clients", [6, 7, 16])
def test_make_fleet_matches_reference(classes, num_clients):
    def fleet(pkg):
        mod, get_fl, _ = PKGS[pkg]
        fl = get_fl().replace(num_clients=num_clients)
        profiles, assignment = mod.make_fleet(
            fl, [mod.FleetClass(n, f, budget_scale=bs, compute_scale=cs,
                                availability=av)
                 for n, f, bs, cs, av in classes])
        return assignment, {n: (dataclasses.astuple(p.budgets),
                                p.compute_scale, p.availability)
                            for n, p in profiles.items()}

    assignment, profiles = _both(fleet)
    assert len(assignment) == num_clients
    assert set(profiles) == {c[0] for c in classes}


def test_budgets_scaled_matches_reference():
    args = [(0.5, {}), (1.0, dict(comm=0.25)), (2.0, dict(energy=0.5,
                                                          temp=3.0))]
    got = [[dataclasses.astuple(get_fl().budgets.scaled(f, **kw))
            for f, kw in args] for get_fl in (j_fl, t_fl)]
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the engine under fleet dynamics
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(fl=dict(rounds=3, num_clients=6, clients_per_round=3))


def _churn_deadline(mod, fl):
    return dict(dynamics=mod.FleetDynamics(
        sampler=mod.UniformSampler(fl.clients_per_round),
        availability=mod.BernoulliChurn(0.8),
        stragglers=mod.DeadlineStragglers.for_config(fl, deadline=1.2,
                                                     jitter=0.6)))


def _hetero_resource_aware(mod, fl):
    profiles, cp = mod.make_fleet(fl, [
        mod.FleetClass("fast", 0.5),
        mod.FleetClass("slow", 0.5, budget_scale=0.5, compute_scale=2.0,
                       availability=0.7)])
    return dict(profiles=profiles, client_profiles=cp,
                dynamics=mod.make_dynamics(fl, "resource_aware",
                                           "periodic", "deadline",
                                           deadline=2.5))


def _round_robin_full(mod, fl):
    return dict(dynamics=mod.make_dynamics(fl, "round_robin", "always",
                                           "none"))


def _full_bernoulli(mod, fl):
    return dict(dynamics=mod.make_dynamics(fl, "full", "bernoulli", "none",
                                           churn_p=0.6))


@pytest.mark.parametrize("make", [
    _churn_deadline, _hetero_resource_aware, _round_robin_full,
    _full_bernoulli,
], ids=["churn_deadline", "hetero_resource_aware", "round_robin",
        "full_bernoulli"])
def test_engine_dynamics_match_reference(setup, make):
    """The engine under each dynamics bundle, both packages from the same
    parameters; CAFL-L with dropout keeps finite, non-negative duals
    and records participation faithfully."""
    plans = []

    class PlanCatcher(T.RoundCallback):
        def on_round_composed(self, engine, plan):
            plans.append(plan)

    def make_kw(mod, fl):
        kw = make(mod, fl)
        if mod is T:
            kw["callbacks"] = [PlanCatcher()]
        return kw

    (_, jres), (_, tres) = run_pair(setup, make_kw)
    assert_histories_match(jres, tres)
    assert len(plans) == len(tres.history)
    for r, plan in zip(tres.history, plans):
        assert set(r.participants) | set(r.dropped) == set(plan.sampled)
        assert set(r.participants).isdisjoint(r.dropped)
        assert r.num_available == len(plan.available)
        assert set(plan.sampled) <= set(plan.available)
        assert all(np.isfinite(lam) and lam >= 0.0
                   for lam in r.duals.values())
    if make is _churn_deadline:
        assert any(r.dropped for r in tres.history)
    if make is _hetero_resource_aware:
        assert all(set(r.per_profile) <= {"fast", "slow"}
                   for r in tres.history)


def test_zero_survivor_round_is_safe(setup):
    lines = []

    def make_kw(mod, fl):
        kw = dict(dynamics=mod.FleetDynamics(
            sampler=mod.UniformSampler(fl.clients_per_round),
            stragglers=mod.DeadlineStragglers(deadline=0.0, jitter=0.0)))
        if mod is T:
            kw["callbacks"] = [T.LoggingCallback(lines.append)]
        return kw

    (_, jres), (_, tres) = run_pair(setup, make_kw, fl=dict(rounds=1))
    assert_histories_match(jres, tres)
    r = tres.history[0]
    assert r.participants == [] and len(r.dropped) == 3
    assert r.train_loss == 0.0 and all(v == 0.0 for v in r.usage.values())
    assert all(lam == 0.0 for lam in r.duals.values())
    assert len(lines) == 1 and "drop=3" in lines[0]


def test_no_clients_reachable_round(setup):
    lines = []

    def make_kw(mod, fl):
        kw = dict(dynamics=mod.FleetDynamics(
            sampler=mod.UniformSampler(fl.clients_per_round),
            availability=mod.BernoulliChurn(0.0)))
        if mod is T:
            kw["callbacks"] = [T.LoggingCallback(lines.append)]
        return kw

    (_, jres), (_, tres) = run_pair(setup, make_kw, fl=dict(rounds=1),
                                    strategy="fedavg")
    assert_histories_match(jres, tres)
    r = tres.history[0]
    assert r.knobs == {} and r.num_available == 0 and r.participants == []
    assert "no clients reachable" in lines[0]
