"""The port's constraint stack against the reference: the dead-zone,
adaptive and PI controllers (with the PI integrator's state),
``dual_config_for`` / ``fl.dual_overrides``, the ``wire_mb``,
``energy_true`` and ``latency`` constraints, the deadline-aware knob
policy, the proxy-only ``proxy_control_loop``, and the engine running
those stacks, replaying ``tests/test_constraints.py`` and the
constraint cases of ``tests/test_fl_clock.py``.

Tolerances:
- duals and the PI integrators: 1e-9 (host float arithmetic on equal
  inputs; measured equal);
- exact: knobs, deadlines and every other host schedule;
- usage and ratios: 1e-6 relative;
- the engine runs: ``torch_tiny.assert_histories_match`` (losses and
  wire MB 5e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_tiny import assert_histories_match, run_pair, tiny_pair  # noqa: E402

import repro.constraints as JC  # noqa: E402
import repro.fl as J  # noqa: E402
import repro_torch.constraints as TC  # noqa: E402
import repro_torch.fl as T  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.configs import get_fl_config as j_fl  # noqa: E402
from repro.core import duals as jduals  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_fl_config as t_fl  # noqa: E402
from repro_torch.core import duals as tduals  # noqa: E402

DUAL_ATOL = 1e-9
USAGE_RTOL = 1e-6
RESOURCES = ("energy", "comm", "memory", "temp")

#: per package: constraints, fl, configs.base, core.duals, get_fl_config
PKGS = {"jax": (JC, J, jbase, jduals, j_fl),
        "torch": (TC, T, tbase, tduals, t_fl)}


def _both(fn):
    got = {pkg: fn(*PKGS[pkg]) for pkg in PKGS}
    return got["jax"], got["torch"]


def _close(a, b, atol=DUAL_ATOL):
    """Nested lists / dicts / floats equal, floats within ``atol``."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, atol)
    elif isinstance(a, float):
        assert b == pytest.approx(a, abs=atol)
    else:
        assert a == b


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------

#: ratios that hit the band's edges (1.05 - 1.0 is just outside 0.05)
EDGES = [1.0, 1.05, 0.95, 1.0500000001, 0.9499999999, 0.0, 12.0, 1.2]


@pytest.mark.parametrize("spec", [
    ("deadzone", {}), ("adaptive", {}), ("adaptive", dict(gain=0.5,
                                                          max_scale=2.0)),
    ("pi", {}), ("pi", dict(kp_scale=0.0, ki_scale=2.0)),
    ("pi", dict(kp_scale=1.5, ki_scale=0.0)), ("subgradient", {})])
def test_controller_streams_match_reference(spec):
    """Seeded ratio streams on three (profile, constraint) keys, with
    warm starts, band-edge ratios, a reset and per-key configs: the same
    multipliers and the same PI integrals."""
    name, kw = spec

    def stream(C, _fl, base, *_):
        ctrl = C.make_controller(name, **kw)
        cfgs = [base.DualConfig(), base.DualConfig(eta=1.0, deadzone=0.0),
                base.DualConfig(eta=0.1, deadzone=0.2, lambda_max=2.0)]
        rng = np.random.default_rng(11)
        ratios = list(rng.uniform(0.0, 3.0, 150)) + EDGES * 3
        lam = {"a": 0.0, "b": 3.0, "c": 0.7}
        out = []
        for i, r in enumerate(ratios):
            if i == 100:
                ctrl.reset()
            key = "abc"[i % 3]
            lam[key] = ctrl.step(f"p:{key}", lam[key], float(r),
                                 cfgs[i % 3])
            out.append((lam[key], ctrl.state_snapshot()))
        return out

    j, t = _both(stream)
    _close(j, t)
    assert all(0.0 <= lam <= 10.0 for lam, _ in t)


def test_pi_controller_holds_warm_start():
    ctrl = TC.PIController()
    cfg = tbase.DualConfig()
    lam = 5.0
    for _ in range(4):
        lam = ctrl.step("k", lam, 1.0, cfg)
        assert lam == pytest.approx(5.0)
    assert ctrl.step("k", lam, 2.0, cfg) > 5.0
    ctrl.reset()
    assert ctrl.state_snapshot() == {"name": "pi", "integrals": {}}


def test_make_controller_resolution():
    assert isinstance(TC.make_controller(), TC.DeadzoneSubgradient)
    assert isinstance(TC.make_controller(None), TC.DeadzoneSubgradient)
    assert isinstance(TC.make_controller("adaptive"), TC.AdaptiveStep)
    pi = TC.PIController()
    assert TC.make_controller(pi) is pi
    assert TC.CONTROLLERS == JC.CONTROLLERS
    with pytest.raises(ValueError):
        TC.make_controller("bang-bang")
    with pytest.raises(ValueError):
        TC.PIController(kp_scale=0.0, ki_scale=0.0)
    with pytest.raises(ValueError):
        TC.AdaptiveStep(max_scale=0.5)


def test_dual_config_for_overrides():
    base = tbase.DualConfig()
    assert TC.dual_config_for(base, None, "energy") is base
    assert TC.dual_config_for(base, {}, "energy") is base
    out = TC.dual_config_for(base, {"latency": {"eta": 1.0,
                                                "deadzone": 0.0}},
                             "latency")
    assert (out.eta, out.deadzone, out.lambda_max) == (1.0, 0.0,
                                                       base.lambda_max)
    full = tbase.DualConfig(eta=0.9)
    assert TC.dual_config_for(base, {"comm": full}, "comm") is full
    with pytest.raises(TypeError):
        TC.dual_config_for(base, {"comm": {"not_a_field": 1}}, "comm")
    with pytest.raises(ValueError, match="latencyy"):
        TC.resolve_dual_configs(base, {"latencyy": {}}, RESOURCES)


# ---------------------------------------------------------------------------
# constraints
# ---------------------------------------------------------------------------


class _Rep:
    usage = {"energy": 2.0e6, "comm": 0.3, "memory": 0.1, "temp": 0.5}
    wire_mb_actual = 1.2
    energy_true = 3.1e6
    arrival_time = 1.7


@pytest.mark.parametrize("name", ["wire_mb", "energy_true", "latency"])
def test_new_constraints_match_reference(name):
    budgets = dict(energy=1.0e6, comm_mb=0.6, memory=1.0, temp=1.0)

    def describe(C, _fl, base, *_):
        cset = C.make_constraints(f"paper+{name}")
        b = base.Budgets(**budgets)
        m = cset.measure(_Rep())
        return (cset.names, m, cset.budgets_dict(b), cset.ratios(m, b),
                cset.constraints[-1].knob_group,
                cset.grouped_lam({n: 0.25 * (i + 1)
                                  for i, n in enumerate(cset.names)}))

    j, t = _both(describe)
    assert t == j
    assert t[0] == RESOURCES + (name,)


def test_make_constraints_specs():
    five = TC.make_constraints("paper+wire_mb")
    assert TC.make_constraints().names == RESOURCES
    assert five.names == RESOURCES + ("wire_mb",)
    assert TC.make_constraints(five) is five
    assert TC.make_constraints(["energy", "latency"]).names == \
        ("energy", "latency")
    assert set(TC.CONSTRAINT_REGISTRY) >= set(RESOURCES) | {
        "wire_mb", "energy_true", "latency"}
    with pytest.raises(ValueError):
        TC.make_constraints("paper+unobtainium")
    grouped = TC.make_constraints("paper+wire_mb+latency").grouped_lam(
        {"energy": 0.3, "comm": 1.7, "memory": 0.0, "temp": 9.9,
         "wire_mb": 0.5, "latency": 3.0})
    assert grouped == {"energy": 0.3, "comm": 1.7 + 0.5, "memory": 0.0,
                       "temp": 9.9}


@pytest.mark.parametrize("stack", [
    dict(constraints="paper+wire_mb"),
    dict(constraints="paper+latency",
         dual_overrides={"latency": {"eta": 1.0, "deadzone": 0.0}}),
    dict(constraints="paper+energy_true+wire_mb", dual_controller="pi",
         dual_overrides={"wire_mb": {"eta": 0.7}}),
    dict(constraints="paper+latency", dual_controller="adaptive",
         knob_policy="deadline_aware"),
], ids=["wire_mb", "latency_override", "pi_energy_true", "adaptive"])
def test_cafll_update_state_matches_reference(stack):
    """``CAFLL.update_state`` over a two-profile fleet for 8 rounds of
    seeded usage: the same duals, reports and next knobs."""
    def run(C, F, base, _d, get_fl):
        fl = get_fl().replace(**stack)
        strat = F.CAFLL(fl)
        profiles = {"a": F.DeviceProfile("a", fl.budgets),
                    "b": F.DeviceProfile("b", fl.budgets.scaled(0.5))}
        clients = [F.ClientInfo(i, profiles["ab"[i % 2]], 10)
                   for i in range(4)]
        rng = np.random.default_rng(5)
        out = []
        for rnd in range(1, 9):
            knobs = strat.configure_round(rnd, clients)
            scale = rng.uniform(0.5, 3.0, size=(4, len(strat.constraints)))
            budgets = strat.constraints.budgets_dict(fl.budgets)
            usages = [{n: float(s * budgets[n]) for n, s in
                       zip(strat.constraints.names, row)} for row in scale]
            snap = strat.update_state(usages, clients)
            reps = {p: [r.as_dict() for r in rs] for p, rs in
                    strat.constraint_reports().items()}
            out.append(([k.as_dict() for k in knobs], snap, reps))
        return out

    j, t = _both(run)
    _close(j, t)


def test_fifth_constraint_drives_its_own_dual():
    fl = t_fl().replace(constraints="paper+wire_mb")
    strat = T.CAFLL(fl)
    clients = [T.ClientInfo(0, T.DeviceProfile("default", fl.budgets), 10)]
    ok = {"energy": fl.budgets.energy, "comm": fl.budgets.comm_mb,
          "memory": fl.budgets.memory, "temp": fl.budgets.temp,
          "wire_mb": 5.0 * fl.budgets.comm_mb}
    snap = strat.update_state([ok], clients)
    assert snap["default"]["wire_mb"] > 0.0
    assert all(snap["default"][r] == 0.0 for r in RESOURCES)
    reps = {r.name: r for r in strat.constraint_reports()["default"]}
    assert reps["wire_mb"].violated and not reps["comm"].violated
    for _ in range(6):
        strat.update_state([ok], clients)
    assert strat.configure_round(2, clients)[0].q > 0


def test_cafll_dual_overrides():
    fl = t_fl().replace(constraints="paper+latency",
                        dual_overrides={"latency": {"eta": 1.0,
                                                    "deadzone": 0.0}})
    strat = T.CAFLL(fl)
    ci = T.ClientInfo(0, T.DeviceProfile("default", fl.budgets), 10)
    b = fl.budgets
    usage = {"energy": b.energy, "comm": 2.0 * b.comm_mb,
             "memory": b.memory, "temp": b.temp, "latency": 2.0}
    duals = strat.update_state([usage], [ci])["default"]
    assert duals["comm"] == pytest.approx(fl.duals.eta * 1.0)
    assert duals["latency"] == pytest.approx(1.0)
    assert duals["energy"] == 0.0
    with pytest.raises(ValueError, match="latencyy"):
        T.CAFLL(t_fl().replace(dual_overrides={"latencyy": {"eta": 1.0}}))


def test_make_strategy_threads_constraint_stack():
    fl = t_fl().replace(dual_controller="pi", constraints="paper+wire_mb")
    strat = T.make_strategy("cafl", fl)
    assert isinstance(strat.controller, TC.PIController)
    assert strat.constraints.names == RESOURCES + ("wire_mb",)
    assert isinstance(T.make_strategy("cafl", fl, controller="adaptive")
                      .controller, TC.AdaptiveStep)
    wrapped = T.make_strategy("cafl+adam", fl)
    assert wrapped.constraints.names == strat.constraints.names


# ---------------------------------------------------------------------------
# the deadline-aware knob policy
# ---------------------------------------------------------------------------


def _plan(F, sampled, survivors, times, rnd=1):
    sampled, survivors = tuple(sampled), tuple(survivors)
    return F.RoundPlan(round=rnd, available=sampled, sampled=sampled,
                       survivors=survivors,
                       dropped=tuple(c for c in sampled
                                     if c not in survivors),
                       times=tuple(times))


#: (latency dual, sampled, survivors, times) per round
SCRIPTS = {
    "widen_relax": [(0.0, (0, 1, 2, 3), (0,), (0.9, 1.8, 2.0, 2.2))]
    + [(0.0, (0, 1), (0, 1), (0.5, 0.6))] * 28,
    "cap": [(0.0, (0, 1), (), (50.0, 60.0))] * 9,
    "relax_floor": [(0.0, (0, 1), (), (3.0, 3.0)),
                    (0.0, (0, 1), (0, 1), (3.0, 3.0))],
    "latency": [(2.0, (0, 1), (0, 1), (0.4, 0.5))]
    + [(0.0, (0, 1), (0, 1), (0.4, 0.5))] * 28
    + [(2.0, (0, 1), (0, 1), (0.4, 0.5))],
    "starved_under_pressure": [(5.0, (0, 1), (), (3.0, 3.0))] * 3,
    "min_scale": [(10.0, (0, 1), (0, 1), (0.1, 0.1))] * 5,
    "no_cohort": [(1.0, (), (), ())] * 2,
}
POLICY_KW = {"widen_relax": dict(min_report_frac=0.5, widen=1.3,
                                 max_scale=4.0, relax=0.9, headroom=1.05),
             "cap": dict(max_scale=2.0), "relax_floor": dict(relax=0.5),
             "latency": dict(latency_gain=0.5, latency_budget=1.0),
             "starved_under_pressure": {},
             "min_scale": dict(min_scale=0.25, latency_gain=10.0),
             "no_cohort": {}}
BASE_DEADLINE = {"widen_relax": 1.0, "cap": 1.0, "relax_floor": 1.0,
                 "latency": 2.0, "starved_under_pressure": 1.0,
                 "min_scale": 100.0, "no_cohort": 1.0}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_deadline_aware_matches_reference(script):
    """Round scripts through ``knobs`` then ``observe``: the same
    deadline after every round, the same snapshots and knobs, and
    ``reset`` restores the base deadline."""
    def run(C, F, _b, duals, get_fl):
        fl = get_fl()
        dyn = F.FleetDynamics(sampler=F.UniformSampler(2),
                              stragglers=F.DeadlineStragglers(
                                  deadline=BASE_DEADLINE[script]))
        pol = C.DeadlineAwareKnobPolicy(**POLICY_KW[script])
        out = []
        for rnd, (lam, sampled, surv, times) in enumerate(SCRIPTS[script],
                                                          start=1):
            kn = pol.knobs(duals.DualState(lam={**{r: 0.0 for r in
                                                   RESOURCES},
                                                "latency": lam}), fl)
            pol.observe(_plan(F, sampled, surv, times, rnd), [], dyn)
            out.append((kn.as_dict(), dyn.stragglers.deadline,
                        pol.state_snapshot()))
        pol.reset()
        out.append((dyn.stragglers.deadline, pol.scale))
        return out

    j, t = _both(run)
    _close(j, t)
    assert t[-1] == (BASE_DEADLINE[script], 1.0)
    last = t[-2][1]
    if script == "widen_relax":
        assert t[0][1] == pytest.approx(1.8 * 1.05) and last == 1.0
    elif script == "cap":
        assert last == pytest.approx(2.0)
    elif script == "latency":
        assert t[0][1] == pytest.approx(1.0) and last == pytest.approx(1.0)
    elif script == "starved_under_pressure":
        assert last > 1.0
    elif script == "min_scale":
        assert last == pytest.approx(25.0)


def test_deadline_aware_noop_without_deadline_model():
    dyn = T.FleetDynamics(sampler=T.UniformSampler(2),
                          stragglers=T.NoStragglers())
    pol = TC.DeadlineAwareKnobPolicy()
    pol.observe(_plan(T, (0, 1), (), ()), [], dyn)
    assert pol.scale == 1.0
    fl = t_fl()
    from repro_torch.core.policy import policy
    assert pol.knobs(tduals.DualState(), fl) == policy(tduals.DualState(),
                                                       fl)
    with pytest.raises(ValueError):
        TC.DeadlineAwareKnobPolicy(widen=1.0)


def test_make_knob_policy_resolution_and_threading():
    cset = TC.paper_constraints()
    pol = TC.make_knob_policy("paper", constraints=cset)
    assert isinstance(pol, TC.PaperKnobPolicy) and pol.constraints is cset
    da = TC.make_knob_policy("deadline_aware", constraints=cset)
    assert isinstance(da, TC.DeadlineAwareKnobPolicy)
    assert da.base.constraints is cset
    assert TC.KNOB_POLICIES == JC.KNOB_POLICIES
    with pytest.raises(ValueError):
        TC.make_knob_policy("vibes")
    five = TC.make_constraints("paper+wire_mb")
    inst = TC.DeadlineAwareKnobPolicy()
    assert TC.make_knob_policy(inst, constraints=five) is inst
    assert inst.base.constraints is five
    duals = tduals.DualState(lam={**{r: 0.0 for r in RESOURCES},
                                  "wire_mb": 2.0})
    assert inst.knobs(duals, t_fl()).q == 2
    strat = T.CAFLL(t_fl().replace(constraints="paper+wire_mb"),
                    knob_policy=TC.DeadlineAwareKnobPolicy())
    assert strat.knob_policy.base.constraints is strat.constraints


def test_strategy_reset_restores_deadline():
    dyn = T.FleetDynamics(sampler=T.UniformSampler(2),
                          stragglers=T.DeadlineStragglers(deadline=1.0))
    pol = TC.DeadlineAwareKnobPolicy()
    strat = T.CAFLL(t_fl().replace(knob_policy=pol))
    assert strat.knob_policy is pol
    pol.observe(_plan(T, (0, 1), (), (3.0, 3.0)), [], dyn)
    assert dyn.stragglers.deadline > 1.0
    strat.reset()
    assert dyn.stragglers.deadline == 1.0 and pol.scale == 1.0


# ---------------------------------------------------------------------------
# the proxy-only loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("controller", ["deadzone", "adaptive", "pi"])
@pytest.mark.parametrize("variant", [
    dict(), dict(knob_policy="deadline_aware"),
    dict(constraints=["energy", "comm"]),
    dict(fl=dict(dual_overrides={"comm": {"eta": 1.0}})),
    dict(fl=dict(token_preservation="clamped"), p_base=2.5e6),
], ids=["paper", "deadline_aware", "two_constraints", "override",
        "clamped"])
def test_proxy_control_loop_matches_reference(controller, variant):
    """Per-round knobs and ratios over 60 rounds of the proxy loop, and
    the ``rounds_to_band`` / ``tail_worst_ratio`` read-outs."""
    variant = dict(variant)
    fl_over = variant.pop("fl", {})

    def run(C, _F, _b, _d, get_fl):
        fl = get_fl().replace(**fl_over)
        hist = C.proxy_control_loop(fl, controller=controller, rounds=60,
                                    **variant)
        band = 1.0 + fl.duals.deadzone
        return ([(kn.as_dict(), ratios) for kn, ratios in hist],
                C.rounds_to_band(hist, band), C.rounds_to_band(hist, 0.0),
                C.tail_worst_ratio(hist), C.tail_worst_ratio(hist, 3))

    j, t = _both(run)
    assert [h[0] for h in t[0]] == [h[0] for h in j[0]]
    for (_, tr), (_, jr) in zip(t[0], j[0]):
        assert tr.keys() == jr.keys()
        for n in jr:
            assert tr[n] == pytest.approx(jr[n], rel=USAGE_RTOL)
    assert t[1:3] == j[1:3] and t[2] is None
    assert t[3] == pytest.approx(j[3], rel=USAGE_RTOL)
    assert t[4] == pytest.approx(j[4], rel=USAGE_RTOL)


def test_proxy_control_loop_adaptive_closes_faster():
    fl = t_fl()
    band = 1.0 + fl.duals.deadzone
    hist = TC.proxy_control_loop(fl, controller="deadzone", rounds=60)
    kn0, r0 = hist[0]
    assert kn0.k == fl.k_base and r0["comm"] > 5.0
    hit_dz = TC.rounds_to_band(hist, band)
    hit_ad = TC.rounds_to_band(
        TC.proxy_control_loop(fl, controller="adaptive", rounds=60), band)
    assert hit_dz is not None and hit_ad is not None and hit_ad < hit_dz


# ---------------------------------------------------------------------------
# the engine over these stacks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    return tiny_pair(fl=dict(rounds=3, num_clients=6, clients_per_round=3))


def _deadline_dyn(mod, fl, deadline=0.9, jitter=0.4):
    return mod.FleetDynamics(
        sampler=mod.UniformSampler(fl.clients_per_round),
        stragglers=mod.DeadlineStragglers.for_config(fl, deadline=deadline,
                                                     jitter=jitter))


@pytest.mark.parametrize("fl_over,make", [
    (dict(dual_controller="pi"), None),
    (dict(dual_controller="adaptive", constraints="paper+energy_true"),
     None),
    (dict(knob_policy="deadline_aware", constraints="paper+latency",
          dual_overrides={"latency": {"eta": 1.0, "deadzone": 0.0}}),
     lambda mod, fl: dict(dynamics=_deadline_dyn(mod, fl))),
    (dict(constraints="paper+wire_mb", wire_topk=64,
          dual_overrides={"wire_mb": {"eta": 1.0}}), None),
], ids=["pi", "adaptive_energy_true", "deadline_aware_latency",
        "wire_mb_topk"])
def test_engine_constraint_stacks_match_reference(setup, fl_over, make):
    (_, jres), (_, tres) = run_pair(setup, make, fl=fl_over)
    assert_histories_match(jres, tres)
    names = tres.history[0].constraints.keys()
    for extra in ("latency", "wire_mb", "energy_true"):
        assert (extra in names) == (extra in fl_over.get("constraints", ""))


def test_engine_emits_dual_updates_and_constraint_records(setup):
    seen = []

    class Catcher(T.RoundCallback):
        def on_dual_update(self, engine, rnd, reports):
            seen.append((rnd, reports))

    def make(mod, fl):
        return dict(callbacks=[Catcher()]) if mod is T else {}

    (_, jres), (_, tres) = run_pair(
        setup, make, fl=dict(constraints="paper+wire_mb"))
    assert_histories_match(jres, tres)
    assert [rnd for rnd, _ in seen] == [1, 2, 3]
    for (rnd, reports), rec in zip(seen, tres.history):
        names = [r.name for r in reports["default"]]
        assert names == list(RESOURCES) + ["wire_mb"]
        assert set(rec.constraints) == set(names)
