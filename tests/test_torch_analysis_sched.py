"""The port's schedule-determinism analysis
(``repro_torch.analysis.sched``) against the reference's
(``repro.analysis.sched``): the happens-before model over hand-built
event streams, the adversarial tie queue, signature comparison, and the
three gate scenarios run in both packages on the CPU at the reference
gate's tiny stack, from the same seeds and the same JAX-initialised
weights.

Bounds: HB graphs (events, their happens-before closure, unordered
pairs), swaps per permutation, races and certificates are equal; the two
packages' round records agree within ``tests/test_torch_engine.py``'s
bounds (``torch_tiny.assert_histories_match``: schedules, knobs and
simulated times exact, duals 1e-9, usage 1e-6 relative, losses and wire
MB 5e-3), and their final parameters within the same 5e-3."""
import copy
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_tiny import LOSS_ATOL, assert_histories_match  # noqa: E402

from repro.analysis.sched import AdversarialTieQueue as JTieQueue  # noqa: E402
from repro.analysis.sched import HBGraph as JHBGraph  # noqa: E402
from repro.analysis.sched import SchedEvent as JSchedEvent  # noqa: E402
from repro.analysis.sched import SchedulePermuter as JPermuter  # noqa: E402
from repro.analysis.sched import \
    ScheduleSanitizerCallback as JSanitizer  # noqa: E402
from repro.analysis.sched.gate import SCENARIOS as J_SCENARIOS  # noqa: E402
from repro.analysis.sched.gate import _tiny_stack as j_tiny_stack  # noqa: E402
from repro.analysis.sched.permute import \
    run_signature as j_run_signature  # noqa: E402
from repro_torch.analysis.cli import main as cli_main  # noqa: E402
from repro_torch.analysis.sched import (AdversarialTieQueue,  # noqa: E402
                                        HBGraph, SchedEvent,
                                        ScheduleRecorder,
                                        SchedulePermuter,
                                        ScheduleSanitizerCallback)
from repro_torch.analysis.sched.gate import (SCENARIOS,  # noqa: E402
                                             _tiny_stack, run_scenario)
from repro_torch.analysis.sched.permute import (  # noqa: E402
    compare_signatures, run_signature)
from repro_torch.models import params_from_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# happens-before model (pure: hand-built event streams)
# ---------------------------------------------------------------------------


def _ev(kind, rnd, time, index, client=-1, clients=(), cls=SchedEvent):
    return cls(kind=kind, round=rnd, time=time, index=index, client=client,
               clients=tuple(clients))


TIED_ROUND = [("round_start", 0, 0.0, 0), ("deliver", 0, 1.0, 1, 0),
              ("deliver", 0, 1.0, 2, 1), ("apply", 0, 1.0, 3, -1, (0, 1)),
              ("deliver", 0, 2.0, 4, 2), ("apply", 0, 2.0, 5, -1, (2,)),
              ("dual", 0, 2.0, 6), ("round_end", 0, 2.0, 7)]


@pytest.fixture()
def tied_round():
    """round_start; c0 and c1 arrive simultaneously; their apply; a
    later c2 + apply; dual; round_end."""
    return HBGraph([_ev(*e) for e in TIED_ROUND])


def test_hb_orders_strict_time_and_causality(tied_round):
    g = tied_round
    assert g.happens_before(0, 1) and g.happens_before(0, 7)
    assert g.happens_before(1, 3) and g.happens_before(2, 3)
    assert g.happens_before(3, 4) and g.happens_before(1, 4)
    assert g.happens_before(4, 5)
    assert g.happens_before(5, 6) and g.happens_before(5, 7)
    assert not g.happens_before(4, 1)


def test_hb_simultaneous_deliveries_are_schedule_freedom(tied_round):
    pairs = tied_round.unordered_pairs()
    assert [(a.index, b.index) for a, b in pairs] == [(1, 2)]


@pytest.mark.parametrize("cert,tie_broken,expect_certified", [
    ("exact", True, True),
    ("canonical", True, True),
    ("tiebreak", True, True),
    ("tiebreak", False, False),
    (None, True, False),
])
def test_hb_race_certification(tied_round, cert, tie_broken,
                               expect_certified):
    races = tied_round.races(cert, tie_broken=tie_broken)
    assert len(races) == 1
    race = races[0]
    assert race.state == ("aggregator",)
    assert race.certified is expect_certified
    assert ("RACE" in race.describe()) is (not expect_certified)


@pytest.mark.parametrize("stream", [
    TIED_ROUND,
    [("deliver", 0, 1.0, 0, 0), ("deliver", 0, 1.0, 1, 0),
     ("deliver", 0, 1.0, 2, 1)],
    [("round_start", 0, 0.0, 0), ("deliver", 0, 1.0, 1, 0),
     ("round_end", 0, 1.0, 2), ("round_start", 1, 1.0, 3),
     ("deliver", 1, 1.0, 4, 1)],
])
def test_hb_graph_equals_the_references(stream):
    """The same event stream gives the same closure, unordered pairs and
    race verdicts in both packages."""
    port = HBGraph([_ev(*e) for e in stream])
    ref = JHBGraph([_ev(*e, cls=JSchedEvent) for e in stream])
    assert port._closure == ref._closure
    assert ([(a.index, b.index) for a, b in port.unordered_pairs()]
            == [(a.index, b.index) for a, b in ref.unordered_pairs()])
    for cert in ("exact", "tiebreak", None):
        assert ([r.describe() for r in port.races(cert)]
                == [r.describe() for r in ref.races(cert)])


def test_recorder_rejects_truncated_clock_log():
    rec = ScheduleRecorder()
    clock = SimpleNamespace(event_count=5, max_events=2,
                            events=[("deliver:c0", 1.0, 1.0)], now=1.0)
    with pytest.raises(ValueError, match="truncated"):
        rec.events(SimpleNamespace(clock=clock))


# ---------------------------------------------------------------------------
# adversarial ties + signature comparison (pure units)
# ---------------------------------------------------------------------------


def _deliveries(cls, seed):
    q = cls(seed=seed)
    for i, arrival in enumerate([2.0, 1.0, 1.0, 1.0, 2.0, 1.0]):
        q.push(arrival, f"r{i}")
    return [(e.arrival, e.tie, e.seq, e.report) for e in q.drain()]


def test_adversarial_tie_queue_is_legal_and_replayable():
    a, b = _deliveries(AdversarialTieQueue, 0), _deliveries(
        AdversarialTieQueue, 0)
    assert a == b
    assert [t for t, *_ in a] == sorted(t for t, *_ in a)
    assert any(_deliveries(AdversarialTieQueue, s) != a for s in range(1, 8))
    ev = AdversarialTieQueue(seed=3).stamp(1.0, "r")
    assert math.isfinite(ev.tie) and ev.arrival == 1.0


@pytest.mark.parametrize("seed", [0, 1, 7, 7920, 15839])
def test_adversarial_tie_queue_makes_the_references_swaps(seed):
    """Same seed, same pushes: the same ties, bit for bit, and the same
    delivery order."""
    assert (_deliveries(AdversarialTieQueue, seed)
            == _deliveries(JTieQueue, seed))


def _sig(val=1.0, knobs=None, order=(0, 1)):
    return {"rounds": [{
        "round": 0, "val_loss": val, "train_loss": 1.0,
        "wire_mb_actual": 1.0, "energy_true": 1.0, "mean_staleness": 0.0,
        "sim_time": 1.0, "round_seconds": 1.0, "updates_applied": 1,
        "reports_applied": 2, "num_available": 2,
        "usage": {"t": 1.0}, "ratios": {"t": 1.0}, "duals": {"t": 0.0},
        "knobs": knobs or {"k": 2}, "participants": frozenset(order),
        "participant_order": tuple(order), "dropped": frozenset(),
    }], "final": []}


def test_compare_signatures_modes():
    base = _sig()
    assert compare_signatures(base, _sig(), "exact") == []
    drift = _sig(val=1.0 + 1e-9)
    assert compare_signatures(base, drift, "exact")
    assert compare_signatures(base, drift, "tolerance") == []
    assert compare_signatures(base, _sig(knobs={"k": 3}), "tolerance")
    assert compare_signatures(base, _sig(order=(1, 0)), "exact") == []


# ---------------------------------------------------------------------------
# the gate's scenarios in both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def stacks():
    """Both packages' tiny stacks, and the JAX engine's default weights
    (``PRNGKey(fl.seed)``) bridged into the port, so both packages run
    every replay from the same parameters."""
    jmodel, jfl, jds = j_tiny_stack()
    tmodel, tfl, tds = _tiny_stack()
    p = jax.tree.map(lambda a: np.array(a, copy=True),
                     jmodel.init(jax.random.PRNGKey(jfl.seed)))
    return dict(j=(jmodel, jfl, jds), t=(tmodel, tfl, tds), p=p)


def _events(graph):
    return [(e.kind, e.round, e.time, e.index, e.client, e.clients)
            for e in graph.events]


def _fresh_run(eng, **kw):
    """One more production-schedule run of a permuted engine (whose
    strategy the permuter left untouched), with the batch streams
    rewound."""
    eng.data.reset_rngs()
    eng.strategy = copy.deepcopy(eng.strategy)
    return eng.run(time_mode="wall_clock", **kw)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_the_references(stacks, name):
    jmodel, jfl, jds = stacks["j"]
    tmodel, tfl, tds = stacks["t"]
    init = params_from_numpy(stacks["p"], "cpu")
    # the reference: its scenario builder and permuter, as its gate runs
    jsan = JSanitizer(strict=False)
    jeng, kw = J_SCENARIOS[name](jmodel, jfl, jds, jsan)
    jperm = JPermuter(jeng, run_kwargs={"time_mode": "wall_clock"},
                      **kw).run()
    # the port, the same way on the CPU, from the same weights
    tsan = ScheduleSanitizerCallback(strict=False)
    teng, kw = SCENARIOS[name](tmodel, tfl, tds, tsan, "cpu")
    tperm = SchedulePermuter(teng, run_kwargs={"time_mode": "wall_clock",
                                               "init_params": init},
                             **kw).run()
    assert tperm.ok() and jperm.ok(), tperm.problems + tperm.mismatches
    assert tperm.total_swapped > 0
    assert (tperm.mode, tperm.permutations) == (jperm.mode,
                                                jperm.permutations)
    assert tperm.swapped == jperm.swapped
    # the last replay's happens-before graph
    assert _events(tsan.graph) == _events(jsan.graph)
    assert tsan.graph._closure == jsan.graph._closure
    assert (len(tsan.graph.unordered_pairs())
            == len(jsan.graph.unordered_pairs()))
    assert len(tsan.races) == len(jsan.races) == 0
    assert ([r.describe() for r in tsan.certified]
            == [r.describe() for r in jsan.certified])
    assert teng.aggregator.commutativity == jeng.aggregator.commutativity
    assert teng.aggregator.name == jeng.aggregator.name
    # the production-schedule run's records and weights agree
    jres = _fresh_run(jeng)
    tres = _fresh_run(teng, init_params=init)
    assert_histories_match(jres, tres)
    jsig, tsig = j_run_signature(jres), run_signature(tres)
    assert ([r["participant_order"] for r in tsig["rounds"]]
            == [r["participant_order"] for r in jsig["rounds"]])
    assert len(tsig["final"]) == len(jsig["final"])
    for a, b in zip(tsig["final"], jsig["final"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=0, atol=LOSS_ATOL)


def test_paper_fleet_breaks_fedbuffs_fill_alignment(stacks):
    """Why the gate keeps its 6-client fleet (and the card's run with
    it): at the paper's 16 clients the three device classes hold 5, 5
    and 6 clients, each a tie group, and FedBuff's fills of 2 then take
    a schedule-dependent pair out of a group. The replays stay legal,
    but their participants differ, so exact mode reports mismatches."""
    tmodel, tfl, tds = stacks["t"]
    fl = tfl.replace(num_clients=16, clients_per_round=6)
    row, findings, problems = run_scenario("fedbuff_wall", tmodel, fl, tds,
                                           permutations=2, device="cpu")
    assert not row["ok"] and row["races"] == 0 and findings == []
    assert any("participants" in p for p in problems)


def test_sanitizer_callback_rides_along_strict(stacks):
    tmodel, tfl, tds = stacks["t"]
    sanitizer = ScheduleSanitizerCallback()
    eng, _ = SCENARIOS["sync_ties"](tmodel, tfl, tds, sanitizer, "cpu")
    eng.run(time_mode="wall_clock")
    assert sanitizer.graph is not None and sanitizer.races == []
    assert len(sanitizer.certified) == len(
        sanitizer.graph.races(eng.aggregator.commutativity))


def test_permuter_restores_engine_configuration(stacks):
    tmodel, tfl, tds = stacks["t"]
    eng, kw = SCENARIOS["sync_ties"](tmodel, tfl, tds,
                                     ScheduleSanitizerCallback(strict=False),
                                     "cpu")
    strategy, factory = eng.strategy, eng.event_queue_factory
    kw["permutations"] = 1
    report = SchedulePermuter(eng, run_kwargs={"time_mode": "wall_clock"},
                              **kw).run()
    assert report.ok()
    assert eng.strategy is strategy and eng.event_queue_factory is factory


def test_cli_sched_gate_on_the_cpu(capsys):
    """``python -m repro_torch.analysis --sched --device cpu``: every
    scenario ok, the reference gate's swap counts."""
    import json
    assert cli_main(["--root", REPO, "--sched", "--device", "cpu",
                     "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    rows = {r["scenario"]: r for r in payload["sched"]["scenarios"]}
    assert payload["sched"]["problems"] == []
    assert set(rows) == set(SCENARIOS)
    for row in rows.values():
        assert row["ok"] and row["races"] == 0 and row["total_swapped"] > 0
    assert [rows[n]["permutations"] for n in SCENARIOS] == [4, 4, 8]
