"""The port's federated engine against the reference's (the slice as a
whole): ``FederatedEngine.run`` for 3 rounds of ``fedavg`` and ``cafl``
with the sync aggregator, and of ``cafl`` with ``aggregator="masked"``,
in both packages from the same JAX-initialised parameters, on the CPU.

Tolerances (ROADMAP queue 1 item 5):
- exact: knobs, participants, dropped, availability and update counts
  (the sampling stream is the same ``default_rng(fl.seed)`` calls, the
  knob policy the same host arithmetic);
- duals within 1e-9 and usage within 1e-6 relative (host float
  arithmetic on equal inputs; measured equal);
- losses and wire MB within 5e-3 (fp32 training with another sum order,
  the reference's own cross-BLAS bound for its golden trajectories;
  measured at most 2.7e-6 apart).

Then the port alone: masked against sync within the reference's own
bounds (1e-6 train loss, 2e-3 val loss), the entry points
(``run_federated``, ``launch.train.main``) writing history and
checkpoint, the pieces earlier slices refused now building and running,
and the recurrent and encoder-decoder model configs resolving.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import jax_params, tiny_setup  # noqa: E402

from repro.fl import FederatedEngine as JEngine  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import checkpointing  # noqa: E402
from repro_torch.core.server import run_federated  # noqa: E402
from repro_torch.data import load_corpus as t_load_corpus  # noqa: E402
from repro_torch.fl import FederatedEngine as TEngine  # noqa: E402
from repro_torch.fl import (MaskedSumAggregator, make_constraints,  # noqa: E402
                            make_controller, make_knob_policy)
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

ROUNDS = 3
DUAL_ATOL = 1e-9
USAGE_RTOL = 1e-6
LOSS_ATOL = 5e-3
#: masked against sync, the reference's own bounds
#: (tests/test_fl_aggregator.py::test_engine_masked_matches_sync)
MASKED_TRAIN_ATOL = 1e-6
MASKED_VAL_ATOL = 2e-3


@pytest.fixture(scope="module")
def setup():
    ds, jcfg, jfl, tcfg, tfl = tiny_setup()
    return dict(ds=ds, tds=t_load_corpus(target_bytes=60_000), jcfg=jcfg,
                jfl=jfl.replace(rounds=ROUNDS), tcfg=tcfg,
                tfl=tfl.replace(rounds=ROUNDS), p=jax_params(jcfg))


def _port_run(setup, method, aggregator="sync", **kw):
    engine = TEngine(tbuild(setup["tcfg"]), setup["tfl"], setup["tds"],
                     strategy=method, aggregator=aggregator, device="cpu",
                     **kw)
    return engine.run(init_params=params_from_numpy(setup["p"], "cpu"))


@pytest.mark.parametrize("method,aggregator", [
    ("fedavg", "sync"), ("cafl", "sync"), ("cafl", "masked")])
def test_engine_matches_reference(setup, method, aggregator):
    jres = JEngine(jbuild(setup["jcfg"]), setup["jfl"], setup["ds"],
                   strategy=method, aggregator=aggregator).run(
        init_params=jax.tree.map(jnp.asarray, setup["p"]))
    tres = _port_run(setup, method, aggregator)
    assert tres.method == jres.method
    assert len(tres.history) == len(jres.history) == ROUNDS
    for j, t in zip(jres.history, tres.history):
        assert t.round == j.round
        assert t.knobs == j.knobs, f"round {j.round}: knobs"
        assert t.participants == j.participants
        assert t.dropped == j.dropped
        assert t.num_available == j.num_available
        assert (t.updates_applied, t.reports_applied) == \
            (j.updates_applied, j.reports_applied)
        assert t.duals.keys() == j.duals.keys()
        for name, lam in j.duals.items():
            assert t.duals[name] == pytest.approx(lam, abs=DUAL_ATOL)
        for name, u in j.usage.items():
            assert t.usage[name] == pytest.approx(u, rel=USAGE_RTOL)
            assert t.ratios[name] == pytest.approx(j.ratios[name],
                                                   rel=USAGE_RTOL)
        assert t.constraints.keys() == j.constraints.keys()
        assert t.sim_time == j.sim_time
        for field in ("val_loss", "train_loss", "wire_mb_actual",
                      "energy_true"):
            assert getattr(t, field) == pytest.approx(
                getattr(j, field), abs=LOSS_ATOL, rel=USAGE_RTOL
                if field == "energy_true" else 0), field
    # the CAFL-L run moves the duals and, through them, the knobs
    if method == "cafl":
        assert tres.history[-1].knobs != tres.history[0].knobs


@pytest.mark.parametrize("strategy,masked", [
    ("fedavg", dict()), ("fedavg_weighted", dict(use_weights=True))])
def test_masked_matches_sync(setup, strategy, masked):
    """Swapping the barrier for the secure-aggregation simulation changes
    only how securely the mean is computed."""
    sync = _port_run(setup, strategy, "sync")
    sec = _port_run(setup, strategy, MaskedSumAggregator(**masked))
    for a, b in zip(sync.history, sec.history):
        assert a.participants == b.participants
        assert a.train_loss == pytest.approx(b.train_loss,
                                             abs=MASKED_TRAIN_ATOL)
        assert a.val_loss == pytest.approx(b.val_loss, abs=MASKED_VAL_ATOL)


def test_engine_initialises_from_the_seed(setup):
    """Without ``init_params`` the engine draws fresh weights from
    ``fl.seed``: two engines agree, and the eval starts near log(vocab).
    (One engine run twice continues its clients' batch streams.)"""
    a, b = (TEngine(tbuild(setup["tcfg"]), setup["tfl"], setup["tds"],
                    strategy="fedavg", device="cpu").run(rounds=1)
            for _ in range(2))
    for k, v in a.final_params.items():
        assert torch.equal(v, b.final_params[k]), k
    assert a.history[0].val_loss == pytest.approx(
        np.log(setup["tcfg"].vocab_size), rel=0.2)


def test_run_federated_logs_and_returns_history(setup):
    lines = []
    res = run_federated(tbuild(setup["tcfg"]), setup["tfl"], setup["tds"],
                        method="cafl", rounds=2, log=lines.append,
                        init_params=params_from_numpy(setup["p"], "cpu"),
                        device="cpu")
    assert [r.round for r in res.history] == [1, 2]
    assert len(lines) == 2 and lines[0].startswith("[cafl] round   1")
    assert all(np.isfinite(r.val_loss) for r in res.history)


def test_train_main_writes_history_and_checkpoint(setup, tmp_path,
                                                  monkeypatch):
    """``launch.train.main`` on the CPU, at the tiny size (the registry
    lookups are swapped for the tiny configs)."""
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_config", lambda arch: setup["tcfg"])
    monkeypatch.setattr(train, "get_fl_config", lambda: setup["tfl"])
    monkeypatch.setattr(train, "load_corpus", lambda: setup["tds"])
    out = str(tmp_path / "run" / "fl")
    results = train.main(["--device", "cpu", "--method", "both",
                          "--rounds", "2", "--out", out, "--quiet"])
    assert list(results) == ["fedavg", "cafl"]
    for method, res in results.items():
        with open(f"{out}_{method}.json") as f:
            payload = json.load(f)
        assert payload["method"] == method
        assert [r["round"] for r in payload["history"]] == [1, 2]
        assert payload["history"][-1]["val_loss"] == res.history[-1].val_loss
        back = checkpointing.load(f"{out}_{method}.ckpt", res.final_params)
        assert list(back) == list(res.final_params)
        for k, v in res.final_params.items():
            assert torch.equal(back[k], v), k


def test_clock_matches_reference():
    """``SimClock`` and ``KnobRoundTime`` against the reference's on the
    same event script; all comparisons exact (host float arithmetic in
    the same order)."""
    from repro.configs import get_fl_config as j_fl
    from repro.core.policy import Knobs as JKnobs
    from repro.fl import clock as jclock
    from repro.fl import ClientInfo as JCI, DeviceProfile as JDP
    from repro_torch.configs.charlm_shakespeare import FL
    from repro_torch.core.policy import Knobs
    from repro_torch.fl import clock as tclock
    from repro_torch.fl import ClientInfo, DeviceProfile

    rng = np.random.default_rng(3)
    script = [(float(t), int(c)) for t, c in
              zip(rng.uniform(0, 5, 12).round(1), rng.integers(0, 4, 12))]
    knobs = [(6, 40, 32, 0, 1), (4, 35, 31, 2, 2), (2, 12, 8, 1, 3)]
    logs = []
    for clock, fl, KN, CI, DP in (
            (jclock, j_fl(), JKnobs, JCI, JDP),
            (tclock, FL, Knobs, ClientInfo, DeviceProfile)):
        sim = clock.SimClock(max_events=4)
        for t, _ in script:
            sim.advance_to(t, "e")
        sim.advance(0.25, "step")
        rtm = clock.make_round_time(None, fl)
        cohort = [CI(i, DP("d", fl.budgets, compute_scale=1 + i / 2))
                  for i in range(3)]
        kns = [KN(k=k, s=s, b=b, q=q, grad_accum=g) for k, s, b, q, g in knobs]
        logs.append((sim.now, sim.events, sim.event_count,
                     [rtm.client_seconds(ci, kn)
                      for ci, kn in zip(cohort, kns)],
                     rtm.round_seconds(cohort, kns, [], [0, 1, 2], None),
                     rtm.round_seconds(cohort, kns, [0.5, 2.0, 9.0], [0, 1],
                                       3.0),
                     rtm.round_seconds([], [], [], [], None)))
    assert logs[0] == logs[1]
    with pytest.raises(ValueError, match="negative"):
        tclock.SimClock().advance(-1.0)


def _one_round(setup, **kw):
    engine = TEngine(tbuild(setup["tcfg"]), setup["tfl"], setup["tds"],
                     device="cpu", **kw)
    res = engine.run(rounds=1,
                     init_params=params_from_numpy(setup["p"], "cpu"))
    assert len(res.history) == 1 and np.isfinite(res.history[0].val_loss)
    return engine, res


def _built_fedbuff(setup):
    engine, res = _one_round(setup, aggregator="fedbuff")
    # a cohort of 2 fills FedBuff's default buffer of 2 once, mid-round
    assert engine.aggregator.name == "fedbuff"
    assert (res.history[0].updates_applied,
            res.history[0].reports_applied) == (1, 2)


def _built_server_opt(method, name, inner):
    def check(setup):
        engine, res = _one_round(setup, strategy=method)
        assert res.method == engine.strategy.name == name
        assert type(engine.strategy.inner).__name__ == inner
    return check


def _built_batched(setup):
    from repro_torch.fl import BatchedExecutor
    engine, res = _one_round(setup, executor="batched")
    assert isinstance(engine._runner_cache[1], BatchedExecutor)
    assert res.history[0].participants


def _built_wire_mb(setup):
    assert make_constraints("paper+wire_mb").names[-1] == "wire_mb"


def _built_pi(setup):
    from repro_torch.fl import PIController
    assert isinstance(make_controller("pi"), PIController)


def _built_deadline_aware(setup):
    from repro_torch.fl import DeadlineAwareKnobPolicy
    assert isinstance(make_knob_policy("deadline_aware"),
                      DeadlineAwareKnobPolicy)


@pytest.mark.parametrize("check", [
    _built_fedbuff, _built_server_opt("fedadam", "fedavg+adam", "FedAvg"),
    _built_server_opt("fedavg+adam", "fedavg+adam", "FedAvg"),
    _built_server_opt("cafl+momentum", "cafl+momentum", "CAFLL"),
    _built_batched,
    _built_wire_mb, _built_pi, _built_deadline_aware,
], ids=["fedbuff", "fedadam", "server_opt", "cafl+momentum", "batched",
        "wire_mb", "pi", "deadline_aware"])
def test_unported_pieces_raise(setup, check):
    """Each piece the earlier slices refused (with ``NotImplementedError``
    naming its ROADMAP queue) now builds, and the engine ones run one
    round on the CPU."""
    check(setup)


def _train(setup, monkeypatch, tmp, *argv):
    from repro_torch.launch import train
    monkeypatch.setattr(train, "get_config", lambda arch: setup["tcfg"])
    monkeypatch.setattr(train, "get_fl_config", lambda: setup["tfl"])
    monkeypatch.setattr(train, "load_corpus", lambda: setup["tds"])
    return train.main(["--device", "cpu", "--rounds", "1", "--quiet",
                       "--out", str(tmp / "fl"), *argv])


def _entry_arch(setup, monkeypatch, tmp):
    from repro_torch.configs import get_config
    for arch in ("recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-medium"):
        assert get_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def _entry_stragglers(setup, monkeypatch, tmp):
    from repro_torch.fl import DeadlineStragglers, make_dynamics
    dyn = make_dynamics(setup["tfl"], stragglers="deadline")
    assert isinstance(dyn.stragglers, DeadlineStragglers)


def _entry_train_server_opt(setup, monkeypatch, tmp):
    results = _train(setup, monkeypatch, tmp, "--method", "cafl",
                     "--server-opt", "adam")
    assert results["cafl"].method == "cafl+adam"
    with open(tmp / "fl_cafl.json") as f:
        assert json.load(f)["method"] == "cafl+adam"


def _entry_train_batched(setup, monkeypatch, tmp):
    results = _train(setup, monkeypatch, tmp, "--method", "fedavg",
                     "--executor", "batched")
    assert len(results["fedavg"].history) == 1


@pytest.mark.parametrize("call", [
    _entry_arch, _entry_stragglers, _entry_train_server_opt,
    _entry_train_batched,
], ids=["arch", "stragglers", "train_server_opt", "train_batched"])
def test_unported_entry_points_raise(setup, call, tmp_path, monkeypatch):
    """The entry points the earlier slices refused now run: the model
    zoo's recurrent and encoder-decoder configs resolve (RecurrentGemma,
    xLSTM, SeamlessM4T; an unknown id raises ``KeyError``), deadline
    stragglers from ``make_dynamics``, and ``launch.train`` with
    ``--server-opt`` and ``--executor batched`` for one round on the CPU
    at the tiny size."""
    call(setup, monkeypatch, tmp_path)
