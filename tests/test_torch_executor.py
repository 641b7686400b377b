"""The port's batched executor against the reference's batched executor
and against the port's sequential one: the engine for 3 rounds of
``fedavg`` and ``cafl``, one mixed-knob round of the executor itself
(the port of ``tests/test_fl_engine.py::test_batched_groups_mixed_knobs``),
and the dispatch of attention inside the vmapped step.

Tolerances:
- exact: knobs, participants, ``params_active``, usage and the result
  order (host arithmetic and the assignment order);
- against the reference's batched engine: the engine bounds of
  ``torch_tiny.assert_histories_match`` (losses and wire MB 5e-3);
- against the port's sequential executor: the reference's own 2e-3 on
  val and train loss and 1e-4 relative on wire MB
  (``tests/test_fl_engine.py::test_sequential_and_batched_histories_match``);
  measured equal on the CPU;
- the mixed-knob round's losses against the reference: 1e-5 relative
  (``tests/test_torch_client.py``'s bound for one client round); its
  deltas against the port's sequential executor: 1e-6 (measured equal
  on the CPU).

The ``cuda`` test holds the two executors to each other on the card at
the same 2e-3, under deterministic algorithms, with equal kernel launch
counts.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BATCHED_ATOL = 2e-3
WIRE_RTOL = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    pytest.importorskip("jax")
    from torch_tiny import tiny_pair
    return tiny_pair()


def _port_engine(setup, method, executor, **kw):
    from repro_torch.fl import FederatedEngine
    from repro_torch.models import build, params_from_numpy
    engine = FederatedEngine(build(setup["tcfg"]), setup["tfl"],
                             setup["tds"], strategy=method,
                             executor=executor, device="cpu", **kw)
    return engine.run(init_params=params_from_numpy(setup["p"], "cpu"))


def _assert_executors_agree(seq, bat):
    assert len(seq.history) == len(bat.history)
    for a, b in zip(seq.history, bat.history):
        assert a.knobs == b.knobs and a.participants == b.participants
        assert a.val_loss == pytest.approx(b.val_loss, abs=BATCHED_ATOL)
        assert a.train_loss == pytest.approx(b.train_loss, abs=BATCHED_ATOL)
        assert a.usage == b.usage
        assert a.wire_mb_actual == pytest.approx(b.wire_mb_actual,
                                                 rel=WIRE_RTOL)


@pytest.mark.parametrize("method", ["fedavg", "cafl"])
def test_batched_matches_reference_batched(setup, method):
    from torch_tiny import assert_histories_match, run_pair
    (_, jres), (eng, tres) = run_pair(
        setup, lambda mod, fl: dict(executor="batched"), strategy=method)
    from repro_torch.fl import BatchedExecutor
    assert isinstance(eng._runner_cache[1], BatchedExecutor)
    assert_histories_match(jres, tres)
    if method == "cafl":
        assert tres.history[-1].knobs != tres.history[0].knobs


@pytest.mark.parametrize("method", ["fedavg", "cafl"])
def test_batched_matches_sequential(setup, method):
    _assert_executors_agree(_port_engine(setup, method, "sequential"),
                            _port_engine(setup, method, "batched"))


def test_executor_from_the_config(setup):
    """``fl.executor`` picks the executor when the engine is not told."""
    from repro_torch.fl import BatchedExecutor, FederatedEngine
    from repro_torch.models import build
    eng = FederatedEngine(build(setup["tcfg"]),
                          setup["tfl"].replace(executor="batched"),
                          setup["tds"], strategy="fedavg", device="cpu")
    eng.run(rounds=1)
    assert isinstance(eng._runner_cache[1], BatchedExecutor)


def _runners(setup):
    """The reference's and the port's ClientRunner on the tiny setting,
    with the JAX params and their bridged copy."""
    import jax
    import jax.numpy as jnp
    from repro.core.client import ClientRunner as JRunner
    from repro.core.freezing import count_params as j_count
    from repro.core.resources import calibrate as jcal
    from repro.data import FederatedData as JData
    from repro.models import build as jbuild
    from repro_torch.core.client import ClientRunner as TRunner
    from repro_torch.core.resources import calibrate as tcal
    from repro_torch.data import FederatedData as TData
    from repro_torch.models import build as tbuild
    from repro_torch.models import params_from_numpy
    s = setup
    jp = jax.tree.map(jnp.asarray, s["p"])
    n = j_count(jp)
    jr = JRunner(jbuild(s["jcfg"]), s["jfl"],
                 JData(s["ds"].train, s["jfl"].num_clients,
                       seed=s["jfl"].seed), jcal(n, s["jfl"]))
    tr = TRunner(tbuild(s["tcfg"]), s["tfl"],
                 TData(s["tds"].train, s["tfl"].num_clients,
                       seed=s["tfl"].seed), tcal(n, s["tfl"]), device="cpu")
    return jr, jp, tr, params_from_numpy(s["p"], "cpu").params()


def _mixed(fl_mod, knobs_cls, budgets, resources):
    profile = fl_mod.DeviceProfile("default", budgets, resources=resources)
    kn_a = knobs_cls(k=2, s=2, b=4, q=0, grad_accum=1)
    kn_b = knobs_cls(k=1, s=2, b=4, q=2, grad_accum=2)
    return [(fl_mod.ClientInfo(0, profile, 1), kn_a),
            (fl_mod.ClientInfo(1, profile, 1), kn_b),
            (fl_mod.ClientInfo(2, profile, 1), kn_a),
            (fl_mod.ClientInfo(3, profile, 1),
             knobs_cls(k=3, s=1, b=4, q=1, grad_accum=3))]


def test_batched_groups_mixed_knobs(setup):
    """Clients with different knobs land in different groups, yet the
    results come back in assignment order and match the reference's
    batched executor and the port's sequential one client for client."""
    import repro.fl as J
    import repro_torch.fl as T
    from repro.core.policy import Knobs as JKnobs
    from repro_torch.core.policy import Knobs as TKnobs
    jr, jp, tr, tp = _runners(setup)
    jouts = J.make_executor("batched", jr).run_round(
        jp, _mixed(J, JKnobs, setup["jfl"].budgets, jr.resources))
    touts = T.make_executor("batched", tr).run_round(
        tp, _mixed(T, TKnobs, setup["tfl"].budgets, tr.resources))
    assert [o.client_id for o in touts] == [0, 1, 2, 3]
    assert touts[0].params_active == touts[2].params_active
    assert touts[1].params_active < touts[0].params_active
    for j, t in zip(jouts, touts):
        assert t.client_id == j.client_id
        assert t.params_active == j.params_active
        assert t.wire_mb_actual == j.wire_mb_actual
        assert t.train_loss == pytest.approx(j.train_loss, rel=LOSS_RTOL)
    # the port's sequential executor on fresh batch streams: the same
    # clients, the same batches, the same update arithmetic
    _, _, tr2, _ = _runners(setup)
    souts = T.make_executor("sequential", tr2).run_round(
        tp, _mixed(T, TKnobs, setup["tfl"].budgets, tr2.resources))
    for s, t in zip(souts, touts):
        assert (s.client_id, s.params_active, s.wire_mb_actual) == \
            (t.client_id, t.params_active, t.wire_mb_actual)
        assert s.train_loss == pytest.approx(t.train_loss, abs=BATCHED_ATOL)
        for k in s.delta:
            np.testing.assert_allclose(t.delta[k].numpy(),
                                       s.delta[k].numpy(), atol=1e-6)


def test_vmapped_step_takes_the_dense_attention(setup, monkeypatch):
    """Inside ``vmap(grad_and_value(loss))`` gradients are on, so
    attention takes the dense branch: a batched round calls the flash
    dispatch (``ops.flash_attention``, the CPU twin here) zero times,
    while the engine's no-grad eval still calls it."""
    import repro_torch.fl as T
    from repro_torch.core.policy import Knobs
    from repro_torch.kernels import ops
    calls = []
    real = ops.flash_attention

    def counting(q, *a, **kw):
        calls.append(torch._C._functorch.is_batchedtensor(q))
        return real(q, *a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    _, _, tr, tp = _runners(setup)
    outs = T.make_executor("batched", tr).run_round(
        tp, _mixed(T, Knobs, setup["tfl"].budgets, tr.resources))
    assert len(outs) == 4 and calls == []
    _port_engine(setup, "fedavg", "batched")
    n_layers = setup["tcfg"].num_layers
    assert calls and not any(calls)
    assert len(calls) % n_layers == 0


def test_make_executor_resolution():
    from repro_torch.fl.executor import EXECUTORS, make_executor
    assert sorted(EXECUTORS) == ["batched", "sequential"]
    with pytest.raises(ValueError):
        make_executor("warp", None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["fedavg", "cafl"])
def test_batched_matches_sequential_on_the_card(card, method):
    """Both executors on the card at the tiny size under deterministic
    algorithms: the same knobs and participants, losses within 2e-3,
    and the same launches of every kernel (one wire round trip per
    delta, the flash kernel in the eval only) but the optimizer's: the
    sequential client's in-place AdamW launches the fused kernel, the
    batched executor's vmapped functional update does not."""
    from repro_torch.configs.charlm_shakespeare import CONFIG, FL
    from repro_torch.data import load_corpus
    from repro_torch.fl import FederatedEngine
    from repro_torch.kernels import ops
    from repro_torch.models import build
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ds = load_corpus(target_bytes=60_000)
    cfg = CONFIG.replace(vocab_size=max(ds.vocab_size, 64), num_layers=3,
                         d_model=48, num_heads=4, num_kv_heads=4,
                         head_dim=12, d_ff=96)
    fl = FL.replace(num_clients=4, clients_per_round=2, s_base=3, b_base=8,
                    seq_len=16, eval_batches=1, eval_batch_size=8, rounds=3)
    runs, launches = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for executor in ("sequential", "batched"):
            ops.reset_launches()
            runs[executor] = FederatedEngine(
                build(cfg), fl, ds, strategy=method, executor=executor,
                device=card).run()
            torch.cuda.synchronize()
            launches[executor] = dict(ops.LAUNCHES)
    finally:
        torch.use_deterministic_algorithms(False)
    _assert_executors_agree(runs["sequential"], runs["batched"])
    optim_seq = launches["sequential"].pop("adamw_update")
    assert optim_seq > 0 and launches["batched"].pop("adamw_update") == 0
    assert launches["batched"] == launches["sequential"]
    assert launches["batched"]["flash_attention_bhsd"] == \
        (fl.rounds + 1) * fl.eval_batches * cfg.num_layers
