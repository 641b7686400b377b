"""The port's CAFL-L core against the reference.

Host-side accounting is compared with ``==``: masks, active-parameter
counts, knobs, token budgets, calibration constants, usages, duals
(including the 1.05 dead-band edge) and wire bytes are the same Python
and NumPy float arithmetic in the same order. Tensor arithmetic
(aggregation, the AdamW step) is fp32 on both sides, but XLA may fuse a
multiply-add into one rounding where PyTorch rounds twice, so it is held
to one or two fp32 ulps (rtol 1e-6).
"""
import importlib
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params, tiny_setup  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import duals as jduals  # noqa: E402
from repro.core import freezing as jfrz  # noqa: E402
from repro.core import resources as jres  # noqa: E402
from repro.core.client import _masked_wire_mb as j_masked_wire_mb  # noqa: E402
from repro.core.client import apply_masked_update as j_apply  # noqa: E402
from repro.optim import make_optimizer as jmake_opt  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import duals as tduals  # noqa: E402
from repro_torch.core import freezing as tfrz  # noqa: E402
from repro_torch.core import resources as tres  # noqa: E402
from repro_torch.core.client import _masked_wire_mb as t_masked_wire_mb  # noqa: E402
from repro_torch.core.client import apply_masked_update as t_apply  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.optim import make_optimizer as tmake_opt  # noqa: E402

RTOL = 1e-6
# the modules, not the ``policy`` functions their packages re-export
jpol = importlib.import_module("repro.core.policy")
tpol = importlib.import_module("repro_torch.core.policy")


@pytest.fixture(scope="module")
def setup():
    ds, jcfg, jfl, tcfg, tfl = tiny_setup()
    jp = jax_params(jcfg)
    tp = params_from_numpy(jp, device="cpu").params()
    return jcfg, jfl, tcfg, tfl, jax.tree.map(jnp.asarray, jp), tp


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_masks_and_active_counts_equal(setup, k):
    jcfg, _, tcfg, _, jp, tp = setup
    jm = jfrz.mask_tree(jp, jcfg, k)
    tm = tfrz.mask_tree(tp, tcfg, k)
    jflat = flat_paths(jm)
    assert list(tm) == list(jflat)
    for name, m in jflat.items():
        np.testing.assert_array_equal(tm[name].numpy(), np.asarray(m))
        assert tm[name].dtype == torch.float32
    assert tfrz.count_active(tp, tm) == jfrz.count_active(jp, jm)
    assert tfrz.count_params(tp) == jfrz.count_params(jp)
    for q, topk in itertools.product((0, 1, 2), (None, 32, 64, 256)):
        assert t_masked_wire_mb(tp, tm, q, topk) == \
            j_masked_wire_mb(jp, jm, q, topk)


def test_policy_and_token_budget_equal():
    _, jcfg, jfl, tcfg, tfl = tiny_setup()
    rng = np.random.default_rng(0)
    for lam in [np.zeros(4), [0.0, 0.25, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0],
                [0.97, 2.67, 0.067, 0.0]] + list(rng.uniform(0, 3, (40, 4))):
        lam = {r: float(v) for r, v in zip(jduals.RESOURCES, lam)}
        jk = jpol.policy(jduals.DualState(lam=dict(lam)), jfl)
        tk = tpol.policy(tduals.DualState(lam=dict(lam)), tfl)
        assert tk.as_dict() == jk.as_dict()
    assert tpol.fedavg_knobs(tfl).as_dict() == jpol.fedavg_knobs(jfl).as_dict()
    for mode, budget in itertools.product(("ceil", "clamped"), (True, False)):
        jf = jfl.replace(token_preservation=mode, token_budget=budget)
        tf = tfl.replace(token_preservation=mode, token_budget=budget)
        for s, b in itertools.product((1, 2, 3, 7), (1, 4, 5, 8, 9)):
            assert tpol.token_budget_accum(tf, s, b) == \
                jpol.token_budget_accum(jf, s, b)


def test_calibration_usage_and_duals_equal(setup):
    _, jfl, _, tfl, jp, tp = setup
    n = jfrz.count_params(jp)
    jr, tr = jres.calibrate(n, jfl), tres.calibrate(n, tfl)
    assert vars(tr) == vars(jr)
    for kn in [(3, 3, 8, 0, 1), (2, 2, 5, 1, 2), (1, 2, 4, 2, 3)]:
        jk, tk = jpol.Knobs(*kn), tpol.Knobs(*kn)
        for active in (float(n), 61234.5):
            for accum in (False, True):
                assert tr.usage(active, tk, accum) == \
                    jr.usage(active, jk, accum)
    usage = jr.usage(float(n), jpol.fedavg_knobs(jfl))
    jd, td = jduals.DualState(), tduals.DualState()
    for _ in range(4):
        jd = jduals.dual_update(jd, usage, jfl.budgets, jfl.duals)
        td = tduals.dual_update(td, usage, tfl.budgets, tfl.duals)
        assert td.lam == jd.lam
    assert tduals.lagrangian_value(2.5, usage, tfl.budgets, td) == \
        jduals.lagrangian_value(2.5, usage, jfl.budgets, jd)


@pytest.mark.parametrize("ratio", [0.95, 0.9500000001, 1.0, 1.05, 1.0499999,
                                   1.0500001, 1.5, 0.2])
def test_dead_band_edge_equal(ratio):
    """At usage/budget = 1.05, 1.05 - 1.0 = 0.050000000000000044 lies
    outside the 0.05 band: both packages move the dual there."""
    _, _, jfl, _, tfl = tiny_setup()
    assert tduals.deadzone(ratio, 0.05) == jduals.deadzone(ratio, 0.05)
    budgets = jfl.budgets
    usage = {"energy": budgets.energy * ratio, "comm": budgets.comm_mb * ratio,
             "memory": budgets.memory * ratio, "temp": budgets.temp * ratio}
    lam = {r: 0.3 for r in jduals.RESOURCES}
    jd = jduals.dual_update(jduals.DualState(lam=dict(lam)), usage,
                            jfl.budgets, jfl.duals)
    td = tduals.dual_update(tduals.DualState(lam=dict(lam)), usage,
                            tfl.budgets, tfl.duals)
    assert td.lam == jd.lam
    if ratio == 1.05:
        assert td.lam["comm"] != 0.3


@pytest.mark.parametrize("q,topk", [(0, None), (1, None), (2, None),
                                    (1, 32), (2, 64), (2, 256)])
def test_wire_bytes_equal(setup, q, topk):
    _, _, _, _, jp, tp = setup
    assert tcomp.wire_bytes(tp, q, topk=topk) == \
        jcomp.wire_bytes(jp, q, topk=topk)
    assert tcomp.wire_mb(tp, q, topk=topk) == jcomp.wire_mb(jp, q, topk=topk)


def test_aggregate_and_apply_delta_close(setup):
    _, _, _, _, jp, tp = setup
    rng = np.random.default_rng(1)
    deltas = [{n: (rng.normal(size=t.shape) * 1e-3).astype(np.float32)
               for n, t in tp.items()} for _ in range(3)]
    jdeltas = [jax.tree.map(jnp.asarray, _unflat(d)) for d in deltas]
    tdeltas = [{n: torch.from_numpy(a) for n, a in d.items()} for d in deltas]
    for weights in (None, [3.0, 1.0, 2.0]):
        jmean = flat_paths(jagg.aggregate(jdeltas, weights))
        tmean = tagg.aggregate(tdeltas, weights)
        assert tagg.normalize_weights(weights, 3) == \
            jagg.normalize_weights(weights, 3)
        for name, want in jmean.items():
            np.testing.assert_allclose(tmean[name].numpy(), want, rtol=RTOL,
                                       atol=1e-12)
    jnew = flat_paths(jagg.apply_delta(jp, jdeltas[0]))
    tnew = tagg.apply_delta(tp, tdeltas[0])
    for name, want in jnew.items():
        np.testing.assert_array_equal(tnew[name].numpy(), np.asarray(want))


def test_masked_adamw_step_close(setup):
    """One AdamW step under a freezing mask (k=2 of 3): frozen leaves stay
    exactly unchanged; the rest agree to an ulp or two, including the
    decayed stacked LayerNorm leaves (ndim >= 2)."""
    jcfg, jfl, tcfg, tfl, jp, tp = setup
    rng = np.random.default_rng(2)
    grads = {n: (rng.normal(size=t.shape) * 1e-2).astype(np.float32)
             for n, t in tp.items()}
    jopt = jmake_opt(jfl.optimizer, jfl.lr, jfl.weight_decay)
    topt = tmake_opt(tfl.optimizer, tfl.lr, tfl.weight_decay)
    jm, tm = jfrz.mask_tree(jp, jcfg, 2), tfrz.mask_tree(tp, tcfg, 2)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    jw, tw = jp, tp
    for _ in range(2):                                 # count 1, then 2
        jw, jstate = j_apply(jopt, jw, jstate,
                             jax.tree.map(jnp.asarray, _unflat(grads)), jm)
        tw, tstate = t_apply(topt, tw, tstate,
                             {n: torch.from_numpy(g) for n, g in grads.items()},
                             tm)
    assert int(tstate.count) == int(jstate.count) == 2
    jflat = flat_paths(jw)
    for name, want in jflat.items():
        want = np.asarray(want)
        got = tw[name].numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-9)
        if not np.asarray(flat_paths(jm)[name]).any():
            np.testing.assert_array_equal(got, tp[name].numpy())
    for name, want in flat_paths(jstate.mu).items():
        np.testing.assert_allclose(tstate.mu[name].numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-12)


def _unflat(flat):
    from repro_torch.models.convert import unflatten
    return unflatten(flat)
