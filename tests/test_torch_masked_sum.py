"""The port's masked-sum path against the reference, bit for bit, on the
CPU: the cohort fold's plain versions (``kernels.ref.masked_sum_ref`` on
limbs, ``kernels.ref.masked_sum_u64_ref`` on uint64 bits) and their
device dispatch (``kernels.ops``) against ``repro.kernels.ref``, the
reference's ``ops.masked_sum_u64`` and the Pallas kernel run in
interpret mode, the limb helpers and the cohort-size guard, the uint64
fold's freedom from any limb split, and ``MaskedSumAggregator`` (one
path: the buffered fold) against both of the reference's paths (its
per-arrival NumPy oracle and its kernel fold) under every dropout subset
of a 4-client cohort.

Every comparison is exact: the fold is integer arithmetic mod 2^64, and
the aggregator's fixed point, masks and mean are the reference's NumPy
operations in the reference's order. The Pallas grid takes only whole
512-column tiles, so it sees each input zero-padded and is compared on
the first n columns; n = 0 is held against the reference's plain path
alone.
"""
from itertools import combinations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_fl_config  # noqa: E402
from repro.core.policy import Knobs as JKnobs  # noqa: E402
from repro.fl import ClientInfo as JClientInfo  # noqa: E402
from repro.fl import ClientReport as JClientReport  # noqa: E402
from repro.fl import DeviceProfile as JDeviceProfile  # noqa: E402
from repro.fl import FedAvg as JFedAvg  # noqa: E402
from repro.fl import MaskedSumAggregator as JMasked  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import wire as jwire  # noqa: E402
from repro_torch.configs.charlm_shakespeare import FL  # noqa: E402
from repro_torch.core.policy import Knobs  # noqa: E402
from repro_torch.fl import (ClientInfo, ClientReport, DeviceProfile,  # noqa: E402
                            FedAvg, MaskedSumAggregator)
from repro_torch.kernels import ops, ref  # noqa: E402

COHORTS = [1, 2, 6, 17]
WIDTHS = [1, 511, 513, 1000]


def cohort_values(c, n, seed):
    """Random uint64 (c, n), with an all-ones row and an all-ones column
    so the carries ripple through every digit."""
    v = np.random.default_rng(seed).integers(0, 2 ** 64, size=(c, n),
                                             dtype=np.uint64)
    v[0, :] = np.uint64(2 ** 64 - 1)
    v[:, 0] = np.uint64(2 ** 64 - 1)
    return v


def pallas_sum(hi, lo):
    """The interpret-mode Pallas kernel on zero-padded columns."""
    n = hi.shape[1]
    pad = (-n) % jwire.LIMB_TILE
    hp = jnp.pad(jnp.asarray(hi), ((0, 0), (0, pad)))
    lp = jnp.pad(jnp.asarray(lo), ((0, 0), (0, pad)))
    h, l_ = jwire.masked_sum_limbs(hp, lp, interpret=True)
    return np.asarray(h)[:n], np.asarray(l_)[:n]


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("c", COHORTS)
def test_masked_sum_matches_reference_and_kernel(c, n):
    vals = cohort_values(c, n, seed=c * 1000 + n)
    hi, lo = ops.split_limbs(vals)
    jhi, jlo = jops.split_limbs(vals)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(lo, jlo)
    want_h, want_l = (np.asarray(x) for x in jref.masked_sum_ref(
        jnp.asarray(hi), jnp.asarray(lo)))
    kern_h, kern_l = pallas_sum(hi, lo)
    np.testing.assert_array_equal(kern_h, want_h)
    np.testing.assert_array_equal(kern_l, want_l)
    for got_h, got_l in (
            ref.masked_sum_ref(torch.from_numpy(hi), torch.from_numpy(lo)),
            ops.masked_sum(torch.from_numpy(hi), torch.from_numpy(lo)),
            # an int32 view of the same limbs
            ops.masked_sum(torch.from_numpy(hi.view(np.int32)),
                           torch.from_numpy(lo.view(np.int32))),
            ops.masked_sum(hi, lo, device="cpu")):
        got_h = got_h.view(torch.uint32).numpy()
        got_l = got_l.view(torch.uint32).numpy()
        np.testing.assert_array_equal(got_h, want_h)
        np.testing.assert_array_equal(got_l, want_l)
    total = ops.masked_sum_u64(vals, device="cpu")
    assert total.dtype == np.uint64
    np.testing.assert_array_equal(total, np.add.reduce(vals, axis=0))
    np.testing.assert_array_equal(total, jops.merge_limbs(want_h, want_l))


@pytest.mark.parametrize("c", COHORTS)
def test_masked_sum_empty_columns(c):
    vals = np.zeros((c, 0), np.uint64)
    hi, lo = ops.split_limbs(vals)
    want = jref.masked_sum_ref(jnp.asarray(hi), jnp.asarray(lo))
    got = ops.masked_sum(torch.from_numpy(hi), torch.from_numpy(lo))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape == (0,)
    assert ops.masked_sum_u64(vals, device="cpu").shape == (0,)


def reference_u64(vals, monkeypatch):
    """The reference's host-level fold on both of its CPU paths: its
    default (NumPy's uint64 reduce) and the Pallas limb kernel in
    interpret mode (``FORCE_BACKEND = "pallas"``); they must agree."""
    default = jops.masked_sum_u64(vals)
    with monkeypatch.context() as m:
        m.setattr(jops, "FORCE_BACKEND", "pallas")
        kernel = jops.masked_sum_u64(vals)
    np.testing.assert_array_equal(default, kernel)
    return default


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("c", COHORTS)
def test_masked_sum_u64_matches_reference(c, n, monkeypatch):
    """The uint64 fold's plain version and its CPU dispatch against the
    reference's fold and ``np.add.reduce``, bit for bit."""
    vals = cohort_values(c, n, seed=c * 3000 + n)
    want = np.add.reduce(vals, axis=0)
    np.testing.assert_array_equal(reference_u64(vals, monkeypatch), want)
    got = ref.masked_sum_u64_ref(torch.from_numpy(vals.view(np.int64)))
    assert got.dtype == torch.int64 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    total = ops.masked_sum_u64(vals, device="cpu")
    assert total.dtype == np.uint64
    np.testing.assert_array_equal(total, want)


@pytest.mark.parametrize("c", COHORTS)
def test_masked_sum_u64_wraps(c, monkeypatch):
    """All-ones values: every column's sum wraps past 2^64 (for c > 1)."""
    vals = np.full((c, 513), 2 ** 64 - 1, dtype=np.uint64)
    want = reference_u64(vals, monkeypatch)
    np.testing.assert_array_equal(want, np.full(513, -c % 2 ** 64,
                                                dtype=np.uint64))
    got = ref.masked_sum_u64_ref(torch.from_numpy(vals.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    np.testing.assert_array_equal(ops.masked_sum_u64(vals, device="cpu"),
                                  want)


@pytest.mark.parametrize("c", COHORTS)
def test_masked_sum_u64_empty_columns(c):
    vals = np.zeros((c, 0), np.uint64)
    assert jops.masked_sum_u64(vals).shape == (0,)
    got = ref.masked_sum_u64_ref(torch.from_numpy(vals.view(np.int64)))
    assert tuple(got.shape) == (0,) and got.dtype == torch.int64
    total = ops.masked_sum_u64(vals, device="cpu")
    assert total.shape == (0,) and total.dtype == np.uint64


def test_masked_fold_splits_no_limbs(monkeypatch):
    """``ops.masked_sum_u64`` and the aggregator's flush move the values
    as uint64 bits: no limb is split or merged on their path."""
    def refuse(*args, **kwargs):
        raise AssertionError("the uint64 fold split or merged limbs")

    monkeypatch.setattr(ops, "split_limbs", refuse)
    monkeypatch.setattr(ops, "merge_limbs", refuse)
    vals = cohort_values(6, 1000, seed=9)
    np.testing.assert_array_equal(ops.masked_sum_u64(vals, device="cpu"),
                                  np.add.reduce(vals, axis=0))
    shards, deltas = _cohort(seed=4)
    cohort = [ClientInfo(i, DeviceProfile("default", FL.budgets), s)
              for i, s in enumerate(shards)]
    agg = MaskedSumAggregator()
    agg.reset(FedAvg(FL).aggregate)
    agg.begin_round(1, cohort)
    for ci, delta in zip(cohort, deltas):
        agg.submit(ClientReport(
            client=ci, delta={k: torch.from_numpy(v.copy())
                              for k, v in delta.items()},
            weight=1.0, knobs=TKN, policy_knobs=TKN, round_trained=1))
    upd = agg.flush(1)
    for k in deltas[0]:
        plain = sum(d[k].astype(np.float64) for d in deltas) / len(deltas)
        np.testing.assert_allclose(upd.delta[k].numpy(), plain, rtol=0,
                                   atol=1e-6)


def test_masked_sum_u64_plain_version_refuses_bad_input():
    with pytest.raises(ValueError, match="int64"):
        ref.masked_sum_u64_ref(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="int64"):
        ref.masked_sum_u64_ref(torch.zeros((3,), dtype=torch.int64))
    with pytest.raises(ValueError, match="at most"):
        ref.masked_sum_u64_ref(torch.zeros(
            (ops.MASKED_SUM_MAX_CLIENTS + 1, 1), dtype=torch.int64))


def test_limb_round_trip():
    vals = cohort_values(3, 777, seed=5)
    vals[1, :4] = [0, 1, 2 ** 32 - 1, 2 ** 32]
    hi, lo = ops.split_limbs(vals)
    assert hi.dtype == lo.dtype == np.uint32
    np.testing.assert_array_equal(ops.merge_limbs(hi, lo), vals)
    np.testing.assert_array_equal(
        ops.merge_limbs(torch.from_numpy(hi).numpy(), lo),
        jops.merge_limbs(*jops.split_limbs(vals)))


def test_cohort_size_guard():
    """Both packages refuse more than 2^16 clients per fold."""
    assert ops.MASKED_SUM_MAX_CLIENTS == jops.MASKED_SUM_MAX_CLIENTS
    vals = np.zeros((ops.MASKED_SUM_MAX_CLIENTS + 1, 1), np.uint64)
    hi, lo = ops.split_limbs(vals)
    with pytest.raises(ValueError, match="at most"):
        ops.masked_sum(torch.from_numpy(hi), torch.from_numpy(lo))
    with pytest.raises(ValueError, match="at most"):
        ops.masked_sum_u64(vals, device="cpu")
    with pytest.raises(ValueError, match="at most"):
        jops.masked_sum_u64(vals)
    ok = np.ones((ops.MASKED_SUM_MAX_CLIENTS, 1), np.uint64)
    assert int(ops.masked_sum_u64(ok, device="cpu")[0]) == 1 << 16


def test_plain_version_refuses_bad_limbs():
    x = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="uint32 or int32"):
        ref.masked_sum_ref(x, x)
    with pytest.raises(ValueError, match="one shape"):
        ref.masked_sum_ref(torch.zeros((2, 3), dtype=torch.int32),
                           torch.zeros((2, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# MaskedSumAggregator against the reference's
# ---------------------------------------------------------------------------

JFL = get_fl_config()
JKN = JKnobs(k=2, s=4, b=8, q=0)
TKN = Knobs(k=2, s=4, b=8, q=0)


def _cohort(seed=0):
    rng = np.random.default_rng(seed)
    shards = [50 + 17 * i for i in range(4)]
    # nested-path names in JAX's leaf order after sorting ("a" < "b.c")
    deltas = [{"b.c": rng.normal(size=(5,)).astype(np.float32),
               "a": rng.normal(size=(3, 2)).astype(np.float32)}
              for _ in shards]
    return shards, deltas


def _reference_update(subset, shards, deltas, use_weights, path):
    cohort = [JClientInfo(i, JDeviceProfile("default", JFL.budgets), s)
              for i, s in enumerate(shards)]
    agg = JMasked(use_weights=use_weights, path=path)
    agg.reset(JFedAvg(JFL).aggregate)
    agg.begin_round(3, cohort)
    for i in subset:
        tree = {"a": jnp.asarray(deltas[i]["a"]),
                "b": {"c": jnp.asarray(deltas[i]["b.c"])}}
        agg.submit(JClientReport(client=cohort[i], delta=tree,
                                 weight=float(shards[i]), knobs=JKN,
                                 policy_knobs=JKN, round_trained=3))
    upd = agg.flush(3)
    return {"a": np.asarray(upd.delta["a"]),
            "b.c": np.asarray(upd.delta["b"]["c"])}


@pytest.mark.parametrize("use_weights", [True, False])
@pytest.mark.parametrize("path", ["numpy", "kernel"])
def test_masked_aggregator_matches_reference_under_every_dropout(path,
                                                                 use_weights):
    """``path`` is the reference's: the port's one fold is held to each."""
    shards, deltas = _cohort()
    cohort = [ClientInfo(i, DeviceProfile("default", FL.budgets), s)
              for i, s in enumerate(shards)]
    for n_rep in range(1, len(cohort) + 1):
        for subset in combinations(range(len(cohort)), n_rep):
            agg = MaskedSumAggregator(use_weights=use_weights)
            agg.reset(FedAvg(FL).aggregate)
            agg.begin_round(3, cohort)
            for i in subset:
                delta = {k: torch.from_numpy(v.copy())
                         for k, v in deltas[i].items()}
                assert agg.submit(ClientReport(
                    client=cohort[i], delta=delta, weight=float(shards[i]),
                    knobs=TKN, policy_knobs=TKN, round_trained=3)) is None
            upd = agg.flush(3)
            assert [r.client.client_id for r in upd.reports] == list(subset)
            want = _reference_update(subset, shards, deltas, use_weights,
                                     path)
            for k, w in want.items():
                got = upd.delta[k]
                assert got.device.type == "cpu" and got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                              w.view(np.uint32))
            # and the fixed point is a faithful mean of the reporters
            ws = [shards[i] if use_weights else 1.0 for i in subset]
            for k in want:
                plain = sum(w * deltas[i][k].astype(np.float64)
                            for w, i in zip(ws, subset)) / sum(ws)
                np.testing.assert_allclose(upd.delta[k].numpy(), plain,
                                           rtol=0, atol=1e-6)
            dropped = len(cohort) - n_rep
            assert agg.state_snapshot()["masks_reconstructed"] == \
                dropped * n_rep


def test_masked_aggregator_edges():
    cohort = [ClientInfo(i, DeviceProfile("default", FL.budgets))
              for i in range(2)]
    agg = MaskedSumAggregator()
    agg.reset(FedAvg(FL).aggregate)
    agg.begin_round(1, cohort)
    assert agg.flush(1) is None                 # everyone dropped
    agg.begin_round(2, cohort)
    stranger = ClientInfo(7, DeviceProfile("default", FL.budgets))
    with pytest.raises(ValueError, match="cohort"):
        agg.submit(ClientReport(client=stranger,
                                delta={"w": torch.ones(3)}, weight=1.0,
                                knobs=TKN, policy_knobs=TKN,
                                round_trained=2))
    with pytest.raises(ValueError, match="scale_bits"):
        MaskedSumAggregator(scale_bits=53)
    # a value past the int64 headroom of the fixed point is refused
    agg.begin_round(3, cohort)
    with pytest.raises(OverflowError, match="headroom"):
        agg.submit(ClientReport(client=cohort[0],
                                delta={"w": torch.full((2,), 3e9)},
                                weight=1.0, knobs=TKN, policy_knobs=TKN,
                                round_trained=3))
