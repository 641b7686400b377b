"""One CAFL-L client round of the port against the reference (the slice
as a whole): ``train_client`` from bridged params for two clients at
q in {0, 1, 2} and with ``wire_topk = 32``, then aggregation, the
usage -> dual update -> next knobs step, and the eval loss.

Exact: params_active, wire_mb_actual, usages, the next round's duals and
knobs (host float arithmetic on equal inputs), and ``finalize_delta`` on
the same NumPy weights (the wire kernels' plain versions equal the
reference bit for bit). Within tolerance: losses (fp32 with another sum
order: 1e-5 relative) and the trained deltas. A delta is an AdamW walk
of s=2 steps at lr=1e-3, and AdamW normalises each step by the gradient's
own size, so where a gradient is at fp32 noise level (|g| near eps) the
step's sign is noise and the two packages may part by up to lr per step.
So at least 99% of each leaf's coordinates must agree within 1e-6 (fp32
rounding of p + u), and every coordinate within lr * s plus one
quantization step of its block (the wire format may move a code by one
step). Measured on this setup: at most 32 of 6912 coordinates of one
leaf beyond 1e-7, the largest 8.2e-5 apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params, tiny_setup  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import duals as jduals  # noqa: E402
from repro.core.client import ClientRunner as JRunner  # noqa: E402
from repro.core.client import finalize_delta as j_finalize  # noqa: E402
from repro.core.freezing import count_params as j_count_params  # noqa: E402
from repro.core.freezing import mask_tree as j_mask_tree  # noqa: E402
from repro.core.policy import Knobs as JKnobs  # noqa: E402
from repro.core.policy import policy as jpolicy  # noqa: E402
from repro.core.resources import calibrate as jcalibrate  # noqa: E402
from repro.core.server import make_eval_fn as j_make_eval_fn  # noqa: E402
from repro.data import FederatedData as JData  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.core import aggregation as tagg  # noqa: E402
from repro_torch.core import duals as tduals  # noqa: E402
from repro_torch.core.client import ClientRunner as TRunner  # noqa: E402
from repro_torch.core.client import finalize_delta as t_finalize  # noqa: E402
from repro_torch.core.freezing import count_params as t_count_params  # noqa: E402
from repro_torch.core.freezing import mask_tree as t_mask_tree  # noqa: E402
from repro_torch.core.policy import Knobs as TKnobs  # noqa: E402
from repro_torch.core.policy import policy as tpolicy  # noqa: E402
from repro_torch.core.resources import calibrate as tcalibrate  # noqa: E402
from repro_torch.core.server import make_eval_fn as t_make_eval_fn  # noqa: E402
from repro_torch.data import FederatedData as TData  # noqa: E402
from repro_torch.data import load_corpus as t_load_corpus  # noqa: E402
from repro_torch.models import build as tbuild  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.convert import unflatten  # noqa: E402

LOSS_RTOL = 1e-5
#: coordinates of a delta that count as agreeing (fp32 rounding of p + u)
DELTA_ATOL = 1e-6
#: share of a leaf's coordinates allowed beyond DELTA_ATOL
NOISY_SHARE = 0.01
STEPS = 2
CLIENTS = (0, 3)
#: (k, q, wire_topk): unfrozen layers of 3, compression level, top-k
CASES = [(3, 0, None), (2, 1, None), (2, 2, None), (2, 2, 32)]


@pytest.fixture(scope="module")
def setup():
    ds, jcfg, jfl, tcfg, tfl = tiny_setup()
    jp_np = jax_params(jcfg)
    return dict(ds=ds, tds=t_load_corpus(target_bytes=60_000), jcfg=jcfg,
                jfl=jfl, tcfg=tcfg, tfl=tfl, jp_np=jp_np,
                jp=jax.tree.map(jnp.asarray, jp_np),
                tp=params_from_numpy(jp_np, device="cpu").params(),
                jmodel=jbuild(jcfg), tmodel=tbuild(tcfg))


def _step_sizes(delta_np, q, block=256):
    """Per-coordinate quantization step (absmax / (L-1) of its block);
    zero at q=0."""
    if q == 0:
        return np.zeros_like(delta_np)
    bits = 8 if q == 1 else 2
    flat = delta_np.reshape(-1)
    pad = (-flat.size) % block
    blocks = np.pad(flat, (0, pad)).reshape(-1, block)
    step = np.abs(blocks).max(axis=1) / (2 ** (bits - 1) - 1)
    return np.repeat(step, block)[:flat.size].reshape(delta_np.shape)


def _check_delta(name, got, want, q, lr):
    diff = np.abs(got - want)
    assert np.all(diff <= lr * STEPS + _step_sizes(want, q) * (1 + 1e-3)), \
        (name, float(diff.max()))
    noisy = np.count_nonzero(diff > DELTA_ATOL)
    assert noisy <= NOISY_SHARE * want.size, (name, noisy, want.size)


@pytest.mark.parametrize("k,q,topk", CASES)
def test_client_round_matches_reference(setup, k, q, topk):
    S = setup
    jfl = S["jfl"].replace(wire_topk=topk)
    tfl = S["tfl"].replace(wire_topk=topk)
    n = j_count_params(S["jp"])
    assert t_count_params(S["tp"]) == n
    jres, tres = jcalibrate(n, jfl), tcalibrate(n, tfl)
    jrun = JRunner(S["jmodel"], jfl, JData(S["ds"].train, jfl.num_clients,
                                           seed=jfl.seed), jres)
    trun = TRunner(S["tmodel"], tfl, TData(S["tds"].train, tfl.num_clients,
                                           seed=tfl.seed), tres, device="cpu")
    kn = (k, STEPS, 8, q, 2)                # k, s, b, q, grad_accum
    jouts = [jrun.train_client(c, S["jp"], JKnobs(*kn)) for c in CLIENTS]
    touts = [trun.train_client(c, S["tp"], TKnobs(*kn)) for c in CLIENTS]

    for jo, to in zip(jouts, touts):
        assert to.params_active == jo.params_active
        assert to.wire_mb_actual == jo.wire_mb_actual
        assert to.train_loss == pytest.approx(jo.train_loss, rel=LOSS_RTOL)
        for name, jd in flat_paths(jo.delta).items():
            _check_delta(name, to.delta[name].numpy(), np.asarray(jd), q,
                         jfl.lr)

    # the server side of the round: mean delta, new params, duals, knobs
    jmean = flat_paths(jagg.aggregate([o.delta for o in jouts]))
    tmean = tagg.aggregate([o.delta for o in touts])
    for name, want in jmean.items():
        _check_delta(name, tmean[name].numpy(), np.asarray(want), q, jfl.lr)
    jnew = flat_paths(jagg.apply_delta(S["jp"], unflatten(
        {n: jnp.asarray(t.numpy()) for n, t in tmean.items()})))
    tnew = tagg.apply_delta(S["tp"], tmean)
    for name, want in jnew.items():
        np.testing.assert_array_equal(tnew[name].numpy(), np.asarray(want))
    jus = [jres.usage(o.params_active, JKnobs(*kn)) for o in jouts]
    tus = [tres.usage(o.params_active, TKnobs(*kn)) for o in touts]
    assert tus == jus
    jmu = {r: sum(u[r] for u in jus) / len(jus) for r in jduals.RESOURCES}
    tmu = {r: sum(u[r] for u in tus) / len(tus) for r in tduals.RESOURCES}
    jd = jduals.dual_update(jduals.DualState(), jmu, jfl.budgets, jfl.duals)
    td = tduals.dual_update(tduals.DualState(), tmu, tfl.budgets, tfl.duals)
    assert td.lam == jd.lam
    assert tpolicy(td, tfl).as_dict() == jpolicy(jd, jfl).as_dict()


def test_eval_loss_matches_reference(setup):
    S = setup
    jval = j_make_eval_fn(S["jmodel"], S["ds"], S["jfl"])(S["jp"])
    tval = t_make_eval_fn(S["tmodel"], S["tds"], S["tfl"], device="cpu")(
        S["tp"])
    assert tval == pytest.approx(jval, rel=LOSS_RTOL)


@pytest.mark.parametrize("q,topk", [(0, None), (1, None), (2, None), (1, 32),
                                    (2, 64), (2, 256)])
def test_finalize_delta_bit_for_bit(setup, q, topk):
    """The same NumPy weights through both packages' finalize_delta: the
    fp32 difference, the wire round trip of each leaf, and the mask."""
    S = setup
    rng = np.random.default_rng(q * 100 + (topk or 0))
    w_np = {name: (leaf + rng.normal(size=leaf.shape) * 1e-3
                   ).astype(np.float32)
            for name, leaf in flat_paths(S["jp_np"]).items()}
    jw = jax.tree.map(jnp.asarray, unflatten(w_np))
    tw = {name: torch.from_numpy(a) for name, a in w_np.items()}
    jm = j_mask_tree(S["jp"], S["jcfg"], 2)
    tm = t_mask_tree(S["tp"], S["tcfg"], 2)
    jd = flat_paths(j_finalize(jw, S["jp"], jm, q, topk=topk))
    td = t_finalize(tw, S["tp"], tm, q, topk=topk)
    assert list(td) == list(jd)
    for name, want in jd.items():
        got = td[name].numpy()
        want = np.asarray(want)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
