"""The port's optimizers and server optimizers against the reference:
``sgd``, ``momentum``, ``adam``, ``adamw`` and ``adamw_bf16`` over a few
steps on the same parameters and gradients, and ``ServerOpt`` (FedAdam,
FedAvgM, ``cafl+adam``, ``fl.server_opt``) over a few rounds of the same
client deltas.

Tolerances, all measured on these inputs:
- ``sgd`` / ``momentum``: bit for bit (one fp32 multiply-add per
  coordinate in the same order);
- ``adam`` / ``adamw`` updates and moments: 2 fp32 ulps relative
  (2.4e-7): the step is ``(m / bc1) / (sqrt(v / bc2) + eps)`` with the
  bias corrections from ``b ** count`` in fp32, where XLA and torch may
  round ``pow`` and the divisions one ulp apart;
- ``adamw_bf16``: moments within one bf16 ulp (2^-8 relative) and
  updates within 1e-2 relative, since a one-ulp fp32 difference before
  the bf16 rounding of a moment can move it by one bf16 step;
- ``ServerOpt``: the same bounds as its optimizer, applied to the
  server's update after the fp32 weighted mean (bit for bit in both
  packages, ``tests/test_torch_core.py``).
Measured here: Adam / AdamW updates at most 1.1e-7 relative apart, the
moments equal; ``adamw_bf16`` moments and updates equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_fl_config as j_fl  # noqa: E402
from repro.fl import strategy as jstrat  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import get_fl_config as t_fl  # noqa: E402
from repro_torch.fl import strategy as tstrat  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402

ADAM_RTOL = 2.4e-7
BF16_MOMENT_RTOL = 2.0 ** -8
BF16_UPDATE_RTOL = 1e-2
SHAPES = {"a.w": (6, 5), "a.b": (5,), "stack.u": (2, 3, 4)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(state):
    """An optimizer state as a flat list of NumPy arrays."""
    if isinstance(state, dict):
        return [_np(state[k]) for k in sorted(state)]
    if isinstance(state, tuple):
        return [a for s in state for a in _leaves(s)]
    return [_np(state)]


def _close(got, want, rtol):
    for g, w in zip(got, want):
        if rtol == 0.0:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0.0)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("adam", {}), ("adamw", {}),
    ("adamw", dict(weight_decay=0.01)), ("adamw_bf16", dict(weight_decay=0.01)),
], ids=["sgd", "momentum", "adam", "adamw", "adamw_wd", "adamw_bf16"])
def test_optimizer_matches_reference(name, kw):
    """Five steps of ``make_optimizer(name)`` from the same params and
    gradients (the params move by each step's updates)."""
    jo = jopt.make_optimizer(name, 1e-2, **kw)
    to = topt.make_optimizer(name, 1e-2, **kw)
    params = _tree(0)
    jp, tp = _j(params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        grads = _tree(10 + step, scale=10.0 ** -step)
        jups, js = jo.update(_j(grads), js, jp)
        tups, ts = to.update(_t(grads), ts, tp)
        got_u = [_np(tups[k]) for k in SHAPES]
        want_u = [_np(jups[k]) for k in SHAPES]
        if name == "adamw_bf16":
            _close(_leaves(ts), _leaves(js), BF16_MOMENT_RTOL)
            _close(got_u, want_u, BF16_UPDATE_RTOL)
        else:
            rtol = 0.0 if name in ("sgd", "momentum") else ADAM_RTOL
            _close(_leaves(ts), _leaves(js), rtol)
            _close(got_u, want_u, rtol)
        jp = {k: jp[k] + jups[k] for k in jp}
        tp = {k: tp[k] + tups[k] for k in tp}
    if name == "adamw_bf16":
        assert all(m.dtype == torch.bfloat16 for m in ts.mu.values())
    with pytest.raises(ValueError):
        topt.make_optimizer("lion", 1e-3)


def test_optimizers_run_under_vmap():
    """The batched executor vmaps the update over clients: each client's
    row equals the unbatched update."""
    from torch.func import vmap
    for name in ("sgd", "momentum", "adam", "adamw_bf16"):
        opt = topt.make_optimizer(name, 1e-2, weight_decay=0.01)
        ps = [_t(_tree(c)) for c in range(3)]
        gs = [_t(_tree(20 + c)) for c in range(3)]
        stack = lambda trees: {k: torch.stack([t[k] for t in trees])
                               for k in SHAPES}
        bstate = vmap(opt.init)(stack(ps))
        bups, _ = vmap(opt.update)(stack(gs), bstate, stack(ps))
        for c in range(3):
            ups, _ = opt.update(gs[c], opt.init(ps[c]), ps[c])
            for k in SHAPES:
                torch.testing.assert_close(bups[k][c], ups[k], rtol=0,
                                           atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw_bf16"])
def test_in_place_update_matches_update(name, masked, monkeypatch):
    """``update_`` (the train step's in-place update, a piece of a
    parameter at a time; pieces of 4 elements here, so every leaf but
    the 0-dim one is cut) takes ``update``'s step bit for bit over 3
    steps, the mask applied to gradients and then to updates."""
    monkeypatch.setattr(topt, "UPDATE_PIECE", 4)
    opt = topt.make_optimizer(name, 1e-2, weight_decay=0.01)
    params = {**_t(_tree(0)), "s": torch.tensor(0.5)}
    mask = {"a.w": torch.tensor(1.0), "a.b": torch.tensor(0.0),
            "stack.u": torch.tensor([0.0, 1.0])[:, None, None],
            "s": torch.tensor(1.0)} if masked else None
    want_p, got_p = dict(params), {k: v.clone() for k, v in params.items()}
    want_s, got_s = opt.init(want_p), opt.init(got_p)
    for step in range(3):
        grads = {**_t(_tree(10 + step)), "s": torch.tensor(0.1 * step - 0.1)}
        g = grads if mask is None else {k: v * mask[k] for k, v in
                                        grads.items()}
        ups, want_s = opt.update(g, want_s, want_p)
        if mask is not None:
            ups = {k: u * mask[k] for k, u in ups.items()}
        want_p = topt.apply_updates(want_p, ups)
        got_p, got_s = opt.update_(dict(grads), got_s, got_p, mask)
    for k in params:
        torch.testing.assert_close(got_p[k], want_p[k], rtol=0, atol=0)
    _close(_leaves(got_s), _leaves(want_s), 0.0)
    if masked:
        torch.testing.assert_close(got_p["a.b"], params["a.b"], rtol=0,
                                   atol=0)


@pytest.mark.parametrize("method,fl_over", [
    ("fedadam", {}), ("fedavgm", {}), ("cafl+adam", {}),
    ("fedavg_weighted+momentum", {}), ("cafl", dict(server_opt="momentum")),
    ("fedavg+adam", dict(server_lr=0.5)),
], ids=["fedadam", "fedavgm", "cafl+adam", "weighted+momentum",
        "server_opt_config", "server_lr"])
def test_server_opt_matches_reference(method, fl_over):
    """Four rounds of three client deltas through ``aggregate`` of both
    packages' strategies."""
    js = jstrat.make_strategy(method, j_fl().replace(**fl_over))
    ts = tstrat.make_strategy(method, t_fl().replace(**fl_over))
    assert isinstance(ts, tstrat.ServerOpt) and ts.name == js.name
    rtol = 0.0 if ts.name.endswith("momentum") else ADAM_RTOL
    for rnd in range(4):
        deltas = [_tree(100 * rnd + c, scale=1e-3) for c in range(3)]
        weights = [1.0, 2.0, 5.0]
        jout = js.aggregate([_j(d) for d in deltas], weights)
        tout = ts.aggregate([_t(d) for d in deltas], weights)
        _close([_np(tout[k]) for k in SHAPES],
               [_np(jout[k]) for k in SHAPES], rtol)


def test_server_opt_composition():
    fl = t_fl()
    for name, inner in (("fedadam", tstrat.FedAvg), ("fedavgm",
                                                     tstrat.FedAvg),
                        ("cafl+adam", tstrat.CAFLL)):
        st = tstrat.make_strategy(name, fl)
        assert isinstance(st, tstrat.ServerOpt)
        assert isinstance(st.inner, inner)
    st = tstrat.make_strategy("cafl", fl.replace(server_opt="momentum"))
    assert st.name == "cafl+momentum" and st.constraints is st.inner.constraints
    assert tstrat.make_strategy("fedadam", fl).opt.update.__qualname__ \
        .startswith("adamw")
    with pytest.raises(ValueError):
        tstrat.make_strategy("nope", fl)
    # FedAvgM's first step moves with the client delta
    mom = tstrat.ServerOpt(tstrat.FedAvg(fl), "momentum", lr=1.0)
    out = mom.aggregate([{"w": torch.full((4,), 0.5)}])
    assert bool(torch.all(out["w"] > 0))
