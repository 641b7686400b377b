"""Shared setup of the port's parity tests (``tests/test_torch_*.py``).

The tiny char-LM and federated setting of
``tests/test_golden_trajectories.py``, built in both packages, and
parameters initialised by JAX and bridged into the port: torch cannot
reproduce ``jax.random``, so both packages run from the same weights.
"""
import dataclasses

import jax
import numpy as np
import torch

# The tiny models gain nothing from intra-op threads, and the suite runs
# in several worker processes at once: one torch thread each keeps
# their thread pools from oversubscribing the machine's cores.
torch.set_num_threads(1)

from repro.configs import get_config, get_fl_config
from repro.data import load_corpus
from repro.models import build as jbuild
from repro_torch.configs import charlm_shakespeare as tcs

TINY_MODEL = dict(num_layers=3, d_model=48, num_heads=4, num_kv_heads=4,
                  head_dim=12, d_ff=96)
TINY_FL = dict(num_clients=4, clients_per_round=2, s_base=3,
               b_base=8, seq_len=16, eval_batches=1, eval_batch_size=8)


def tiny_setup():
    """-> (dataset, jax cfg, jax fl, port cfg, port fl)."""
    ds = load_corpus(target_bytes=60_000)
    vocab = max(ds.vocab_size, 64)
    jcfg = get_config("charlm-shakespeare").replace(vocab_size=vocab,
                                                    **TINY_MODEL)
    tcfg = tcs.CONFIG.replace(vocab_size=vocab, **TINY_MODEL)
    jfl = get_fl_config().replace(**TINY_FL)
    jfl = jfl.replace(duals=dataclasses.replace(jfl.duals, s_min=2, b_min=4))
    tfl = tcs.FL.replace(**TINY_FL)
    tfl = tfl.replace(duals=dataclasses.replace(tfl.duals, s_min=2, b_min=4))
    return ds, jcfg, jfl, tcfg, tfl


def jax_params(jcfg, seed: int = 0):
    """JAX-initialised params as a nested dict of NumPy arrays."""
    params = jbuild(jcfg).init(jax.random.PRNGKey(seed))
    return jax.tree.map(lambda a: np.array(a, copy=True), params)


def flat_paths(tree, prefix=""):
    """JAX tree -> {dotted path: leaf}, in JAX's own leaf order (a list
    item's component is its index)."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): leaf for path, leaf in leaves}


#: ``tests/test_fl_clock.py``'s engine setting (``tiny_pair`` overrides)
CLOCK_MODEL = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                   head_dim=16, d_ff=64)
CLOCK_FL = dict(rounds=3, num_clients=6, clients_per_round=3)


def straggler_dynamics(mod, fl, deadline=1.1, jitter=0.2):
    """Uniform K-of-N with deadline stragglers, from package ``mod``'s
    ``fl`` module."""
    return mod.FleetDynamics(
        sampler=mod.UniformSampler(fl.clients_per_round),
        stragglers=mod.DeadlineStragglers.for_config(fl, deadline=deadline,
                                                     jitter=jitter))


#: the engine bounds of ``tests/test_torch_engine.py``: duals 1e-9,
#: usage 1e-6 relative, losses and wire MB 5e-3
DUAL_ATOL = 1e-9
USAGE_RTOL = 1e-6
LOSS_ATOL = 5e-3


def tiny_pair(model=None, fl=None, target_bytes=60_000):
    """Both packages' tiny setting with ``model`` / ``fl`` overrides:
    a dict of the two datasets, configs and JAX-initialised params."""
    from repro_torch.data import load_corpus as t_load_corpus
    ds, jcfg, jfl, tcfg, tfl = tiny_setup()
    if model:
        jcfg, tcfg = jcfg.replace(**model), tcfg.replace(**model)
    if fl:
        jfl, tfl = jfl.replace(**fl), tfl.replace(**fl)
    return dict(ds=ds, tds=t_load_corpus(target_bytes=target_bytes),
                jcfg=jcfg, jfl=jfl, tcfg=tcfg, tfl=tfl, p=jax_params(jcfg))


def _run(pkg, s, make, run, fl, strategy):
    """One engine scenario in one package (``"jax"`` or ``"torch"``,
    the port on the CPU) -> (engine, result)."""
    import jax.numpy as jnp
    if pkg == "jax":
        import repro.fl as mod
        from repro.models import build
        cfg, flc, ds = s["jcfg"], s["jfl"], s["ds"]
        init = jax.tree.map(jnp.asarray, s["p"])
    else:
        import repro_torch.fl as mod
        from repro_torch.models import build, params_from_numpy
        cfg, flc, ds = s["tcfg"], s["tfl"], s["tds"]
        init = params_from_numpy(s["p"], "cpu")
    flc = flc.replace(**(fl or {}))
    kw = dict(make(mod, flc)) if make else {}
    kw.setdefault("strategy", strategy)
    if pkg == "torch":
        kw["device"] = "cpu"
    eng = mod.FederatedEngine(build(cfg), flc, ds, **kw)
    return eng, eng.run(init_params=init, **(run or {}))


def run_pair(s, make=None, run=None, fl=None, strategy="cafl"):
    """The same engine scenario in both packages, from the same params:
    ``make(fl_module, fl)`` returns the engine's keyword arguments, built
    from that package's ``fl`` module (``repro.fl`` or ``repro_torch.fl``);
    ``run`` the ``run()`` arguments; ``fl`` overrides both FLConfigs.
    -> ((jax engine, result), (port engine, result)); the port on the
    CPU."""
    return tuple(_run(pkg, s, make, run, fl, strategy)
                 for pkg in ("jax", "torch"))


def run_port(s, make=None, run=None, fl=None, strategy="cafl"):
    """``run_pair``'s scenario in the port alone -> (engine, result)."""
    return _run("torch", s, make, run, fl, strategy)


def assert_histories_match(jres, tres):
    """Round records of the two packages: schedules, knobs, counts and
    simulated times exact; duals 1e-9; usage 1e-6 relative; losses and
    wire MB 5e-3."""
    import pytest
    assert tres.method == jres.method
    assert len(tres.history) == len(jres.history)
    for j, t in zip(jres.history, tres.history):
        what = f"round {j.round}"
        assert t.round == j.round
        assert t.knobs == j.knobs, what
        for field in ("participants", "dropped", "late_arrivals",
                      "num_available", "updates_applied", "reports_applied",
                      "mean_staleness", "sim_time", "round_seconds"):
            assert getattr(t, field) == getattr(j, field), (what, field)
        assert t.duals.keys() == j.duals.keys()
        for name, lam in j.duals.items():
            assert t.duals[name] == pytest.approx(lam, abs=DUAL_ATOL), what
        for name, u in j.usage.items():
            assert t.usage[name] == pytest.approx(u, rel=USAGE_RTOL), what
            assert t.ratios[name] == pytest.approx(j.ratios[name],
                                                   rel=USAGE_RTOL), what
        assert t.constraints.keys() == j.constraints.keys()
        for name, c in j.constraints.items():
            assert t.constraints[name]["lam"] == pytest.approx(
                c["lam"], abs=DUAL_ATOL)
            assert t.constraints[name]["violated"] == c["violated"]
        for field in ("val_loss", "train_loss", "wire_mb_actual"):
            assert getattr(t, field) == pytest.approx(
                getattr(j, field), abs=LOSS_ATOL), (what, field)
        assert t.energy_true == pytest.approx(j.energy_true, rel=USAGE_RTOL)
        assert t.per_profile.keys() == j.per_profile.keys()
        for name, jp in j.per_profile.items():
            tp = t.per_profile[name]
            assert (tp["clients"], tp["knobs"]) == (jp["clients"],
                                                    jp["knobs"])
            for k, lam in jp.get("duals", {}).items():
                assert tp["duals"][k] == pytest.approx(lam, abs=DUAL_ATOL)
