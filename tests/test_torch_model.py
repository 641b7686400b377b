"""The port's char-LM against the JAX model, from bridged parameters.

Tolerances: the forward is fp32 on both sides with sums taken in another
order (XLA's fused reductions vs PyTorch's kernels), so the loss is held
to 1e-6 relative and each gradient leaf to 1e-5 of its largest entry
(fp32 keeps ~7 digits; backward sums lose one or two more).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params, tiny_setup  # noqa: E402

from repro.models import build as jbuild  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.models import (build, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.models import layers as tL  # noqa: E402

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    ds, jcfg, jfl, tcfg, tfl = tiny_setup()
    return ds, jcfg, tcfg, jax_params(jcfg)


def _batch(ds, seed=0, b=8, s=16):
    from repro.data import sample_batch
    return sample_batch(ds.train, np.random.default_rng(seed), b, s)


def test_parameter_names_and_shapes_match_jax(setup):
    _, jcfg, tcfg, jp = setup
    want = flat_paths(jp)
    tree = params_from_numpy(jp, device="cpu")
    got = tree.params()
    assert list(got) == list(want)                  # JAX's leaf order
    assert {n for n, _ in tree.named_parameters()} == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert got[name].dtype == torch.float32
        assert not got[name].requires_grad
    # the stacked unit layout keeps its leading n_units axis
    assert tuple(got["stack.units.b0.attn.wq"].shape) == (3, 48, 48)
    # the port's own init gives the same layout
    own = build(tcfg).init(torch.Generator().manual_seed(0), "cpu").params()
    assert [(n, tuple(t.shape)) for n, t in own.items()] == \
        [(n, l.shape) for n, l in want.items()]
    assert build(tcfg).param_count() == jbuild(jcfg).param_count()


def test_bridge_round_trips_exactly(setup):
    _, _, _, jp = setup
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    for (n, a), (m, b) in zip(flat_paths(jp).items(), flat_paths(back).items()):
        assert n == m
        assert a.tobytes() == b.tobytes()


def test_train_loss_and_grads_match_jax(setup):
    ds, jcfg, tcfg, jp = setup
    batch = _batch(ds)
    jmodel = jbuild(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, jb)[0])(jax.tree.map(jnp.asarray, jp))
    tp = {k: v.detach().requires_grad_(True)
          for k, v in params_from_numpy(jp, device="cpu").params().items()}
    tloss, metrics = build(tcfg).train_loss(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(metrics["aux"]) == 0.0
    assert tloss.detach().item() == pytest.approx(float(jloss),
                                                 rel=LOSS_RTOL)
    tgrads = torch.autograd.grad(tloss, list(tp.values()))
    for (name, jg), tg in zip(flat_paths(jgrads).items(), tgrads):
        jg = np.asarray(jg)
        err = np.abs(tg.numpy() - jg).max()
        assert err <= GRAD_RTOL * np.abs(jg).max(), (name, err)


def test_layers_match_jax():
    """The traps one by one: tanh GELU, RoPE, population-variance layer
    norm, causal attention with -1e30 masking over one and several q
    chunks."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    np.testing.assert_allclose(
        tL.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()), 1e4),
        jL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4), rtol=1e-5, atol=1e-6)
    h = rng.normal(size=(3, 5)).astype(np.float32)
    # XLA's CPU tanh is its own approximation: a few ulp apart
    np.testing.assert_allclose(tL.gelu(torch.from_numpy(h)),
                               jax.nn.gelu(jnp.asarray(h)), rtol=1e-6,
                               atol=1e-6)
    _, jcfg, _, tcfg, _ = tiny_setup()
    p = {"scale": rng.normal(size=(8,)).astype(np.float32),
         "bias": rng.normal(size=(8,)).astype(np.float32)}
    xs = rng.normal(size=(4, 8)).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        tL.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(xs)),
        jL.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                      jnp.asarray(xs), jcfg), rtol=1e-5, atol=1e-6)
    q, k, v = (rng.normal(size=(2, 12, 4, 8)).astype(np.float32)
               for _ in range(3))
    for q_chunk in (4, 12):
        got = tL.blockwise_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            q_chunk=q_chunk)
        want = jL.blockwise_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=None,
            softcap=None, q_chunk=q_chunk)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
