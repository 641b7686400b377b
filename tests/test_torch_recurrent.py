"""The port's recurrent blocks (``repro_torch.models.rglru`` and
``repro_torch.models.ssm``) against the reference's, f32, from the same
JAX-initialised parameters and numpy inputs: the causal depthwise conv
and its decode step; the RG-LRU scan (against
``jax.lax.associative_scan``), the RG-LRU block with and without an
incoming state, with gradients, and its decode chained against its full
form; the chunkwise mLSTM at lengths that are and are not whole chunks
and from an incoming state, its decode step chained against it, the
whole mLSTM block and its decode; the sLSTM cell, block and decode.

Tolerances:
- The conv, the gates, the mLSTM chunks and the sLSTM cell: 1e-5 of
  each tensor's largest magnitude (fp32 in both, the same operations
  summed in other orders).
- The RG-LRU scan: 1e-6 of the largest magnitude. The port runs a
  doubling scan and XLA's associative scan another tree, so each output
  sums its up to S terms in another order (log-depth in both: a few
  fp32 ulps, measured 1.1e-7 of the largest value at S = 1000).
- Chained decode against the full forms, within the port: 1e-5 of the
  largest magnitude (one step's sums against a chunk's or a scan's).
- Gradients: 1e-5 of each gradient's largest magnitude.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.rglru as jrg  # noqa: E402
import repro.models.ssm as jssm  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import rglru as rg  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import flatten, unflatten  # noqa: E402

TOL = 1e-5
SCAN_TOL = 1e-6
RG, XL = "recurrentgemma-2b", "xlstm-1.3b"


def assert_close(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def to_torch(npp, grad=False):
    flat = {k: torch.from_numpy(v).requires_grad_(grad)
            for k, v in flatten(npp).items()}
    return flat, unflatten(flat)


def init(fn, jcfg, seed):
    return jax.tree.map(lambda a: np.array(a, copy=True),
                        fn(jax.random.PRNGKey(seed), jcfg))


def normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,s", [(4, 1), (4, 9), (1, 5), (3, 40)])
def test_causal_dwconv_matches_reference(width, s):
    x, w = normal(s, 2, s, 6), normal(width, width, 6)
    want = jssm.causal_dwconv(jnp.asarray(x), jnp.asarray(w))
    assert_close(ssm.causal_dwconv(t(x), t(w)).numpy(), want)


@pytest.mark.parametrize("width", [4, 2])
def test_causal_dwconv_step_matches_reference(width):
    x_t, state, w = normal(1, 3, 5), normal(2, 3, width - 1, 5), normal(
        3, width, 5)
    want, want_state = jssm.causal_dwconv_step(
        jnp.asarray(x_t), jnp.asarray(state), jnp.asarray(w))
    got, got_state = ssm.causal_dwconv_step(t(x_t), t(state), t(w))
    assert_close(got.numpy(), want)
    assert_close(got_state.numpy(), want_state)


def test_dwconv_steps_chain_to_the_full_conv():
    x, w = normal(4, 2, 11, 5), normal(5, 4, 5)
    full = ssm.causal_dwconv(t(x), t(w))
    state = torch.zeros((2, 3, 5))
    for i in range(11):
        out, state = ssm.causal_dwconv_step(t(x[:, i]), state, t(w))
        assert_close(out.numpy(), full[:, i].numpy(), f"step {i}")


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 7, 64, 1000])
def test_rglru_scan_matches_associative_scan(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 16)).astype(np.float32)
    bx = normal(s + 1, 2, s, 16)
    want = jrg.rglru_scan(jnp.asarray(a), jnp.asarray(bx))
    got = rg.rglru_scan(t(a), t(bx))
    assert_close(got.numpy(), want, tol=SCAN_TOL)


def rglru_setup(seed=0, s=37):
    jcfg, tcfg = j_get_smoke(RG), get_smoke_config(RG)
    npp = init(jrg.rglru_init, jcfg, seed)
    x = normal(seed + 10, 2, s, jcfg.d_model)
    h0 = normal(seed + 11, 2, jcfg.rglru.lru_width, scale=0.5)
    return jcfg, tcfg, npp, x, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_full_matches_reference(with_h0):
    jcfg, tcfg, npp, x, h0 = rglru_setup(seed=1)
    jh0 = jnp.asarray(h0) if with_h0 else None
    want, want_cache = jax.jit(lambda p, xx: jrg.rglru_apply_full(
        p, xx, jcfg, jh0))(jax.tree.map(jnp.asarray, npp), jnp.asarray(x))
    _, p = to_torch(npp)
    got, cache = rg.rglru_apply_full(p, t(x), tcfg,
                                     t(h0) if with_h0 else None)
    assert_close(got.numpy(), want)
    for name in ("conv", "h"):
        assert_close(cache[name].numpy(), want_cache[name], name)


def test_rglru_gradients_match_reference():
    jcfg, tcfg, npp, x, h0 = rglru_setup(seed=2, s=20)
    w = normal(5, 2, 20, jcfg.d_model)

    def jloss(p, xx, hh):
        out, _ = jrg.rglru_apply_full(p, xx, jcfg, hh)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, npp), jnp.asarray(x), jnp.asarray(h0))
    flat, p = to_torch(npp, grad=True)
    xt, ht = t(x, True), t(h0, True)
    out, _ = rg.rglru_apply_full(p, xt, tcfg, ht)
    (out * t(w)).sum().backward()
    for name, g in flatten(jax.tree.map(np.asarray, want[0])).items():
        assert_close(flat[name].grad.numpy(), g, name)
    assert_close(xt.grad.numpy(), want[1], "x")
    assert_close(ht.grad.numpy(), want[2], "h0")


def test_rglru_decode_chains_to_full_and_matches_reference():
    """Decode from the state after 30 tokens, 7 steps: each step against
    the reference's decode from the same cache and against the port's
    full form over all 37 tokens."""
    jcfg, tcfg, npp, x, _ = rglru_setup(seed=3)
    _, p = to_torch(npp)
    full, _ = rg.rglru_apply_full(p, t(x), tcfg)
    _, cache = rg.rglru_apply_full(p, t(x[:, :30]), tcfg)
    jp = jax.tree.map(jnp.asarray, npp)
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    for i in range(30, 37):
        got, cache = rg.rglru_apply_decode(p, t(x[:, i:i + 1]), cache, tcfg)
        want, jcache = jrg.rglru_apply_decode(jp, jnp.asarray(x[:, i:i + 1]),
                                              jcache, jcfg)
        assert_close(got.numpy(), want, f"step {i}")
        assert_close(got.numpy()[:, 0], full[:, i].numpy(), f"full {i}")
    for name in ("conv", "h"):
        assert_close(cache[name].numpy(), jcache[name], name)
    blank = rg.rglru_cache_init(tcfg, 2, torch.device("cpu"))
    ref_blank = jrg.rglru_cache_init(jcfg, 2)
    for name in ("conv", "h"):
        assert blank[name].shape == ref_blank[name].shape
        assert not blank[name].any()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_inputs(seed, s, nh=2, dh=8, b=2):
    q, k, v = (normal(seed + i, b, s, nh, dh) for i in range(3))
    li = normal(seed + 3, b, s, nh)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        normal(seed + 4, b, s, nh) + 2.0)))
    return q, k, v, li, lf


def mlstm_state(seed, nh=2, dh=8, b=2):
    return (normal(seed, b, nh, dh, dh), normal(seed + 1, b, nh, dh),
            normal(seed + 2, b, nh, scale=2.0))


@pytest.mark.parametrize("s,chunk,with_state", [
    (32, 8, False), (37, 8, False), (5, 16, False), (37, 8, True),
    (64, 16, True)])
def test_mlstm_chunkwise_matches_reference(s, chunk, with_state):
    """Whole chunks, a padded last chunk (37 = 4 x 8 + 5), one short
    chunk (5 < 16), and an incoming state."""
    xs = mlstm_inputs(s, s)
    state = mlstm_state(s + 7) if with_state else None
    want, (wC, wn, wm) = jssm.mlstm_chunkwise(
        *(jnp.asarray(a) for a in xs), chunk,
        None if state is None else tuple(jnp.asarray(a) for a in state))
    got, (C, n, m) = ssm.mlstm_chunkwise(
        *(t(a) for a in xs), chunk,
        None if state is None else tuple(t(a) for a in state))
    assert_close(got.numpy(), want)
    for name, g, w in (("C", C, wC), ("n", n, wn), ("m", m, wm)):
        assert_close(g.numpy(), w, name)


def test_mlstm_steps_chain_to_chunkwise_and_match_reference():
    q, k, v, li, lf = mlstm_inputs(40, 21)
    full, (C_full, n_full, m_full) = ssm.mlstm_chunkwise(
        t(q), t(k), t(v), t(li), t(lf), 8)
    state = tuple(t(a) for a in mlstm_state(50))
    zero = (torch.zeros_like(state[0]), torch.zeros_like(state[1]),
            torch.full_like(state[2], -1e30))
    state, jstate = zero, tuple(jnp.asarray(a.numpy()) for a in zero)
    for i in range(21):
        step = [a[:, i] for a in (q, k, v, li, lf)]
        got, state = ssm.mlstm_step(*(t(a) for a in step), state)
        want, jstate = jssm.mlstm_step(*(jnp.asarray(a) for a in step),
                                       jstate)
        assert_close(got.numpy(), want, f"step {i}")
        assert_close(got.numpy(), full[:, i].numpy(), f"chunkwise {i}")
    for name, g, w, f in zip("Cnm", state, jstate,
                             (C_full, n_full, m_full)):
        assert_close(g.numpy(), w, name)
        assert_close(g.numpy(), f.numpy(), f"chunkwise {name}")


def block_setup(fn, seed, s):
    jcfg, tcfg = j_get_smoke(XL), get_smoke_config(XL)
    npp = init(fn, jcfg, seed)
    return jcfg, tcfg, npp, normal(seed + 20, 2, s, jcfg.d_model)


def test_mlstm_block_and_decode_match_reference():
    """The block over 37 tokens (SMOKE chunk 16: a padded last chunk),
    then 5 decode steps from its cache, against the reference's."""
    jcfg, tcfg, npp, x = block_setup(jssm.mlstm_init, 4, 42)
    jp = jax.tree.map(jnp.asarray, npp)
    want, jcache = jax.jit(lambda p, xx: jssm.mlstm_apply_full(p, xx, jcfg))(
        jp, jnp.asarray(x[:, :37]))
    _, p = to_torch(npp)
    got, cache = ssm.mlstm_apply_full(p, t(x[:, :37]), tcfg)
    assert_close(got.numpy(), want)
    for name in ("conv", "C", "n", "m"):
        assert_close(cache[name].numpy(), jcache[name], name)
    full, _ = ssm.mlstm_apply_full(p, t(x), tcfg)
    for i in range(37, 42):
        got, cache = ssm.mlstm_apply_decode(p, t(x[:, i:i + 1]), cache, tcfg)
        want, jcache = jssm.mlstm_apply_decode(jp, jnp.asarray(
            x[:, i:i + 1]), jcache, jcfg)
        assert_close(got.numpy(), want, f"step {i}")
        assert_close(got.numpy()[:, 0], full[:, i].numpy(), f"full {i}")
    blank = ssm.mlstm_cache_init(tcfg, 2, torch.device("cpu"))
    for name, leaf in jssm.mlstm_cache_init(jcfg, 2).items():
        assert tuple(blank[name].shape) == leaf.shape, name
        np.testing.assert_array_equal(blank[name].numpy(), np.asarray(leaf))


def test_mlstm_block_gradients_match_reference():
    jcfg, tcfg, npp, x = block_setup(jssm.mlstm_init, 5, 20)
    w = normal(6, *x.shape)

    def jloss(p, xx):
        out, _ = jssm.mlstm_apply_full(p, xx, jcfg)
        return jnp.sum(out * w)

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, npp), jnp.asarray(x))
    flat, p = to_torch(npp, grad=True)
    xt = t(x, True)
    out, _ = ssm.mlstm_apply_full(p, xt, tcfg)
    (out * t(w)).sum().backward()
    for name, g in flatten(jax.tree.map(np.asarray, want_p)).items():
        assert_close(flat[name].grad.numpy(), g, name)
    assert_close(xt.grad.numpy(), want_x, "x")


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def test_slstm_cell_matches_reference():
    jcfg, _, npp, _ = block_setup(jssm.slstm_init, 7, 1)
    d = jcfg.d_model
    x_gates = normal(8, 3, 4 * d)
    state = (normal(9, 3, d), normal(10, 3, d), np.abs(normal(11, 3, d)),
             normal(12, 3, d))
    want = jssm._slstm_cell(jax.tree.map(jnp.asarray, npp),
                            jnp.asarray(x_gates),
                            tuple(jnp.asarray(a) for a in state),
                            jcfg.num_heads)
    _, p = to_torch(npp)
    got = ssm._slstm_cell(p, t(x_gates), tuple(t(a) for a in state),
                          jcfg.num_heads)
    for name, g, w in zip("hcnm", got, want):
        assert_close(g.numpy(), w, name)


def test_slstm_block_and_decode_match_reference():
    """The block over 30 tokens, then 6 decode steps from its state,
    against the reference's and against the block over all 36."""
    jcfg, tcfg, npp, x = block_setup(jssm.slstm_init, 13, 36)
    jp = jax.tree.map(jnp.asarray, npp)
    want, jstate = jax.jit(lambda p, xx: jssm.slstm_apply_full(p, xx, jcfg))(
        jp, jnp.asarray(x[:, :30]))
    _, p = to_torch(npp)
    got, state = ssm.slstm_apply_full(p, t(x[:, :30]), tcfg)
    assert_close(got.numpy(), want)
    for name, g, w in zip("hcnm", state, jstate):
        assert_close(g.numpy(), w, name)
    full, _ = ssm.slstm_apply_full(p, t(x), tcfg)
    cache = dict(zip("hcnm", state))
    jcache = dict(zip("hcnm", jstate))
    for i in range(30, 36):
        got, cache = ssm.slstm_apply_decode(p, t(x[:, i:i + 1]), cache, tcfg)
        want, jcache = jssm.slstm_apply_decode(jp, jnp.asarray(
            x[:, i:i + 1]), jcache, jcfg)
        assert_close(got.numpy(), want, f"step {i}")
        assert_close(got.numpy()[:, 0], full[:, i].numpy(), f"full {i}")
    blank = ssm.slstm_cache_init(tcfg, 2, torch.device("cpu"))
    for name, leaf in jssm.slstm_cache_init(jcfg, 2).items():
        np.testing.assert_array_equal(blank[name].numpy(), np.asarray(leaf))


def test_slstm_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; the sLSTM's
    up-projection takes the same (erf GELU differs by ~1e-3 here)."""
    from repro_torch.models.layers import gelu
    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert_close(gelu(t(x)).numpy(), want)
    erf = torch.nn.functional.gelu(t(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4
