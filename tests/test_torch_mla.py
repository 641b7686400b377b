"""The port's multi-head latent attention (DeepSeek-V3's MLA,
``repro_torch.models.layers.mla_*``) against the reference's, from the
same JAX-initialised parameters and numpy inputs, fp32.

Two MLA shapes: DeepSeek-V3 SMOKE's (q/k 16 + 8 = 24 wide, v 16) and
one with the full model's head widths (q/k 128 + 64 = 192, v 128) at a
narrow model width. Without a gradient the full-sequence attention goes
to ``ops.flash_attention`` (the twin on the CPU) with v zero-padded to
the q/k width and the output cut back; with one, to the dense
blockwise path. The absorbed decode runs from an empty cache past the
end of a rolling buffer, and a prefill under the decode window (rolled
MLA caches) runs on into decode through the whole DeepSeek SMOKE model.

Tolerances: outputs, caches and gradients within 1e-5 of each tensor's
largest magnitude (fp32 in both, sums in other orders); the padded
route against the unpadded attention within 1e-6 (the same fp32 sums
plus exact zeros). The card's MLA test is in
``tests/test_torch_zoo_card.py``, which needs no JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params  # noqa: E402

import repro.models.layers as jL  # noqa: E402
from repro.configs import MLAConfig as JMLA  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import MLAConfig, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import flatten, unflatten  # noqa: E402

TOL = 1e-5
ARCH = "deepseek-v3-671b"
WIDE = dict(d_model=64, num_heads=2, num_kv_heads=2)
WIDE_MLA = dict(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128)


def configs(shape):
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke_config(ARCH)
    if shape == "wide":
        jcfg = jcfg.replace(mla=JMLA(**WIDE_MLA), **WIDE)
        tcfg = tcfg.replace(mla=MLAConfig(**WIDE_MLA), **WIDE)
    return jcfg, tcfg


def setup(shape, seed=0, b=2, s=40):
    jcfg, tcfg = configs(shape)
    npp = jax.tree.map(lambda a: np.array(a, copy=True),
                       jL.mla_init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, npp, x


def tparams(npp, grad=False):
    flat = {k: torch.from_numpy(v).requires_grad_(grad)
            for k, v in flatten(npp).items()}
    return flat, unflatten(flat)


def positions(b, s):
    return np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)


def assert_close(got, want, what="", tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, err_msg=what,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", ["smoke", "wide"])
def test_full_takes_the_padded_flash_route(shape, monkeypatch):
    jcfg, tcfg, npp, x = setup(shape)
    b, s, _ = x.shape
    want, (w_ckv, w_krope) = jax.jit(
        lambda p, xx, pos: jL.mla_apply_full(p, xx, pos, jcfg))(
        jax.tree.map(jnp.asarray, npp), jnp.asarray(x),
        jnp.asarray(positions(b, s)))
    widths = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        widths.append((q.shape[-1], k.shape[-1], v.shape[-1], kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    _, p = tparams(npp)
    with torch.no_grad():
        got, (ckv, krope) = L.mla_apply_full(
            p, torch.from_numpy(x), torch.from_numpy(positions(b, s)), tcfg)
    m = tcfg.mla
    dq = m.qk_nope_head_dim + m.qk_rope_head_dim
    assert widths == [(dq, dq, dq, 1.0 / np.sqrt(dq))]
    assert got.shape == (b, s, tcfg.d_model)
    assert_close(got.numpy(), want)
    assert_close(ckv.numpy(), w_ckv)
    assert_close(krope.numpy(), w_krope)


@pytest.mark.parametrize("shape", ["smoke", "wide"])
def test_full_with_gradient_matches_reference(shape):
    """The differentiable (blockwise) route, values and gradients."""
    jcfg, tcfg, npp, x = setup(shape, seed=1)
    b, s, _ = x.shape
    w = np.random.default_rng(2).normal(size=(b, s, jcfg.d_model)).astype(
        np.float32)
    pos = positions(b, s)

    def jloss(p):
        out, _ = jL.mla_apply_full(p, jnp.asarray(x), jnp.asarray(pos), jcfg)
        return jnp.sum(out * jnp.asarray(w)), out

    (_, want), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, npp))
    flat, p = tparams(npp, grad=True)
    out, _ = L.mla_apply_full(p, torch.from_numpy(x), torch.from_numpy(pos),
                              tcfg)
    torch.sum(out * torch.from_numpy(w)).backward()
    assert_close(out.detach().numpy(), want)
    for name, g in flat_paths(grads).items():
        assert_close(flat[name].grad.numpy(), g, name)


def test_padded_v_is_the_same_function():
    """Attention with v zero-padded from 128 to 192 and cut back, against
    the unpadded dense attention at the same scale."""
    rng = np.random.default_rng(3)
    q, k = (torch.from_numpy(rng.normal(size=(2, 33, 4, 192)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.normal(size=(2, 33, 4, 128)).astype(np.float32))
    scale = 1.0 / np.sqrt(192)
    padded = ref.flash_attention_ref(q, k, torch.nn.functional.pad(
        v, (0, 64)), scale=scale)
    assert torch.all(padded[..., 128:] == 0)
    plain = L.blockwise_attention(q, k, v, q_chunk=16, scale=scale)
    assert_close(padded[..., :128].numpy(), plain.numpy(), tol=1e-6)


@pytest.mark.parametrize("shape", ["smoke", "wide"])
def test_absorbed_decode_matches_reference(shape):
    """12 one-token steps from an empty 8-slot cache (the buffer rolls
    after 8): outputs at every step and the final cache."""
    jcfg, tcfg, npp, _ = setup(shape, seed=4)
    b, steps, s_buf = 2, 12, 8
    xs = np.random.default_rng(5).normal(
        size=(steps, b, 1, jcfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, npp)
    jcache = jL.mla_cache_init(jcfg, b, s_buf)
    tcache = L.mla_cache_init(tcfg, b, s_buf, "cpu")
    _, p = tparams(npp)
    step = jax.jit(lambda c, xx: jL.mla_apply_decode(jp, xx, c, jcfg))
    for t in range(steps):
        want, jcache = step(jcache, jnp.asarray(xs[t]))
        with torch.no_grad():
            got, tcache = L.mla_apply_decode(p, torch.from_numpy(xs[t]),
                                             tcache, tcfg)
        assert_close(got.numpy(), want, f"step {t}")
    assert int(tcache["index"]) == int(jcache["index"]) == steps
    for name in ("c_kv", "k_rope"):
        assert_close(tcache[name].numpy(), jcache[name], name)


def test_rolled_prefill_caches_decode_like_reference():
    """DeepSeek SMOKE under a decode window of 32: a 48-token prefill
    keeps the last 32 latents of each layer, rolled, and 4 decode steps
    follow the reference's."""
    cfg_kw = dict(decode_window=32)
    jcfg = j_get_smoke(ARCH).replace(**cfg_kw)
    tcfg = get_smoke_config(ARCH).replace(**cfg_kw)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0))
    tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0))
    npp = jax_params(jcfg, seed=6)
    jm, tm = jbuild(jcfg), build(tcfg)
    jp, tp = jax.tree.map(jnp.asarray, npp), params_from_numpy(npp, "cpu")
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size,
                                             (2, 52)).astype(np.int32)
    jl, jcache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, use_decode_window=True))(
        jp, jnp.asarray(toks[:, :48]))
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :48])},
                            use_decode_window=True)
    assert tuple(tcache["prefix"][0]["c_kv"].shape) == (2, 32, 32)
    assert_close(tl.numpy(), jl)
    jstep = jax.jit(jm.decode_step)
    for t in range(4):
        tok = toks[:, 48 + t:49 + t]
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok))
        tl, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok))
        assert_close(tl.numpy(), jl, f"step {t}")
    want = flat_paths(jcache)
    got = flat_paths(tcache)
    assert list(got) == list(want)
    for name, leaf in want.items():
        if name.endswith("index"):
            np.testing.assert_array_equal(got[name].numpy(), leaf)
        else:
            assert_close(got[name].numpy(), leaf, name)
