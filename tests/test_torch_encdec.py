"""The port's bidirectional attention, the kv-chunked branch of its
training attention and the encoder-decoder (``repro_torch.models.encdec``,
SeamlessM4T-medium's backbone) against the reference's, f32, from the
same JAX-initialised parameters and numpy inputs.

- ``bidir_attention`` with q and k of different lengths (and q of one
  token, decode's cross-attention), GQA and a softcap: without a
  gradient through ``ops.flash_attention(causal=False)`` (the twin on
  the CPU), with one through the plain ``_attend_block``.
- ``_attend_block``'s kv-chunked online-softmax branch (past ``2 *
  kv_chunk`` keys), at a small ``kv_chunk`` passed to both packages:
  causal, windowed, bidirectional, softcapped, keys not a whole number of
  chunks; values and gradients (against ``jax.grad``), and the branch
  against the port's own dense branch.
- The encoder and decoder layers; the model's prefill (each attention on
  the flash route: the encoder's, the decoder's causal self-attention
  and its cross-attention), decode (the cross-attention on the flash
  route at Sq 1), a prefill under a decode window shorter than the
  prompt, ``init_cache`` with a source length, and a masked loss.

Tolerances: 1e-5 of each tensor's largest magnitude for values, caches
and gradients (fp32 in both, sums in other orders; the online softmax
rescales its partial sums per chunk); logits within 1e-5 absolute
(values of order 1), losses within 1e-5 relative, as
``tests/test_torch_zoo.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params  # noqa: E402

import repro.models.encdec as jed  # noqa: E402
import repro.models.layers as jL  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import flatten, unflatten  # noqa: E402

TOL = 1e-5
ATOL = 1e-5
ARCH = "seamless-m4t-medium"


def assert_close(got, want, what="", tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30))


def normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.fixture
def flash_calls(monkeypatch):
    """Every ``ops.flash_attention`` call: (Sq, Sk, causal)."""
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw.get("causal", True)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    return calls


# ---------------------------------------------------------------------------
# bidirectional attention
# ---------------------------------------------------------------------------

BIDIR = [  # (sq, sk, h, kvh, d, softcap)
    (7, 19, 4, 2, 16, None), (1, 40, 4, 4, 8, None), (33, 5, 2, 1, 16, 20.0),
    (12, 12, 6, 2, 8, None)]


@pytest.mark.parametrize("case", BIDIR, ids=str)
def test_bidir_attention_matches_reference(case, flash_calls):
    sq, sk, h, kvh, d, softcap = case
    q, k, v = (normal(sq + i, 2, s, n, d) for i, (s, n) in
               enumerate(((sq, h), (sk, kvh), (sk, kvh))))
    want = jL.bidir_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              softcap=softcap)
    with torch.no_grad():
        got = L.bidir_attention(t(q), t(k), t(v), softcap=softcap)
    assert flash_calls == [(sq, sk, False)]
    assert_close(got.numpy(), want)
    qt, kt, vt = t(q, True), t(k, True), t(v, True)
    got = L.bidir_attention(qt, kt, vt, softcap=softcap)
    assert len(flash_calls) == 1          # the gradient route is plain
    assert_close(got.detach().numpy(), want)
    w = normal(9, *got.shape)
    (got * t(w)).sum().backward()
    grads = jax.grad(lambda a, b, c: jnp.sum(jL.bidir_attention(
        a, b, c, softcap=softcap) * w), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for name, g, gw in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        assert_close(g.numpy(), gw, name)


# ---------------------------------------------------------------------------
# the kv-chunked online-softmax branch
# ---------------------------------------------------------------------------

CHUNKED = [  # (sq, q0, sk, kv_chunk, window, softcap, causal)
    (16, 30, 46, 8, None, None, True),     # causal, keys 46 = 5 x 8 + 6
    (8, 40, 48, 8, 12, 30.0, True),        # window: whole chunks masked
    (9, 0, 37, 6, None, None, False),      # bidirectional, padded
    (4, 0, 50, 7, None, 20.0, False),
]


@pytest.mark.parametrize("case", CHUNKED, ids=str)
def test_kv_chunked_branch_matches_reference(case):
    """A q chunk at positions q0.. over keys 0..sk-1 (the causal cases:
    the chunk's own kv prefix, as ``blockwise_attention`` gives it), with
    sk > 2 kv_chunk so both packages take the scan."""
    sq, q0, sk, chunk, window, softcap, causal = case
    assert sk > 2 * chunk
    h, kvh, d = 4, 2, 8
    q, k, v = normal(1, 2, sq, h, d), normal(2, 2, sk, kvh, d), normal(
        3, 2, sk, kvh, d)
    qpos, kpos = np.arange(q0, q0 + sq), np.arange(sk)
    scale = 1.0 / np.sqrt(d)
    w = normal(4, 2, sq, h, d)

    def jfn(a, b, c):
        return jL._attend_block(a, b, c, jnp.asarray(qpos), jnp.asarray(kpos),
                                scale, softcap, window, kv_chunk=chunk,
                                causal=causal)

    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = jax.grad(lambda a, b, c: jnp.sum(jfn(a, b, c) * w),
                     argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    qt, kt, vt = t(q, True), t(k, True), t(v, True)
    got = L._attend_block(qt, kt, vt, torch.from_numpy(qpos),
                          torch.from_numpy(kpos), scale, softcap, window,
                          kv_chunk=chunk, causal=causal)
    assert_close(got.detach().numpy(), want)
    (got * t(w)).sum().backward()
    for name, g, gw in zip("qkv", (qt.grad, kt.grad, vt.grad), grads):
        assert_close(g.numpy(), gw, name)
    dense = L._attend_block(t(q), t(k), t(v), torch.from_numpy(qpos),
                            torch.from_numpy(kpos), scale, softcap, window,
                            kv_chunk=sk, causal=causal)
    assert_close(got.detach().numpy(), dense.detach().numpy(), "dense")


def test_long_training_attention_takes_the_chunked_branch():
    """``blockwise_attention`` with a gradient over more than 2 kv_chunk
    keys (4,096 by default) runs the scan, as the reference does, and
    agrees with it (one head, D 4, S 4,500: a q chunk of 2,048)."""
    s, d = 4500, 4
    q, k, v = (normal(20 + i, 1, s, 1, d) for i in range(3))
    want = jL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=None, softcap=None,
                                  q_chunk=2048)
    got = L.blockwise_attention(t(q, True), t(k), t(v), q_chunk=2048)
    assert_close(got.detach().numpy(), want)


# ---------------------------------------------------------------------------
# encoder and decoder layers
# ---------------------------------------------------------------------------


def layer_setup(fn, seed):
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke_config(ARCH)
    npp = jax.tree.map(lambda a: np.array(a, copy=True),
                       fn(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, npp, unflatten({k: torch.from_numpy(v) for k, v in
                                       flatten(npp).items()})


def test_encoder_layer_matches_reference(flash_calls):
    jcfg, tcfg, npp, p = layer_setup(jed._enc_layer_init, 0)
    x = normal(5, 2, 21, jcfg.d_model)
    want = jed._enc_layer(jax.tree.map(jnp.asarray, npp), jnp.asarray(x),
                          jcfg)
    with torch.no_grad():
        got = encdec._enc_layer(p, t(x), tcfg)
    assert flash_calls == [(21, 21, False)]
    assert_close(got.numpy(), want)


def test_decoder_layer_full_and_decode_match_reference(flash_calls):
    """A decoder layer over 13 target tokens against 22 source frames,
    then 3 decode steps from its rolled cache (8 slots)."""
    jcfg, tcfg, npp, p = layer_setup(jed._dec_layer_init, 1)
    jp = jax.tree.map(jnp.asarray, npp)
    x, mem = normal(6, 2, 16, jcfg.d_model), normal(7, 2, 22, jcfg.d_model)
    k_enc, v_enc = jed._cross_kv(jp, jnp.asarray(mem), jcfg)
    pos = np.tile(np.arange(13), (2, 1))
    want, wcache = jed._dec_layer_full(jp, jnp.asarray(x[:, :13]),
                                         jnp.asarray(pos), k_enc, v_enc,
                                         jcfg, True)
    with torch.no_grad():
        tk, tv = encdec._cross_kv(p, t(mem), tcfg)
        got, (k, v) = encdec._dec_layer_full(p, t(x[:, :13]),
                                             torch.from_numpy(pos), tk, tv,
                                             tcfg)
    assert flash_calls == [(13, 13, True), (13, 22, False)]
    assert_close(tk.numpy(), k_enc, "cross k")
    assert_close(tv.numpy(), v_enc, "cross v")
    assert_close(got.numpy(), want)
    assert_close(k.numpy(), wcache["k"], "k")
    assert_close(v.numpy(), wcache["v"], "v")
    cache = L.attn_cache_from_full(k, v, 8)
    jcache = jL.attn_cache_from_full(jnp.asarray(k.numpy()),
                                     jnp.asarray(v.numpy()), 8)
    for i in range(13, 16):
        with torch.no_grad():
            got = encdec._dec_layer_decode(p, t(x[:, i:i + 1]), cache, tk,
                                           tv, tcfg)
        want, jcache = jed._dec_layer_decode(jp, jnp.asarray(x[:, i:i + 1]),
                                             jcache, k_enc, v_enc, jcfg)
        assert_close(got.numpy(), want, f"step {i}")
    assert flash_calls[2:] == [(1, 22, False)] * 3
    assert_close(cache["k"].numpy(), jcache["k"])
    assert int(cache["index"]) == int(jcache["index"]) == 16


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = j_get_smoke(ARCH), get_smoke_config(ARCH)
    npp = jax_params(jcfg, seed=2)
    rng = np.random.default_rng(3)
    batch = {"src_embeds": rng.normal(size=(2, 30, jcfg.frontend.embed_dim)
                                      ).astype(np.float32),
             "tokens": rng.integers(0, jcfg.vocab_size, (2, 20)).astype(
                 np.int32)}
    batch["targets"] = np.roll(batch["tokens"], -1, axis=1)
    more = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    return dict(jcfg=jcfg, tcfg=tcfg, npp=npp, batch=batch, more=more,
                jp=jax.tree.map(jnp.asarray, npp),
                tp=params_from_numpy(npp, "cpu"))


def jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("window", [None, 16])
def test_model_prefill_and_decode_match_reference(model_pair, window,
                                                  flash_calls):
    """Prefill of 20 target tokens over 30 source frames, then 6 decode
    steps; with ``window`` the config's decode window (16) is shorter
    than the prompt, so the self caches roll (``use_decode_window``)."""
    s = model_pair
    jcfg, tcfg = s["jcfg"], s["tcfg"]
    if window:
        jcfg, tcfg = (c.replace(decode_window=window) for c in (jcfg, tcfg))
    jm, tm = jbuild(jcfg), build(tcfg)
    assert isinstance(tm, encdec.EncDecModel)
    long = window is not None
    jl, jc = jm.prefill(s["jp"], jbatch(s["batch"]), use_decode_window=long,
                        max_new_tokens=6)
    tl, tc = tm.prefill(s["tp"], tbatch(s["batch"]), use_decode_window=long,
                        max_new_tokens=6)
    n_enc, n_dec = tcfg.enc_layers, tcfg.num_layers
    assert flash_calls == ([(30, 30, False)] * n_enc
                           + [(20, 20, True), (20, 30, False)] * n_dec)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    want_cache, got_cache = flat_paths(jc), flatten(tc)
    assert list(got_cache) == list(want_cache)
    for name, leaf in want_cache.items():
        assert_close(got_cache[name].numpy(), leaf, name)
    del flash_calls[:]
    for i in range(6):
        tok = s["more"][:, i:i + 1]
        jl, jc = jm.decode_step(s["jp"], jc, jnp.asarray(tok))
        tl, tc = tm.decode_step(s["tp"], tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"step {i}")
    assert flash_calls == [(1, 30, False)] * (6 * n_dec)
    for name, leaf in flat_paths(jc).items():
        assert_close(flatten(tc)[name].numpy(), leaf, name)


def test_model_init_cache_matches_reference(model_pair):
    jm, tm = jbuild(model_pair["jcfg"]), build(model_pair["tcfg"])
    for kw in (dict(), dict(long=True), dict(src_len=77)):
        want = flat_paths(jm.init_cache(3, 9000, **kw))
        got = flatten(tm.init_cache(3, 9000, device="cpu", **kw))
        assert list(got) == list(want)
        for name, leaf in want.items():
            assert tuple(got[name].shape) == leaf.shape, (kw, name)
            assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype)
            assert not got[name].any()


def test_model_masked_loss_and_gradients(model_pair):
    s = model_pair
    mask = (np.random.default_rng(8).random((2, 20)) < 0.5).astype(
        np.float32)
    batch = dict(s["batch"], loss_mask=mask)
    jm, tm = jbuild(s["jcfg"]), build(s["tcfg"])
    want, wmet = jm.train_loss(s["jp"], jbatch(batch))
    params = {k: v.clone().requires_grad_(True)
              for k, v in s["tp"].params().items()}
    got, gmet = tm.train_loss(params, tbatch(batch))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert gmet["aux"] == 0.0 and float(wmet["aux"]) == 0.0
    got.backward()
    grads = flat_paths(jax.grad(lambda p: jm.train_loss(
        p, jbatch(batch))[0])(s["jp"]))
    for name, g in grads.items():
        assert_close(params[name].grad.numpy(), np.asarray(g), name)
