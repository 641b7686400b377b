"""The port's serving path (prefill, decode, caches) against the JAX
package, at Gemma2's SMOKE size, from JAX-initialised parameters bridged
by ``repro_torch.models.convert``; and the char-LM eval, whose attention
now takes the flash route.

Gemma2 SMOKE is fp32 with a local window of 32: a 48-token prompt is
longer than the window, and 12 decode steps after it roll the local
layers' buffers. Both packages run fp32 with sums in other orders (the
port's prefill attention is the flash twin, the reference's its
blockwise path), so logits, caches and losses are held to 1e-5
(absolute for logits and caches, whose values are of order 1;
relative for the eval loss).

Inputs come from numpy seeds and go to both packages as the same
arrays.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params, tiny_setup  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs.gemma2_9b import SMOKE as J_SMOKE  # noqa: E402
from repro.core.server import make_eval_fn as j_make_eval_fn  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.configs.gemma2_9b import SMOKE  # noqa: E402
from repro_torch.core.server import make_eval_fn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402

ATOL = 1e-5
LOSS_RTOL = 1e-5
B, PROMPT, STEPS = 2, 48, 12


@pytest.fixture(scope="module")
def gemma():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, SMOKE.vocab_size, (B, PROMPT + STEPS)).astype(
        np.int32)
    jp = jax_params(J_SMOKE, seed=1)
    return {"jmodel": jbuild(J_SMOKE), "jp": jax.tree.map(jnp.asarray, jp),
            "tmodel": build(SMOKE), "tp": params_from_numpy(jp, "cpu"),
            "toks": toks, "np_params": jp}


def flat_np(tree):
    """A cache tree (either package) -> {path: numpy}, in JAX's order."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flat_paths(tree).items()}


def assert_caches_close(got, want):
    g, w = flat_np(got), flat_np(want)
    assert list(g) == list(w)
    for name in w:
        assert g[name].shape == w[name].shape, name
        if name.endswith("index"):
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)
        else:
            np.testing.assert_allclose(g[name], w[name], atol=ATOL, rtol=0,
                                       err_msg=name)


def test_configs_match_reference():
    """Every field the port keeps has the reference's value, for
    Gemma2-9B, its SMOKE and the char-LM (whose norm, MLP, tying and
    positions must stay the reference's, not the new defaults)."""
    from repro_torch.configs.charlm_shakespeare import CONFIG as T_CHARLM
    for port, want in ((get_config("gemma2-9b"), j_get_config("gemma2-9b")),
                       (SMOKE, J_SMOKE),
                       (T_CHARLM, j_get_config("charlm-shakespeare"))):
        for f in dataclasses.fields(port):
            got, ref_value = getattr(port, f.name), getattr(want, f.name)
            if isinstance(got, torch.dtype):
                assert str(got).split(".")[-1] == str(np.dtype(ref_value)), \
                    f.name
            else:
                assert got == ref_value, (port.name, f.name)
    for name, shape in J_SHAPES.items():
        assert dataclasses.asdict(INPUT_SHAPES[name]) == \
            dataclasses.asdict(shape)


def test_parameter_layout_and_count_match(gemma):
    want = flat_paths(gemma["np_params"])
    got = gemma["tp"].params()
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
    # 2 layers = 1 unit of (local b0, global b1), with post-norms
    assert tuple(got["stack.units.b1.post2.scale"].shape) == (1, 128)
    assert "io.pos_embed" not in got
    own = gemma["tmodel"].init(torch.Generator().manual_seed(0),
                               "cpu").params()
    assert [(n, tuple(t.shape)) for n, t in own.items()] == \
        [(n, leaf.shape) for n, leaf in want.items()]
    assert gemma["tmodel"].param_count() == gemma["jmodel"].param_count()
    full = get_config("gemma2-9b")
    assert build(full).param_count() == \
        jbuild(j_get_config("gemma2-9b")).param_count()


def test_bf16_tree_bridges_bit_for_bit():
    jp = jax_params(J_SMOKE.replace(param_dtype=jnp.bfloat16), seed=2)
    tp = params_from_numpy(jp, "cpu").params()
    for name, leaf in flat_paths(jp).items():
        assert tp[name].dtype == torch.bfloat16, name
        np.testing.assert_array_equal(
            tp[name].view(torch.int16).numpy(), leaf.view(np.int16))


def _prefill_both(gemma, n_tokens, max_new_tokens):
    toks = gemma["toks"][:, :n_tokens]
    # the reference's step function passes max_new_tokens=0: call its
    # model's prefill, as its own decode tests do
    jlogits, jcache = jax.jit(lambda p, b: gemma["jmodel"].prefill(
        p, b, max_new_tokens=max_new_tokens))(gemma["jp"],
                                              {"tokens": jnp.asarray(toks)})
    tstep = steps.make_prefill_step(gemma["tmodel"],
                                    INPUT_SHAPES["prefill_32k"],
                                    max_new_tokens=max_new_tokens)
    tlogits, tcache = tstep(gemma["tp"], {"tokens": torch.from_numpy(toks)})
    return jlogits, jcache, tlogits, tcache


def test_prefill_matches_reference(gemma):
    jlogits, jcache, tlogits, tcache = _prefill_both(gemma, PROMPT, STEPS)
    assert tlogits.shape == (B, 1, SMOKE.vocab_size)
    assert tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=0)
    # local layer: the window's 32 slots, rolled; global: 48 + 12 slots
    assert tuple(tcache["units"]["b0"]["k"].shape) == (1, B, 32, 2, 32)
    assert tuple(tcache["units"]["b1"]["k"].shape) == (1, B, 60, 2, 32)
    assert_caches_close(tcache, jcache)


def test_decode_matches_reference_past_the_window(gemma):
    """12 decode steps after a 48-token prompt (the local buffers roll
    over), fed the same tokens: logits at every step and the final
    caches match the reference's."""
    _, jcache, _, tcache = _prefill_both(gemma, PROMPT, STEPS)
    jstep = jax.jit(jsteps.make_decode_step(gemma["jmodel"]))
    tstep = steps.make_decode_step(gemma["tmodel"])
    for t in range(STEPS):
        tok = gemma["toks"][:, PROMPT + t:PROMPT + t + 1]
        jlogits, jcache = jstep(gemma["jp"], jcache, jnp.asarray(tok))
        tlogits, tcache = tstep(gemma["tp"], tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0, err_msg=f"step {t}")
    assert_caches_close(tcache, jcache)
    # and decode agrees with a prefill over the whole sequence
    full, _ = gemma["tmodel"].prefill(gemma["tp"], {
        "tokens": torch.from_numpy(gemma["toks"])})
    np.testing.assert_allclose(tlogits.numpy(), full.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("long", [False, True])
def test_init_cache_matches_reference(gemma, long):
    got = gemma["tmodel"].init_cache(B, 10_000, long=long, device="cpu")
    want = gemma["jmodel"].init_cache(B, 10_000, long=long)
    g, w = flat_np(got), flat_np(want)
    assert list(g) == list(w)
    for name in w:
        assert g[name].shape == w[name].shape and \
            g[name].dtype == w[name].dtype, name
        assert not g[name].any(), name


def test_train_loss_matches_reference(gemma):
    """The differentiable path (window, softcap, post-norms, GeGLU, the
    final softcap in the loss) against the reference's train loss."""
    toks = gemma["toks"][:, :PROMPT]
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    want, _ = jax.jit(gemma["jmodel"].train_loss)(
        gemma["jp"], {k: jnp.asarray(v) for k, v in batch.items()})
    params = {k: v.clone().requires_grad_(True)
              for k, v in gemma["tp"].params().items()}
    got, _ = gemma["tmodel"].train_loss(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)


def test_charlm_decode_matches_reference():
    """The char-LM through prefill and decode: layer norms, the learned
    position of each decoded token read from the stacked cache index."""
    _, jcfg, _, tcfg, _ = tiny_setup()
    jp = jax_params(jcfg)
    jmodel, tmodel = jbuild(jcfg), build(tcfg)
    tp = params_from_numpy(jp, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                             (2, 20)).astype(np.int32)
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(
        p, b, max_new_tokens=8))(jp, {"tokens": jnp.asarray(toks[:, :16])})
    tlogits, tcache = tmodel.prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :16])}, max_new_tokens=8)
    for t in range(4):
        tok = toks[:, 16 + t:17 + t]
        jlogits, jcache = jax.jit(jmodel.decode_step)(jp, jcache,
                                                      jnp.asarray(tok))
        tlogits, tcache = tmodel.decode_step(tp, tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=ATOL, rtol=0, err_msg=f"step {t}")
    assert_caches_close(tcache, jcache)


def test_attention_routes(gemma, monkeypatch):
    """Prefill (no gradient) sends every layer's attention to
    ``ops.flash_attention``; a forward with a gradient keeps the plain
    differentiable path."""
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    toks = torch.from_numpy(gemma["toks"][:, :PROMPT])
    gemma["tmodel"].prefill(gemma["tp"], {"tokens": toks})
    assert calls == [SMOKE.window, None]            # local b0, global b1
    calls.clear()
    params = {k: v.clone().requires_grad_(True)
              for k, v in gemma["tp"].params().items()}
    loss, _ = gemma["tmodel"].train_loss(params, {"tokens": toks,
                                                  "targets": toks})
    loss.backward()
    assert calls == []


def test_charlm_eval_takes_the_flash_route_and_matches_jax(monkeypatch):
    ds, jcfg, jfl, tcfg, tfl = tiny_setup()
    jp = jax_params(jcfg)
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    want = j_make_eval_fn(jbuild(jcfg), ds, jfl)(
        jax.tree.map(jnp.asarray, jp))
    from repro_torch.data import load_corpus
    tds = load_corpus(target_bytes=60_000)
    got = make_eval_fn(build(tcfg), tds, tfl, device="cpu")(
        params_from_numpy(jp, "cpu"))
    assert len(calls) == tcfg.num_layers * tfl.eval_batches
    assert got == pytest.approx(want, rel=LOSS_RTOL)


def test_serving_entry_points():
    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        steps.make_train_step(None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build(SMOKE).init_cache(1, 8)
