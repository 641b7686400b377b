"""The model zoo of the port (Qwen2, Mistral-Large, Minitron, PaliGemma,
Phi-3.5-MoE, DeepSeek-V3; RecurrentGemma, xLSTM, SeamlessM4T) against
the JAX package, each at its SMOKE size, from JAX-initialised parameters
bridged by
``repro_torch.models.convert``; then the registry, the configs, the
list-valued parameter subtrees and the new layouts' round trips, the
freezing mask of a prefixed stack, ``synthetic_batch``, the schedules
and the optimizer utilities. SeamlessM4T's batch carries 40 source
frames beside its 48 target tokens.

As ``tests/test_arch_smoke.py`` does, the MoE configs run at capacity
factor 8 (no token is dropped, so decode and a prefill over the same
tokens agree); ``tests/test_torch_moe.py`` holds the MoE layer at the
configs' own 1.25, with drops.

Tolerances: every SMOKE config is fp32 in both packages, with sums in
other orders (the port's prefill attention is the flash twin, the
reference's its blockwise path; the port's CE one sum, the reference's
chunked), so prefill logits, caches and 12 decode steps are held to
1e-5 absolute (values of order 1), ``train_loss``'s ce and aux to 1e-5
relative. The recurrent states that sum over the whole prompt (RG-LRU
``h``, the mLSTM's ``C``, ``n``, ``m``, the sLSTM's ``h``, ``c``,
``n``, ``m``) are held to 1e-5 of max(1, their largest magnitude): the
sLSTM's normaliser ``n`` reaches ~13 at SMOKE size, and fp32 rounding
scales with the value (measured gap 2.4e-5 there, 1.9e-6 relative).
Parameter paths, shapes and counts, synthetic batches and the
schedules are exact; the optimizer utilities within 1e-6 relative (fp32
sums in one order in both).

Inputs come from numpy seeds and go to both packages as the same
arrays. The card's tests of these configs are in
``tests/test_torch_zoo_card.py``, which needs no JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402
from repro_torch.models.convert import (flatten, params_to_numpy,  # noqa: E402
                                        unflatten)

ATOL = 1e-5
LOSS_RTOL = 1e-5
B, PROMPT, STEPS = 2, 48, 12
NEW = ["qwen2-72b", "mistral-large-123b", "minitron-8b", "paligemma-3b",
       "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "recurrentgemma-2b",
       "xlstm-1.3b", "seamless-m4t-medium"]
RECURRENT = ["recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-medium"]
#: recurrent-state cache leaves (see the module docstring)
STATES = ("h", "c", "n", "m", "C")
SRC = 40


def flash_per_prefill(cfg) -> int:
    """Attention calls of one prefill: each attention layer's, and under
    an encoder-decoder each encoder layer's and each decoder layer's self-
    and cross-attention."""
    if cfg.encdec:
        return cfg.enc_layers + 2 * cfg.num_layers
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))


def no_drops(cfg):
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def make_batch(cfg, seed=0):
    """NumPy tokens (B, PROMPT + STEPS), the prompt's batch and, for a
    vision frontend, its patch embeddings; for an encoder-decoder, SRC
    source frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, PROMPT + STEPS)).astype(
        np.int32)
    batch = {"tokens": toks[:, :PROMPT], "targets": toks[:, 1:PROMPT + 1]}
    if cfg.encdec:
        batch["src_embeds"] = rng.normal(
            size=(B, SRC, cfg.frontend.embed_dim)).astype(np.float32)
    elif cfg.frontend is not None:
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.frontend.num_prefix_tokens,
                  cfg.frontend.embed_dim)).astype(np.float32)
    return toks, batch


@pytest.fixture(scope="module")
def pairs():
    """``pair``'s results by arch, computed once per module."""
    return {}


def pair(pairs, arch):
    """Both packages' SMOKE model of ``arch`` (capacity factor 8) from the
    same JAX-initialised parameters, and the reference's prefill and 12
    decode steps."""
    if arch not in pairs:
        jcfg, tcfg = no_drops(j_get_smoke(arch)), no_drops(
            get_smoke_config(arch))
        npp = jax_params(jcfg, seed=1)
        jm = jbuild(jcfg)
        jp = jax.tree.map(jnp.asarray, npp)
        toks, batch = make_batch(tcfg)
        jlogits, jcache = jax.jit(lambda p, b: jm.prefill(
            p, b, max_new_tokens=STEPS))(jp, {k: jnp.asarray(v)
                                              for k, v in batch.items()})
        prefill = (np.asarray(jlogits), flat_np(jcache))
        jstep = jax.jit(jm.decode_step)
        decode = []
        for t in range(STEPS):
            jl, jcache = jstep(jp, jcache, jnp.asarray(
                toks[:, PROMPT + t:PROMPT + t + 1]))
            decode.append(np.asarray(jl))
        pairs[arch] = dict(
            jcfg=jcfg, tcfg=tcfg, np_params=npp, jmodel=jm, jp=jp,
            tmodel=build(tcfg), tp=params_from_numpy(npp, "cpu"), toks=toks,
            batch=batch, prefill=prefill, decode=decode,
            decode_cache=flat_np(jcache))
    return pairs[arch]


def flat_np(tree):
    """A cache tree (either package) -> {path: numpy}, in JAX's order."""
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flat_paths(tree).items()}


def assert_caches_close(got, want):
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        if name.endswith("index"):
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
        elif name.split(".")[-1] in STATES:
            atol = ATOL * max(1.0, float(np.abs(want[name]).max()))
            np.testing.assert_allclose(got[name], want[name], atol=atol,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=ATOL,
                                       rtol=0, err_msg=name)


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------


def _as_compared(value):
    if isinstance(value, torch.dtype):
        return str(value).split(".")[-1]
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    return value


@pytest.mark.parametrize("arch", NEW)
def test_configs_match_reference(arch):
    """Every field of CONFIG and SMOKE has the reference's value (dtypes
    by name, sub-configs field for field)."""
    for port, want in ((get_config(arch), j_get_config(arch)),
                       (get_smoke_config(arch), j_get_smoke(arch))):
        for f in dataclasses.fields(port):
            got, ref_value = getattr(port, f.name), getattr(want, f.name)
            if isinstance(got, torch.dtype):
                assert _as_compared(got) == str(np.dtype(ref_value)), f.name
            else:
                assert _as_compared(got) == _as_compared(ref_value), \
                    (arch, f.name)


def test_registry():
    """Every architecture of the reference resolves, in its order, and
    builds (the encoder-decoder as ``EncDecModel``); an unknown id
    raises ``KeyError``."""
    from repro.configs import ARCH_IDS as J_ARCH_IDS
    from repro_torch.models.encdec import EncDecModel
    assert ARCH_IDS == J_ARCH_IDS
    assert set(NEW) | {"gemma2-9b"} == set(ARCH_IDS)
    for arch in RECURRENT:
        model = build(get_config(arch))
        assert model.cfg.name == arch
        assert isinstance(model, EncDecModel) == (arch == RECURRENT[-1])
        assert build(get_smoke_config(arch)).param_count()["total"] > 0
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ---------------------------------------------------------------------------
# each config against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW)
def test_parameters_match_reference(pairs, arch):
    """Paths (JAX leaf order, lists by index), shapes, the port's own
    init's shapes, and total and active counts, at SMOKE and full
    size."""
    s = pair(pairs, arch)
    want = flat_paths(s["np_params"])
    got = s["tp"].params()
    assert list(got) == list(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name
    own = s["tmodel"].init(torch.Generator().manual_seed(0), "cpu").params()
    assert [(n, tuple(t.shape), t.dtype) for n, t in own.items()] == \
        [(n, tuple(t.shape), t.dtype) for n, t in got.items()]
    assert s["tmodel"].param_count() == s["jmodel"].param_count()
    assert build(get_config(arch)).param_count() == \
        jbuild(j_get_config(arch)).param_count()


@pytest.mark.parametrize("arch", NEW)
def test_train_loss_matches_reference(pairs, arch):
    s = pair(pairs, arch)
    want, wmet = jax.jit(s["jmodel"].train_loss)(
        s["jp"], {k: jnp.asarray(v) for k, v in s["batch"].items()})
    params = {k: v.clone().requires_grad_(True)
              for k, v in s["tp"].params().items()}
    got, gmet = s["tmodel"].train_loss(params, tbatch(s["batch"]))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=LOSS_RTOL)
    for name in ("ce", "aux"):
        value = gmet[name]
        value = float(value.detach() if torch.is_tensor(value) else value)
        assert value == pytest.approx(float(wmet[name]), rel=LOSS_RTOL), name
    if s["tcfg"].moe is not None:
        assert float(gmet["aux"].detach()) > 0
    assert all(torch.isfinite(p.grad).all() for p in params.values())


@pytest.mark.parametrize("arch", NEW)
def test_prefill_matches_reference(pairs, arch, monkeypatch):
    """Logits and caches of a 48-token prompt (PaliGemma: plus its 8
    patch tokens; SeamlessM4T: over 40 source frames) through
    ``make_prefill_step``, each attention on the flash route (xLSTM has
    none)."""
    s = pair(pairs, arch)
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[2].shape[-1])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    step = steps.make_prefill_step(s["tmodel"], INPUT_SHAPES["prefill_32k"],
                                   max_new_tokens=STEPS)
    logits, caches = step(s["tp"], tbatch(s["batch"]))
    cfg = s["tcfg"]
    assert len(calls) == flash_per_prefill(cfg)
    if cfg.mla:      # v zero-padded to the q/k width
        assert set(calls) == {cfg.mla.qk_nope_head_dim
                              + cfg.mla.qk_rope_head_dim}
    assert logits.shape == (B, 1, cfg.vocab_size)
    want_logits, want_cache = s["prefill"]
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL, rtol=0)
    assert_caches_close(flat_np(caches), want_cache)


@pytest.mark.parametrize("arch", NEW)
def test_decode_matches_reference(pairs, arch):
    """12 decode steps after the prompt, fed the same tokens: logits at
    every step and the final caches; and the last step against a prefill
    over the whole sequence."""
    s = pair(pairs, arch)
    tm = s["tmodel"]
    _, caches = tm.prefill(s["tp"], tbatch(s["batch"]), max_new_tokens=STEPS)
    step = steps.make_decode_step(tm)
    for t in range(STEPS):
        tok = s["toks"][:, PROMPT + t:PROMPT + t + 1]
        logits, caches = step(s["tp"], caches, torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), s["decode"][t], atol=ATOL,
                                   rtol=0, err_msg=f"step {t}")
    assert_caches_close(flat_np(caches), s["decode_cache"])
    full = dict(tbatch(s["batch"]), tokens=torch.from_numpy(s["toks"]))
    want, _ = tm.prefill(s["tp"], full)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ["paligemma-3b", "deepseek-v3-671b",
                                  *RECURRENT])
def test_init_cache_matches_reference(pairs, arch):
    s = pair(pairs, arch)
    got = flat_np(s["tmodel"].init_cache(B, 10_000, long=True, device="cpu"))
    want = flat_np(s["jmodel"].init_cache(B, 10_000, long=True))
    assert list(got) == list(want)
    for name in want:
        assert got[name].shape == want[name].shape and \
            got[name].dtype == want[name].dtype, name


def test_loss_mask_matches_reference(pairs):
    """PaliGemma with a 0/1 loss mask over the text: the masked mean
    after the patch tokens are cut."""
    s = pair(pairs, "paligemma-3b")
    mask = (np.random.default_rng(4).random((B, PROMPT)) < 0.6).astype(
        np.float32)
    batch = dict(s["batch"], loss_mask=mask)
    want, wmet = jax.jit(s["jmodel"].train_loss)(
        s["jp"], {k: jnp.asarray(v) for k, v in batch.items()})
    got, gmet = s["tmodel"].train_loss(s["tp"], tbatch(batch))
    assert float(got) == pytest.approx(float(want), rel=LOSS_RTOL)
    unmasked, _ = s["tmodel"].train_loss(s["tp"], tbatch(s["batch"]))
    assert float(unmasked) != pytest.approx(float(got), rel=1e-3)


# ---------------------------------------------------------------------------
# layout, freezing, data, schedules, optimizer utilities
# ---------------------------------------------------------------------------


def test_list_subtrees_round_trip(pairs):
    """DeepSeek's prefix list: a 12-item list keeps numeric order (item 2
    before item 10) in the flat dict, and params_to_numpy gives JAX's
    tree back."""
    s = pair(pairs, "deepseek-v3-671b")
    tree = params_to_numpy(s["tp"])
    assert isinstance(tree["stack"]["prefix"], list)
    assert flat_paths(tree).keys() == flat_paths(s["np_params"]).keys()
    for name, leaf in flat_paths(s["np_params"]).items():
        np.testing.assert_array_equal(flat_paths(tree)[name], leaf)
    big = {"prefix": [{"w": np.full((1,), i)} for i in range(12)],
           "units": {"b0": {"w": np.zeros(2)}}}
    flat = flatten(big)
    assert list(flat) == list(flat_paths(big))
    assert list(flat)[:3] == ["prefix.0.w", "prefix.1.w", "prefix.2.w"]
    back = unflatten(params_from_numpy(big, "cpu").params())
    assert [int(p["w"][0]) for p in back["prefix"]] == list(range(12))


@pytest.mark.parametrize("arch", RECURRENT)
def test_new_layouts_round_trip(pairs, arch):
    """``params_from_numpy`` -> ``params_to_numpy`` gives the JAX tree
    back, leaf for leaf and dtype for dtype: RecurrentGemma's
    ``stack.suffix`` list and ``rec`` blocks, xLSTM's ``mlstm`` /
    ``slstm`` blocks, SeamlessM4T's top-level ``io`` / ``enc`` / ``dec``
    (with ``io.enc_norm``, ``io.frontend_proj``); the fp32 leaves of a
    bf16 model stay fp32."""
    s = pair(pairs, arch)
    tree = params_to_numpy(s["tp"])
    want = flat_paths(s["np_params"])
    assert list(flat_paths(tree)) == list(want)
    for name, leaf in want.items():
        got = flat_paths(tree)[name]
        assert got.dtype == leaf.dtype, name
        np.testing.assert_array_equal(got, leaf, err_msg=name)
    expect = {"recurrentgemma-2b": ["stack.suffix.1.rec.lambda_raw",
                                    "stack.units.b2.attn.wq"],
              "xlstm-1.3b": ["stack.units.b0.mlstm.w_f",
                             "stack.units.b1.slstm.b_in"],
              "seamless-m4t-medium": ["io.enc_norm.bias",
                                      "io.frontend_proj",
                                      "dec.cross_attn.wk", "enc.attn.wo"]}
    for name in expect[arch]:
        assert name in want, name
    from repro.configs import get_config as jcfg_of
    full = jbuild(jcfg_of(arch).replace(num_layers=s["jcfg"].num_layers))
    shapes = jax.eval_shape(full.init, jax.random.PRNGKey(0))
    bf16 = build(get_config(arch).replace(num_layers=s["tcfg"].num_layers))
    own = bf16._init_tree(None, torch.device("meta"))
    for name, leaf in flat_paths(shapes).items():
        assert str(flatten(own)[name].dtype).split(".")[-1] == \
            str(leaf.dtype), name


@pytest.mark.parametrize("k", [1, 2, 3])
def test_freezing_mask_of_a_prefixed_stack(pairs, k):
    """The dense prefix layer freezes by its own layer index, as in the
    reference (DeepSeek SMOKE: 1 prefix layer, 2 units)."""
    from repro.core.freezing import mask_tree as j_mask_tree
    from repro_torch.core.freezing import mask_tree
    s = pair(pairs, "deepseek-v3-671b")
    want = flat_paths(j_mask_tree(s["jp"], s["jcfg"], k))
    got = mask_tree(s["tp"], s["tcfg"], k)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


@pytest.mark.parametrize("arch", ["paligemma-3b", "phi3.5-moe-42b-a6.6b",
                                  *RECURRENT])
def test_synthetic_batch_equal(arch):
    from repro.data.synthetic import synthetic_batch as j_batch
    from repro_torch.data import synthetic_batch
    got = synthetic_batch(get_smoke_config(arch), 3, 40, seed=7)
    want = j_batch(j_get_smoke(arch), 3, 40, seed=7)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype
        np.testing.assert_array_equal(got[name], want[name])


def test_schedules_equal():
    from repro.optim import schedules as js
    from repro_torch.optim import schedules as ts
    pairs = [(js.constant(3e-4), ts.constant(3e-4)),
             (js.warmup_cosine(1e-3, 10, 100), ts.warmup_cosine(1e-3, 10,
                                                                 100)),
             (js.warmup_cosine(1e-3, 0, 50, 0.2), ts.warmup_cosine(1e-3, 0,
                                                                   50, 0.2)),
             (js.inverse_sqrt(2e-3, 16), ts.inverse_sqrt(2e-3, 16)),
             (js.inverse_sqrt(2e-3, 0), ts.inverse_sqrt(2e-3, 0))]
    for want, got in pairs:
        for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 250):
            assert got(step) == want(step)
    for rule in ("linear", "sqrt", "none"):
        for accum in (1, 2, 3, 8):
            assert ts.scale_lr_for_accum(1e-3, accum, rule) == \
                js.scale_lr_for_accum(1e-3, accum, rule)


def test_optimizer_utilities_equal():
    from repro.optim import optimizers as jo
    from repro_torch.optim import optimizers as to
    rng = np.random.default_rng(5)
    tree = {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    upd = {"a": rng.normal(size=(4, 3)).astype(np.float32),
           "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    jt = jax.tree.map(jnp.asarray, tree)
    tt = {k: torch.from_numpy(v) for k, v in flatten(tree).items()}
    tu = {k: torch.from_numpy(v) for k, v in flatten(upd).items()}
    want = flat_paths(jo.apply_updates(jt, jax.tree.map(jnp.asarray, upd)))
    got = to.apply_updates(tt, tu)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert float(to.global_norm(tt)) == pytest.approx(
        float(jo.global_norm(jt)), rel=1e-6)
    for max_norm in (0.5, 100.0):
        wc, wn = jo.clip_by_global_norm(jt, max_norm)
        gc, gn = to.clip_by_global_norm(tt, max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        for name, leaf in flat_paths(wc).items():
            np.testing.assert_allclose(gc[name].numpy(), np.asarray(leaf),
                                       rtol=1e-6)
