"""The port's train step (``repro_torch.launch.steps.make_train_step``)
against the reference's (``repro.launch.steps.make_train_step``), for
the char-LM and each of the ten zoo configs at SMOKE size, in f32, from
the same JAX-initialised parameters (``models/convert.py``): loss,
parameters and AdamW's moments after two steps on the same batch,
without and with a freezing mask at k = 1, at microbatches 1 and 2.
This is also the full models' gradient parity check: the first moment
after two steps is 0.19 g1 + 0.1 g2 (no bias correction), the second
0.001999 g1^2 + 0.001 g2^2.

Then the reference's memory design on the port's gradient path: a train
step calls no flash attention (the route switch in ``models/layers.py``
sends attention to the kernel whenever the gradient is off, and a
recompute that ran without it would take the kernel's route), and the
recomputed loss equals the plain one bit for bit on the CPU, value and
gradients.

Tolerances (per family, ``TOL``): the loss within 1e-5 relative (fp32
sums in other orders: the port's loops where the reference scans); the
moments within ``mom`` of the leaf's largest magnitude. Parameters
within ``param`` x LR absolute, and all but a share ``share`` of their
elements within 0.01 LR: AdamW divides the first moment by the square
root of the second (plus eps = 1e-8), so an element whose gradient is
of the order of eps turns a gap in the last digits of its gradient into
a gap of a few percent of one step; every other step is held to 1% of
LR, which catches a wrong sign, scale, decay or mask of any step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.core.freezing import mask_tree as j_mask_tree  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.core.freezing import mask_tree  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build, params_from_numpy  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

ARCHS = ["charlm-shakespeare", *ARCH_IDS]
B, S, STEPS = 4, 32, 2
LR, WD = 1e-3, 0.01
LOSS_RTOL = 1e-5
#: per family: the moments within ``mom`` of the leaf's largest
#: magnitude; the parameters within ``param`` x LR, and at most a share
#: ``share`` of their elements more than 0.01 LR apart (measured: at
#: most 0.11 LR and 12 elements in 1,018,112 but xLSTM's sLSTM, 0.28 LR
#: and 125 in 578,184; moments 3.0e-5)
TOL = {arch: dict(mom=1e-4, param=0.2, share=1e-4) for arch in ARCHS}
TOL["xlstm-1.3b"] = dict(mom=1e-4, param=0.5, share=5e-4)


@pytest.fixture(scope="module")
def cases():
    return {}


def run_pair(cases, arch, microbatches, masked):
    """Both packages' two steps from the same parameters and batch ->
    (reference's (loss, params, mu, nu), port's, initial params), as flat
    NumPy dicts. The reference's masked step is compiled once per config
    and microbatch count; the unmasked case runs it with a mask of ones
    (x 1.0 is exact, so that is the unmasked step's arithmetic)."""
    key = (arch, microbatches, masked)
    if key in cases:
        return cases[key]
    jcfg, tcfg = j_get_smoke(arch), get_smoke_config(arch)
    if (arch, microbatches) not in cases:
        jopt = j_make_optimizer("adamw", LR, WD)
        npp = cases.get(arch) or jax_params(jcfg, seed=1)
        cases[arch] = npp
        cases[arch, microbatches] = jopt, jax.jit(j_make_train_step(
            jbuild(jcfg), jopt, True, microbatches))
    npp = cases[arch]
    jopt, jstep = cases[arch, microbatches]
    batch = synthetic_batch(tcfg, B, S, seed=3)

    jp = jax.tree.map(jnp.asarray, npp)
    jstate = jopt.init(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmask = j_mask_tree(jp, jcfg, 1)
    if not masked:
        jmask = jax.tree.map(jnp.ones_like, jmask)
    for _ in range(STEPS):
        jp, jstate, jloss = jstep(jp, jstate, jb, jmask)
    want = (float(jloss), flat_paths(jax.tree.map(np.asarray, jp)),
            flat_paths(jax.tree.map(np.asarray, jstate.mu)),
            flat_paths(jax.tree.map(np.asarray, jstate.nu)))

    topt = make_optimizer("adamw", LR, WD)
    tp = params_from_numpy(npp, "cpu").params()
    tstate = topt.init(tp)
    tstep = make_train_step(build(tcfg), topt, masked, microbatches)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    extra = (mask_tree(tp, tcfg, 1),) if masked else ()
    for _ in range(STEPS):
        tp, tstate, tloss = tstep(tp, tstate, tb, *extra)
    assert int(tstate.count) == STEPS
    got = (float(tloss), {k: v.numpy() for k, v in tp.items()},
           {k: v.numpy() for k, v in tstate.mu.items()},
           {k: v.numpy() for k, v in tstate.nu.items()})
    cases[key] = (want, got, npp)
    return cases[key]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "k1"])
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(cases, arch, microbatches, masked):
    want, got, npp = run_pair(cases, arch, microbatches, masked)
    tol = TOL[arch]
    assert got[0] == pytest.approx(want[0], rel=LOSS_RTOL)
    apart = total = 0
    for i, what in ((1, "param"), (2, "mu"), (3, "nu")):
        assert list(got[i]) == list(want[i]), what
        for name, w in want[i].items():
            g = got[i][name]
            assert g.shape == w.shape and g.dtype == w.dtype, name
            atol = (tol["param"] * LR if what == "param"
                    else tol["mom"] * max(float(np.abs(w).max()), 1e-30))
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{what} {name}")
            if what == "param":
                apart += int(np.sum(np.abs(g - w) > 0.01 * LR))
                total += w.size
    assert apart <= tol["share"] * total, (apart, total)
    if masked:
        # k = 1: every frozen leaf keeps its bits; its moments stay 0
        frozen = mask_tree(params_from_numpy(npp, "cpu"),
                           get_smoke_config(arch), 1)
        before = flat_paths(npp)
        for name, m in frozen.items():
            m = np.broadcast_to(m.numpy(), before[name].shape) == 0
            np.testing.assert_array_equal(got[1][name][m], before[name][m],
                                          err_msg=name)
            assert not np.any(got[2][name][m]), name


@pytest.mark.parametrize("arch", ["gemma2-9b", "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v3-671b", "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_train_step_calls_no_flash_attention(arch, monkeypatch):
    """Attention under the step's gradient, the recompute's included, is
    ``blockwise_attention``: ``ops.flash_attention`` is never called and
    the kernel's launch count stays 0."""
    cfg = get_smoke_config(arch)
    calls = []
    real = ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    ops.reset_launches()
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").params()
    opt = make_optimizer("adamw", LR)
    step = make_train_step(model, opt, microbatches=2)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, B, S, seed=1).items()}
    _, _, loss = step(params, opt.init(params), batch)
    assert torch.isfinite(loss)
    assert calls == [] and ops.LAUNCHES["flash_attention_bhsd"] == 0
    # the same model without a gradient takes the flash route
    model.prefill(params, batch)
    assert calls


@pytest.mark.parametrize("arch", ["charlm-shakespeare", *ARCH_IDS])
def test_recompute_changes_no_value(arch):
    """``train_loss(..., remat=True)`` (each unit, encoder and decoder
    layer and loss chunk recomputed in the backward pass) against
    ``remat=False``: equal loss and gradients, bit for bit, on the
    CPU."""
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(2), "cpu").params()
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 2, 64, seed=4).items()}
    out = []
    for remat in (False, True):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, _ = model.train_loss(leaves, batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(leaves.values()))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for name, a, b in zip(params, g0, g1):
        assert torch.equal(a, b), name


def test_chunked_loss_matches_reference(monkeypatch):
    """The chunk rule (``_ce_chunk_size``) equal to the reference's over a
    grid; then ``ce_loss`` with a mask and a softcap against
    ``chunked_ce_loss``, both packages held to 16-position chunks (three
    of them: a SMOKE size takes one), with and without the recompute;
    an all-zero mask gives 0."""
    import repro.models.zoo as jzoo
    import repro_torch.models.zoo as tzoo
    for b in (1, 2, 8, 256):
        for v in (65, 32_000, 256_000, 3_000_000):
            for s in (1, 31, 96, 1000, 4096, 6000):
                assert tzoo._ce_chunk_size(b, v, s) == \
                    jzoo._ce_chunk_size(b, v, s), (b, v, s)
    monkeypatch.setattr(jzoo, "_ce_chunk_size", lambda b, v, s: 16)
    monkeypatch.setattr(tzoo, "_ce_chunk_size", lambda b, v, s: 16)
    rng = np.random.default_rng(0)
    b, s, d, v = 2, 48, 16, 40
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    t = rng.integers(0, v, (b, s)).astype(np.int32)
    m = (rng.random((b, s)) < 0.7).astype(np.float32)
    tx, tw, tt, tm = (torch.from_numpy(a) for a in (x, w, t, m))
    for softcap in (None, 30.0):
        want = jzoo.chunked_ce_loss(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t), jnp.asarray(m), softcap)
        for remat in (False, True):
            got = tzoo.ce_loss(tx, tw, tt, softcap, tm, remat)
            assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(tzoo.ce_loss(tx, tw, tt, None, torch.zeros(b, s))) == 0.0


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_freezing_mask_of_a_suffixed_stack(k):
    """RecurrentGemma's remainder layers (``stack.suffix``: layers 3 and
    4 of 5 at SMOKE size, after one (rec, rec, attn) unit) freeze by
    their own layer index, as in the reference."""
    jcfg = j_get_smoke("recurrentgemma-2b")
    npp = jax_params(jcfg, seed=1)
    want = flat_paths(j_mask_tree(jax.tree.map(jnp.asarray, npp), jcfg, k))
    got = mask_tree(params_from_numpy(npp, "cpu"),
                    get_smoke_config("recurrentgemma-2b"), k)
    assert any(name.startswith("stack.suffix") for name in got)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
