"""The fused AdamW kernel on a card (marked ``cuda``; skips without one),
with no JAX, so that it runs where the port does.

``optim.optimizers.adamw``'s ``update_`` takes a CUDA parameter through
``kernels/adamw.py`` (one launch of ``csrc/optim_kernels.cu`` per
parameter); the same ``update_`` with ``ops.adamw_update_`` sent to the
plain twin (``ref.adamw_update_ref``, the piece path of eager ops, here
on the card too) is the reference. Bit for bit (``torch.equal``) on
every parameter, both moments and the count, after each of 3 steps:

- weights bf16 or fp32, moments fp32 or bf16 (``adamw_bf16``), gradients
  fp32 or bf16; no mask, a 0-d mask per parameter (one of them 0), or a
  mask over leading dims with some rows 0 (rows that end inside a
  kernel's 8-element vector); decay 0.1 and 0; leaves of 0, 1, 2 and 3
  dims, counts not a multiple of 8, an empty one (no launch), a
  parameter and a gradient one element off 16 bytes (the scalar loop),
  and one of 4 Mi elements (the grid strides);
- three ``make_train_step`` steps of a SMOKE Phi-3.5-MoE in bf16 (2
  microbatches, so fp32 gradients; the freezing mask at k = 1), each
  step's gradients fed to both.

Each step launches ``adamw_update`` once per non-empty parameter and
nothing else, and makes no host read (``analysis.runtime.no_syncs``).
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import runtime  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.freezing import mask_tree  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

STEPS = 3
#: name -> shape; "off" is laid one element past a 16-byte boundary
SHAPES = {"w": (6, 33, 40), "u": (3, 5, 7), "b": (37,), "s": (),
          "off": (1001,), "big": (4, 1024, 1024), "empty": (8, 0)}
#: leading-dim masks: rows 0 where listed (u's rows of 35 elements end
#: inside an 8-element vector)
ROWS = {"w": (6, [2, 5]), "u": (3, [1]), "big": (4, [0])}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the AdamW kernel has no CPU mode)")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_path():
    """``ops.adamw_update_`` sent to the plain twin on any device."""
    real = ops.adamw_update_

    def plain(grad, param, mu, nu, mask, count, *, corrections, **kw):
        ref.adamw_update_ref(grad, param, mu, nu, mask, count, **kw)

    ops.adamw_update_ = plain
    try:
        yield
    finally:
        ops.adamw_update_ = real


def offset(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a tensor one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


def make_mask(kind, dev):
    if kind == "none":
        return None
    mask = {k: torch.tensor(0.0 if k == "b" else 1.0, device=dev)
            for k in SHAPES}
    if kind == "rows":
        for k, (n, zeros) in ROWS.items():
            rows = torch.ones(n, device=dev)
            rows[zeros] = 0.0
            mask[k] = rows.reshape((n,) + (1,) * (len(SHAPES[k]) - 1))
    return mask


def assert_same(got_p, got_s, want_p, want_s):
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k
        assert torch.equal(got_s.mu[k], want_s.mu[k]), k
        assert torch.equal(got_s.nu[k], want_s.nu[k]), k
    assert torch.equal(got_s.count, want_s.count)


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [0.1, 0.0])
@pytest.mark.parametrize("mask_kind", ["none", "scalar", "rows"])
@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("grads", ["f32", "bf16"])
@pytest.mark.parametrize("weights", ["f32", "bf16"])
def test_kernel_equals_the_piece_path(card, weights, grads, moments,
                                      mask_kind, decay):
    gen = torch.Generator(device=card).manual_seed(3)
    pdt, gdt = DTYPES[weights], DTYPES[grads]
    init = {k: torch.randn(s, generator=gen, device=card).to(pdt)
            for k, s in SHAPES.items()}
    opt = adamw(1e-2, weight_decay=decay, moment_dtype=DTYPES[moments])
    got_p = {k: v.clone() for k, v in init.items()}
    got_p["off"] = offset(got_p["off"])
    want_p = {k: v.clone() for k, v in init.items()}
    got_s, want_s = opt.init(got_p), opt.init(want_p)
    mask = make_mask(mask_kind, card)
    leaves = sum(1 for s in SHAPES.values() if 0 not in s)
    for _ in range(STEPS):
        grads_ = {k: (torch.randn(s, generator=gen, device=card) * 0.3
                      ).to(gdt) for k, s in SHAPES.items()}
        g = {k: v.clone() for k, v in grads_.items()}
        g["off"] = offset(g["off"])
        before = dict(ops.LAUNCHES)
        with runtime.no_syncs():
            opt.update_(g, got_s, got_p, mask)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert launched["adamw_update"] == leaves
        assert sum(launched.values()) == leaves
        assert g == {}
        with plain_path():
            opt.update_(dict(grads_), want_s, want_p, mask)
        torch.cuda.synchronize()
        assert_same(got_p, got_s, want_p, want_s)
    assert got_p["off"].data_ptr() % 16          # written where it lies
    assert not torch.equal(got_p["w"], init["w"])
    if mask_kind != "none":                      # frozen leaves kept
        assert torch.equal(got_p["b"], init["b"])
    if mask_kind == "rows":
        assert torch.equal(got_p["u"][1], init["u"][1])
        assert not torch.equal(got_p["u"][0], init["u"][0])


@pytest.mark.cuda
def test_train_steps_of_a_moe_match_the_piece_path(card):
    """Three train steps of a SMOKE Phi-3.5-MoE in bf16 through the
    kernel; each step's gradients also go through the plain path into a
    shadow copy of the parameters and state, which must stay equal."""
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").replace(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    model = build(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(5),
                        card).params()
    batch = {k: torch.from_numpy(v).to(card)
             for k, v in synthetic_batch(cfg, 4, 64, seed=5).items()}
    opt = adamw(1e-3, weight_decay=0.1)
    state = opt.init(params)
    shadow_p = {k: v.clone() for k, v in params.items()}
    shadow_s = opt.init(shadow_p)
    mask = mask_tree(params, cfg, 1)
    assert any(float(m.min()) == 0.0 for m in mask.values())
    launched = []

    def update_(grads, st, p, m=None):
        with plain_path():
            opt.update_({k: g.clone() for k, g in grads.items()}, shadow_s,
                        shadow_p, m)
        assert all(g.dtype == torch.float32 for g in grads.values())
        before = ops.LAUNCHES["adamw_update"]
        with runtime.no_syncs():
            out = opt.update_(grads, st, p, m)
        launched.append(ops.LAUNCHES["adamw_update"] - before)
        return out

    step = make_train_step(model, opt._replace(update_=update_), True, 2)
    for _ in range(STEPS):
        params, state, loss = step(params, state, batch, mask)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert_same(params, state, shadow_p, shadow_s)
    assert launched == [len(params)] * STEPS
    assert int(state.count) == STEPS
