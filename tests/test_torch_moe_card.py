"""The MoE layer's row path on a card (marked ``cuda``; skips without
one), with no JAX, so that it runs where the port does.

- One full-width Phi-3.5-MoE MoE layer (d 4,096, 16 experts, top 2 of
  6,400, groups of 2,048, capacity 1.25) in bf16 over 3,000 tokens (a
  full group and one padded with 1,096 tokens), its input pulled along
  one direction so that queues overflow: ``moe_apply``'s output and
  gradients (input, router, the three expert weights) against the dense
  capacity formulation written here (``dense_moe``: the reference's
  one-hot dispatch and combine einsums over every slot), from the same
  routing. Relative L2 gap within 2^-7 for the
  output and the input's and experts' gradients (a few bf16 roundings
  of 2^-9 each, in other orders: the grouped products and the einsums
  accumulate in fp32 but tile differently), and within 2^-5 for the
  router's, which sums gate gradients of opposite signs over every token
  (its norm is mostly cancellation). No host read happens inside the
  layer, forward or backward (torch's sync debug mode "error",
  ``analysis.runtime.no_syncs``). Once more with the rows the grouped
  products leave unwritten made NaN (``torch_unwritten``, which reads
  the experts' last end on the host, so this run is not held to no
  syncs): the same bounds hold.
- ``grouped_mm`` (``torch._grouped_mm``) against its twin (one
  ``torch.mm`` per expert) at the layer's widths in bf16, with an expert
  that has no rows, ends at no multiple of 8 (the products' rows need no
  alignment) and rows past the last end: the computed rows within 2^-8
  relative L2 per product, forward and both gradients.
"""
import contextlib
import math

import pytest

torch = pytest.importorskip("torch")
F = torch.nn.functional

from repro_torch.analysis import runtime  # noqa: E402
from repro_torch.configs.phi3_5_moe import CONFIG  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from torch_unwritten import unwritten  # noqa: E402

CFG = CONFIG.replace(param_dtype=torch.bfloat16,
                     compute_dtype=torch.bfloat16)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch._grouped_mm runs there)")
    return torch.device("cuda")


def dense_moe(p, x, cfg):
    """The layer on a capacity buffer: the combine tensor (G, S, E, C) a
    scatter of each kept pair's gate at its (expert, slot), the dispatch
    its nonzero cells, and the experts as einsums over every slot."""
    m = cfg.moe
    b, s, d = x.shape
    r = moe.route(p, x, cfg)
    g, gs, _ = r.xg.shape
    e, cap, dt = m.num_experts, r.capacity, r.xg.dtype
    cell = r.expert * cap + r.pos.clamp(max=cap - 1)
    weight = r.gate.to(dt) * r.kept.to(dt)
    combine = torch.zeros((g, gs, e * cap), dtype=dt, device=x.device)
    combine = combine.scatter_add(2, cell, weight).reshape(g, gs, e, cap)
    dispatch = (combine > 0).to(dt)
    xe = torch.einsum("gsec,gsd->egcd", dispatch, r.xg)
    h = torch.einsum("egcd,edf->egcf", xe, p["expert_gate"].to(dt))
    u = torch.einsum("egcd,edf->egcf", xe, p["expert_up"].to(dt))
    ye = torch.einsum("egcf,efd->egcd", F.silu(h) * u,
                      p["expert_down"].to(dt))
    y = torch.einsum("gsec,egcd->gsd", combine, ye)
    return y.reshape(g * gs, d)[:r.n_tok].reshape(b, s, d)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def leaves(p, x):
    return {"x": x, **{k: p[k] for k in ("router", "expert_gate",
                                         "expert_up", "expert_down")}}


@pytest.mark.cuda
@pytest.mark.parametrize("nan_rows", [False, True])
def test_full_width_layer_matches_the_dense_formulation(card, nan_rows,
                                                        monkeypatch):
    if nan_rows:
        monkeypatch.setattr(moe, "grouped_mm", unwritten(moe.grouped_mm))
    gen = torch.Generator(device=card).manual_seed(0)
    p = moe.moe_init(gen, CFG, card)
    x = (torch.randn(1, 3000, CFG.d_model, generator=gen, device=card)
         + torch.randn(CFG.d_model, generator=gen, device=card))
    x = x.to(torch.bfloat16)
    w = torch.randn(x.shape, generator=gen, device=card).to(torch.bfloat16)
    r = moe.route(p, x, CFG)
    kept = r.kept.reshape(-1, CFG.moe.top_k)[:r.n_tok]
    assert not bool(kept.all()), "no real pair was dropped"
    grads, outs = {}, {}
    for name, fn in (("rows", moe.moe_apply), ("dense", dense_moe)):
        q = {k: v.detach().clone().requires_grad_(True)
             for k, v in leaves(p, x).items()}
        pp = {**p, **{k: v for k, v in q.items() if k != "x"}}
        with contextlib.nullcontext() if nan_rows else runtime.no_syncs():
            y = fn(pp, q["x"], CFG)
            y = y[0] if isinstance(y, tuple) else y
            torch.sum(y.float() * w.float()).backward()
        outs[name] = y.detach()
        grads[name] = {k: v.grad for k, v in q.items()}
    torch.cuda.synchronize()
    gaps = {"y": rel_l2(outs["rows"], outs["dense"])}
    gaps.update({k: rel_l2(grads["rows"][k], grads["dense"][k])
                 for k in grads["rows"]})
    print(gaps)
    assert all(math.isfinite(v) for v in gaps.values()), gaps
    for k, gap in gaps.items():
        assert gap <= (2 ** -5 if k == "router" else 2 ** -7), (k, gaps)


@pytest.mark.cuda
def test_grouped_mm_matches_its_twin(card):
    gen = torch.Generator(device=card).manual_seed(1)
    d, f, e = CFG.d_model, CFG.moe.d_ff_expert, CFG.moe.num_experts
    sizes = [(i * 37) % 300 for i in range(e)]
    sizes[3] = 0                                  # an expert with no rows
    assert any(n % 8 for n in sizes)              # unaligned ends
    ends = torch.tensor(sizes, device=card).cumsum(0).to(torch.int32)
    n = int(ends[-1]) + 40                        # rows past the last end
    a = torch.randn(n, d, generator=gen, device=card).to(torch.bfloat16)
    wt = (torch.randn(e, d, f, generator=gen, device=card)
          / math.sqrt(d)).to(torch.bfloat16)
    g = torch.randn(n, f, generator=gen, device=card).to(torch.bfloat16)
    got, want = {}, {}
    for out, fn in ((got, moe.grouped_mm), (want, moe.grouped_mm_twin)):
        aa, ww = (t.detach().clone().requires_grad_(True) for t in (a, wt))
        y = fn(aa, ww, ends)
        y[:int(ends[-1])].backward(g[:int(ends[-1])])
        out.update(y=y[:int(ends[-1])].detach(),
                   a=aa.grad[:int(ends[-1])], w=ww.grad)
    for k in got:
        assert rel_l2(got[k], want[k]) <= 2 ** -8, k
    # the empty expert's weights get no gradient
    assert float(got["w"][3].abs().max()) == 0.0
