"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``repro.models.moe``, at the configs' own capacity factor
1.25, where tokens are dropped.

Phi-3.5-MoE SMOKE (4 experts, top 2, groups of 64) routes 96 tokens: a
full group and a half group padded with 32 zero tokens, whose router
logits all tie (every pad picks experts 0 and 1). DeepSeek-V3 SMOKE adds
the shared expert. Both packages get the same JAX-initialised
parameters and the same inputs (numpy seeds), fp32.

The reference's combine tensor (G, S, E, C) is read inside its
``moe_apply`` by wrapping that module's ``jnp.einsum``; the test builds
the same tensor from the port's routing by a scatter. Its nonzero cells
must be the same ones, which pins the same experts, the same queue
slots and the same dropped (token, k) pairs; their values, the
renormalised gates, within 1e-6 (fp32 softmaxes, another order of
operations). Outputs and gradients
(router, experts, shared expert, input) are held to 1e-5 of each
tensor's largest magnitude (fp32 sums in other orders; the outputs
reach ~10, where fp32's spacing is ~1e-6); the aux loss to 1e-6
relative. Exact ties: ``top_k`` against
``jax.lax.top_k`` on tied probabilities (same values, same indices in
the same order), and a router with zero columns, whose experts tie at
logit 0 for every token.

The port runs its experts on rows (``moe.rows``): the row layout is
pinned on each routing below (every kept real pair one row, expert-major
and in queue order within an expert, pad tokens' pairs without a row),
and the
layer is held to the reference where an expert has no rows in one
group, where one has no rows at all, and at a decode shape. Rows the
products leave unwritten (on the card, past the experts' ends) are
filled with NaN, and the output and gradients must not change.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths  # noqa: E402
from torch_unwritten import unwritten  # noqa: E402

import repro.models.moe as jmoe  # noqa: E402
from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.convert import flatten, unflatten  # noqa: E402

TOL = 1e-5
ARCHS = ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"]


def setup(arch, seed=0, b=2, s=48):
    """-> (jax cfg, port cfg, moe params as numpy, x (B, S, D) numpy).
    The tokens share a common direction, as a residual stream's do, so
    the router favours some experts and their queues overflow."""
    jcfg, tcfg = j_get_smoke(arch), get_smoke_config(arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    npp = jax.tree.map(lambda a: np.array(a, copy=True), jp)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, jcfg.d_model)) + rng.normal(size=jcfg.d_model)
    return jcfg, tcfg, npp, x.astype(np.float32)


def reference(npp, x, jcfg):
    """The reference's (y, aux, combine), combine read from its einsum."""
    seen = {}

    def einsum(spec, *ops, **kw):
        out = jnp.einsum(spec, *ops, **kw)
        if spec == "gske,gskec->gsec":
            seen["combine"] = out
        return out

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.einsum = einsum
    real = jmoe.jnp
    jmoe.jnp = proxy
    try:
        y, aux = jmoe.moe_apply(jax.tree.map(jnp.asarray, npp),
                                jnp.asarray(x), jcfg)
    finally:
        jmoe.jnp = real
    return np.asarray(y), float(aux), np.asarray(seen["combine"])


def port(npp, x, tcfg):
    p = unflatten({k: torch.from_numpy(v) for k, v in flatten(npp).items()})
    r = moe.route(p, torch.from_numpy(x), tcfg)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), tcfg)
    return y.numpy(), float(aux), r


def assert_close(got, want, what=""):
    """|got - want| <= TOL * max |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=TOL * float(np.abs(want).max()))


def assert_combine_equal(r, cfg, want):
    got = port_combine(r, cfg)
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def port_combine(r, cfg):
    """The combine tensor of the port's routing: each kept pair's gate at
    its (expert, slot) cell, by a scatter."""
    g, gs, _ = r.xg.shape
    cap = r.capacity
    cell = r.expert * cap + r.pos.clamp(max=cap - 1)
    weight = r.gate.to(r.xg.dtype) * r.kept.to(r.xg.dtype)
    return torch.zeros((g, gs, cfg.moe.num_experts * cap)).scatter_add(
        2, cell, weight).reshape(g, gs, cfg.moe.num_experts, cap).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_with_drops(arch):
    jcfg, tcfg, npp, x = setup(arch)
    assert tcfg.moe.capacity_factor == 1.25
    want_y, want_aux, want_combine = reference(npp, x, jcfg)
    got_y, got_aux, r = port(npp, x, tcfg)
    # 96 tokens over groups of 64: two groups, the second half padding
    assert tuple(r.xg.shape[:2]) == (2, 64) and r.n_tok == 96
    assert r.capacity == moe._capacity(tcfg.moe, 64) == jmoe._capacity(
        jcfg.moe, 64)
    assert_combine_equal(r, tcfg, want_combine)
    # the same (token, k) pairs dropped, and some real ones among them
    kept = (want_combine > 0).sum(axis=(2, 3)).reshape(-1)[:r.n_tok]
    assert np.array_equal(kept, r.kept.sum(-1).reshape(-1)[:r.n_tok].numpy())
    assert (kept < tcfg.moe.top_k).any(), "no real token was dropped"
    assert_close(got_y, want_y)
    assert got_aux == pytest.approx(want_aux, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match(arch):
    """d(sum(y * w) + aux)/d(params, x) in both packages: the router's
    gradient flows through the gates and the aux loss's mean
    probabilities."""
    assert_gradients_match(*setup(arch, seed=1))


def assert_gradients_match(jcfg, tcfg, npp, x):
    w = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jcfg)
        return jnp.sum(y * jnp.asarray(w)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, npp), jnp.asarray(x))
    flat = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in flatten(npp).items()}
    xx = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_apply(unflatten(flat), xx, tcfg)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    want = flat_paths(jg)
    assert list(flat) == list(want)
    for name, g in want.items():
        assert_close(flat[name].grad.numpy(), g, name)
    assert_close(xx.grad.numpy(), jgx)


def test_top_k_tie_order_matches_jax():
    rng = np.random.default_rng(3)
    rows = [np.full(4, 0.25), [0.1, 0.4, 0.4, 0.1], [0.3, 0.2, 0.3, 0.2],
            [0.0, 0.0, 0.5, 0.5]]
    probs = np.concatenate([np.asarray(rows, np.float32),
                            rng.integers(0, 3, (500, 4)).astype(np.float32)])
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    wide = rng.integers(0, 4, (64, 256)).astype(np.float32)   # E = 256, k 8
    _, wi = jax.lax.top_k(jnp.asarray(wide), 8)
    np.testing.assert_array_equal(moe.top_k(torch.from_numpy(wide),
                                            8)[1].numpy(), np.asarray(wi))


def test_exact_ties_route_alike():
    """Router columns of experts 2 and 3 zeroed: their logits are exactly
    0 for every token, so any token whose other logits are negative ties
    for its top 2 (expert 2 first); the first choice feeds the aux
    loss."""
    jcfg, tcfg, npp, x = setup("phi3.5-moe-42b-a6.6b", seed=4)
    npp["router"][:, 2:] = 0.0
    want_y, want_aux, want_combine = reference(npp, x, jcfg)
    got_y, got_aux, r = port(npp, x, tcfg)
    tied = (r.expert == torch.tensor([2, 3])).all(-1)
    assert tied.sum() > 0
    assert_combine_equal(r, tcfg, want_combine)
    assert_close(got_y, want_y)
    assert got_aux == pytest.approx(want_aux, rel=1e-6)


def test_decode_capacity_never_drops():
    """One token a group: capacity max(4, ...) holds every choice."""
    cfg = get_smoke_config("deepseek-v3-671b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    _, _, npp, x = setup("deepseek-v3-671b", b=3, s=1)
    *_, r = port(npp, x, cfg)
    assert r.capacity == 4 and bool(r.kept.all())


# ---------------------------------------------------------------------------
# the rows
# ---------------------------------------------------------------------------

def edge_case(name):
    """-> (jax cfg, port cfg, params, x) of a routing named ``name``:
    ``phi`` / ``deepseek`` (the setups above: drops, and a half group of
    pad tokens); ``no_rows_in_a_group`` (Phi: group 0's tokens pulled
    along a direction that expert 2's router column points against, so
    that it takes none of them, yet some of group 1's); ``no_rows_at_all``
    (Phi: expert 3's column against the tokens' common direction, and the
    pad tokens' tied logits pick experts 0 and 1); ``decode`` (DeepSeek,
    3 sequences of one token: one group of 3, capacity 4)."""
    if name in ("phi", "deepseek"):
        return setup(ARCHS[name == "deepseek"])
    if name == "decode":
        return setup("deepseek-v3-671b", seed=5, b=3, s=1)
    jcfg, tcfg, npp, x = setup("phi3.5-moe-42b-a6.6b", seed=6)
    if name == "no_rows_in_a_group":
        u = np.random.default_rng(7).normal(size=x.shape[-1])
        u /= np.linalg.norm(u)
        x = x.reshape(-1, x.shape[-1])
        x[:64] += 8.0 * u
        x = x.reshape(2, 48, -1).astype(np.float32)
        npp["router"][:, 2] = -4.0 * u
    else:
        npp["router"][:, 3] = -4.0 * x.mean(axis=(0, 1))
    return jcfg, tcfg, npp, x


def port_rows(r, cfg):
    """The port's row index of a routing, as ``moe_apply`` builds it ->
    (rows, the kept real pairs (G, S, K), the buffers' rows)."""
    g, gs, k = r.expert.shape
    real = (torch.arange(g * gs) < r.n_tok).reshape(g, gs, 1)
    valid = r.kept & real
    n_rows = moe._row_bound(r.n_tok * k)
    return moe.rows(r.expert, r.pos, valid, cfg.moe.num_experts,
                    n_rows), valid, n_rows


@pytest.mark.parametrize("name", ["phi", "deepseek", "no_rows_in_a_group",
                                  "no_rows_at_all", "decode"])
def test_row_layout(name):
    """Each expert's rows: its kept real pairs, group by group, each
    group's in queue order (slots 0, 1, ...); the experts one after
    another; ``offs`` their ends; ``src`` each row's token. The rows
    number the kept real pairs; pairs that were dropped or belong to pad
    tokens have the row that stands for none."""
    _, tcfg, npp, x = edge_case(name)
    p = unflatten({k: torch.from_numpy(v) for k, v in flatten(npp).items()})
    r = moe.route(p, torch.from_numpy(x), tcfg)
    ix, valid, n_rows = port_rows(r, tcfg)
    g, gs, k = r.expert.shape
    e_all = tcfg.moe.num_experts
    expert, pos = r.expert.numpy(), r.pos.numpy()
    want_row = np.full((g, gs, k), n_rows - 1)
    want_src = np.zeros(n_rows, dtype=np.int64)
    ends, first = [], 0
    for e in range(e_all):
        pairs = sorted((gi, pos[gi, si, ki], gi * gs + si, ki)
                       for gi, si, ki in zip(*np.nonzero(valid.numpy()))
                       if expert[gi, si, ki] == e)
        for gi in range(g):
            slots = [sl for gg, sl, *_ in pairs if gg == gi]
            assert slots == list(range(len(slots))), (e, gi)
        for j, (gi, _, tok, ki) in enumerate(pairs):
            want_row[gi, tok - gi * gs, ki] = first + j
            want_src[first + j] = tok
        first += len(pairs)
        ends.append(first)
    np.testing.assert_array_equal(ix.offs.numpy(), ends)
    np.testing.assert_array_equal(ix.row.numpy(), want_row)
    # the row for none takes the token of any pair without a row
    np.testing.assert_array_equal(ix.src.numpy()[:-1], want_src[:-1])
    assert ix.offs.dtype == torch.int32 and ends[-1] < n_rows
    sizes = np.diff([0] + ends)
    kept = valid.sum().item()
    assert ends[-1] == kept
    pad_tok = ~(torch.arange(g * gs) < r.n_tok).reshape(g, gs)
    assert bool((ix.row[pad_tok] == n_rows - 1).all())
    if name in ("phi", "deepseek"):
        assert bool(r.kept[pad_tok].any()), "no pad token kept a slot"
    if name == "no_rows_in_a_group":
        on2 = valid & (r.expert == 2)
        assert not bool(on2[0].any()) and bool(on2[1].any())
    if name == "no_rows_at_all":
        assert sizes[3] == 0 and not bool((r.expert == 3).any())
    if name == "decode":
        assert r.capacity == 4 and (g, gs) == (1, 3) and bool(valid.all())


@pytest.mark.parametrize("name", ["no_rows_in_a_group", "no_rows_at_all",
                                  "decode"])
def test_edge_routings_match(name):
    """Output, aux loss, combine cells and gradients against the
    reference on the routings that leave experts without rows, and at a
    decode shape."""
    jcfg, tcfg, npp, x = edge_case(name)
    want_y, want_aux, want_combine = reference(npp, x, jcfg)
    got_y, got_aux, r = port(npp, x, tcfg)
    assert_combine_equal(r, tcfg, want_combine)
    assert_close(got_y, want_y)
    assert got_aux == pytest.approx(want_aux, rel=1e-6)
    assert_gradients_match(jcfg, tcfg, npp, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_unwritten_rows_hold_nan_and_change_nothing(arch, monkeypatch):
    """The grouped products' rows past the experts' ends filled with NaN
    (the card leaves them unwritten; the twin writes 0), and their input
    gradient there too: the output and every gradient are the same as
    without, bit for bit."""
    _, tcfg, npp, x = setup(arch, seed=8)
    w = torch.from_numpy(
        np.random.default_rng(9).normal(size=x.shape).astype(np.float32))

    def run():
        flat = {k: torch.from_numpy(v).requires_grad_(True)
                for k, v in flatten(npp).items()}
        xx = torch.from_numpy(x).requires_grad_(True)
        y, aux = moe.moe_apply(unflatten(flat), xx, tcfg)
        (torch.sum(y * w) + aux).backward()
        return y.detach(), {**{k: v.grad for k, v in flat.items()},
                            "x": xx.grad}

    want_y, want_g = run()
    monkeypatch.setattr(moe, "grouped_mm", unwritten(moe.grouped_mm_twin))
    got_y, got_g = run()
    assert torch.equal(got_y, want_y)
    for k in want_g:
        assert torch.equal(got_g[k], want_g[k]), k
