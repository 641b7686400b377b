"""The port's wire path against the JAX reference, bit for bit.

On the CPU: the plain PyTorch versions (``repro_torch.kernels.ref``) and
the device dispatch (``repro_torch.kernels.ops``) are held against
``repro.kernels.ref`` and against the Pallas kernels run in interpret
mode, on the same numpy inputs. Every comparison is exact (floats
compared as bit patterns): the wire format is integer codes and fp32
scales computed with the same correctly rounded operations.

On a card (tests marked ``cuda``): each CUDA kernel against its plain
version on the same CUDA tensors, bit for bit. Those need no JAX, so
the JAX package is imported by a fixture, not at the top: on a machine
with a card and no JAX the reference tests skip and the card tests run.
"""
import types
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import compression  # noqa: E402
from repro_torch.kernels import cuda_lib, ops, ref  # noqa: E402

BLOCK = 256


@pytest.fixture(scope="module")
def J():
    """The JAX reference's wire path."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import compression as comp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels import wire as jwire
    from repro.kernels.quantize import dequantize_blocks, quantize_blocks
    return types.SimpleNamespace(jnp=jnp, comp=comp, ops=jops, ref=jref,
                                 wire=jwire, quant=quantize_blocks,
                                 deq=dequantize_blocks)


def bits_equal(a, b):
    """Exact equality, floats compared as bit patterns (so -0.0 != 0.0
    and NaNs must match)."""
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                       b.shape, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(a, b)


def delta_like(rng, n_blocks, block=BLOCK):
    """Update-like rows: normal x 1e-3 with exact zeros, one all-zero row,
    tied magnitudes of both signs, and exact half-step values."""
    x = (rng.normal(size=(n_blocks, block)) * 1e-3).astype(np.float32)
    x[rng.random(size=x.shape) < 0.05] = 0.0
    if n_blocks > 1:
        x[1] = 0.0                                   # all-zero row
    if n_blocks > 2:
        x[2, :40] = x[2, 40]                         # ties inside a row
        x[2, 40:60] = -x[2, 40]
    if n_blocks > 3:
        # absmax 2 with values at +-1: x/scale = +-0.5 at 2 bits, which
        # rounds half to even (to 0)
        x[3] = 0.0
        x[3, 0] = 2.0
        x[3, 1:64:2] = 1.0
        x[3, 2:64:2] = -1.0
    return x


#: the names of ``special_rows``' rows, in order
SPECIAL_ROWS = ("nan", "two_nans", "pos_inf", "neg_inf", "nan_and_inf",
                "many_nans", "absmax_1e-37", "only_subnormals",
                "subnormals_zeros_at_kth", "all_tied", "ties_straddle_kth",
                "scale_2^-126_at_8_bits", "scale_2^-126_at_2_bits")


def special_rows(block, k, seed=0):
    """Rows that no healthy delta holds, where the wire format must still
    follow the reference: NaN (of both signs), +-inf, a row whose scale
    underflows to a subnormal (absmax 1e-37 at 8 bits), rows of
    subnormals, which the reference flushes to signed zeros (XLA's
    denormals-are-zero), with the ``k``-th magnitude among subnormals and
    zeros, a row of one magnitude, and a run of ties straddling the
    ``k``-th magnitude, and two rows whose scale (at 8 and at 2 bits) lies
    in [2^-126, 2^-125), where a subnormal over the scale would round to
    a code of +-1 unflushed. (len(SPECIAL_ROWS), block) f32."""
    rng = np.random.default_rng(seed)

    def base():
        return (rng.normal(size=block) * 1e-3).astype(np.float32)

    neg_nan = np.copysign(np.float32(np.nan), np.float32(-1.0))
    rows = []
    r = base(); r[block // 3] = np.nan; rows.append(r)
    r = base(); r[0] = np.nan; r[-1] = neg_nan; rows.append(r)
    r = base(); r[block // 2] = np.inf; rows.append(r)
    r = base(); r[7] = -np.inf; rows.append(r)
    r = base(); r[3] = np.inf; r[block - 5] = np.nan; rows.append(r)
    r = base(); r[rng.permutation(block)[:block // 4]] = np.nan; rows.append(r)
    r = base(); rows.append((r / np.abs(r).max() * np.float32(1e-37))
                            .astype(np.float32))
    rows.append(rng.choice(np.array([2e-40, 1e-40, -2e-40, 5e-45, -1e-39],
                                    np.float32), size=block))
    r = np.where(np.arange(block) % 2 == 0,
                 rng.choice(np.array([3e-40, -3e-40, 1e-41], np.float32),
                            size=block),
                 rng.choice(np.array([0.0, -0.0], np.float32), size=block))
    r = r.astype(np.float32)
    r[rng.permutation(block)[:k // 2]] = base()[:k // 2] + np.float32(1e-2)
    rows.append(r)
    rows.append(np.where(rng.random(block) < 0.5, np.float32(0.25),
                         np.float32(-0.25)).astype(np.float32))
    # max(k - 3, 0) magnitudes above m, 7 values of +-m scattered, the
    # rest below: the k-th magnitude falls inside the run of ties
    n_big = max(min(k - 3, block - 8), 0)
    m = np.float32(5e-3)
    r = (rng.uniform(0.1, 0.9, size=block) * m).astype(np.float32)
    order = rng.permutation(block)
    r[order[:n_big]] = (m * rng.uniform(1.5, 4.0, size=n_big)).astype(
        np.float32)
    r[order[n_big:n_big + 7]] = m * np.where(rng.random(7) < 0.5, 1, -1)
    rows.append(r.astype(np.float32))
    for absmax, normal in ((2e-36, 3e-38), (1.5e-38, -1.3e-38)):
        r = np.zeros(block, np.float32)
        r[1::3], r[2::3] = np.float32(1.1e-38), np.float32(-9e-39)
        r[0], r[4] = np.float32(absmax), np.float32(normal)
        rows.append(r)
    out = np.stack(rows).astype(np.float32)
    assert out.shape == (len(SPECIAL_ROWS), block)
    return out


def kept_per_row(x, k):
    """The reference's rule for the top-k mask's row sums: every NaN is
    kept on top of min(k, the row's non-NaN count)."""
    nan = np.isnan(x).sum(axis=1)
    return (np.minimum(k, x.shape[1] - nan) + nan).tolist()


# ---------------------------------------------------------------------------
# plain versions vs the JAX reference and the Pallas kernels (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 2])
def test_quantize_dequantize_blocks_twins(bits, J):
    x = delta_like(np.random.default_rng(bits), 16)
    codes, scales = ref.quantize_blocks_ref(torch.from_numpy(x), bits)
    jc, js = J.ref.quantize_blocks_ref(J.jnp.asarray(x), bits)
    pc, ps = J.quant(J.jnp.asarray(x), bits, interpret=True)
    for want_c, want_s in ((jc, js), (pc, ps)):
        bits_equal(codes.numpy(), want_c)
        bits_equal(scales.numpy(), want_s)
    deq = ref.dequantize_blocks_ref(codes, scales)
    bits_equal(deq.numpy(), J.ref.dequantize_blocks_ref(jc, js))
    bits_equal(deq.numpy(), J.deq(pc, ps, interpret=True))


#: block widths beside the main path's 256: multiples of 128 (the card's
#: warp-per-block kernel) and others (its CTA-per-row kernel)
WIDTHS = [128, 512, 1024, 100, 257]


@pytest.mark.parametrize("bits", [8, 2])
@pytest.mark.parametrize("block", WIDTHS)
def test_quantize_blocks_twin_at_other_widths(block, bits, J):
    """13 rows, zero-padded to the reference's ROWS_PER_TILE (16) for the
    Pallas call and compared on the first 13."""
    from repro.kernels.quantize import ROWS_PER_TILE
    x = delta_like(np.random.default_rng(block + bits), 13, block)
    padded = np.zeros((-(-13 // ROWS_PER_TILE) * ROWS_PER_TILE, block),
                      np.float32)
    padded[:13] = x
    codes, scales = ref.quantize_blocks_ref(torch.from_numpy(x), bits)
    jc, js = J.ref.quantize_blocks_ref(J.jnp.asarray(x), bits)
    pc, ps = J.quant(J.jnp.asarray(padded), bits, interpret=True)
    for want_c, want_s in ((jc, js), (np.asarray(pc)[:13],
                                      np.asarray(ps)[:13])):
        bits_equal(codes.numpy(), want_c)
        bits_equal(scales.numpy(), want_s)


@pytest.mark.parametrize("bits", [8, 2])
@pytest.mark.parametrize("k", [1, 32, 64, 255])
def test_quantize_topk_blocks_twin(bits, k, J):
    x = delta_like(np.random.default_rng(k), 16)
    codes, scales, mask = ref.quantize_topk_blocks_ref(torch.from_numpy(x),
                                                       bits, k)
    assert mask.sum(dim=1).tolist() == [k] * 16
    want = [J.ref.quantize_topk_blocks_ref(J.jnp.asarray(x), bits, k),
            J.wire.quantize_topk_blocks(J.jnp.asarray(x), bits, k,
                                       interpret=True)]
    for jc, js, jm in want:
        bits_equal(codes.numpy(), jc)
        bits_equal(scales.numpy(), js)
        bits_equal(mask.numpy(), jm)


def pallas_rows(fn, x, J):
    """``fn`` (a Pallas kernel in interpret mode) on ``x`` zero-padded to
    the reference's ROWS_PER_TILE rows, cut back to ``x``'s rows."""
    from repro.kernels.quantize import ROWS_PER_TILE
    n = x.shape[0]
    padded = np.zeros((-(-n // ROWS_PER_TILE) * ROWS_PER_TILE, x.shape[1]),
                      np.float32)
    padded[:n] = x
    return [np.asarray(out)[:n] for out in fn(J.jnp.asarray(padded))]


@pytest.mark.parametrize("bits", [8, 2])
@pytest.mark.parametrize("k", [1, 64, 255])
def test_quantize_blocks_special_rows(bits, k, J):
    """NaN, inf and subnormal rows through the dense quantizer: the plain
    version, ``ops`` and the round trip equal the reference and the Pallas
    kernel bit for bit (a NaN scale for a NaN row, NaN codes 0, subnormals
    and a subnormal scale flushed to zero)."""
    x = special_rows(BLOCK, k)
    codes, scales = ref.quantize_blocks_ref(torch.from_numpy(x), bits)
    wc, ws, wm, _ = ops.quantize_wire(torch.from_numpy(x), bits=bits)
    assert wm is None
    jc, js = J.ref.quantize_blocks_ref(J.jnp.asarray(x), bits)
    pc, ps = pallas_rows(lambda t: J.quant(t, bits, interpret=True), x, J)
    for want_c, want_s in ((jc, js), (pc, ps)):
        for got_c, got_s in ((codes, scales), (wc, ws)):
            bits_equal(got_c.numpy(), want_c)
            bits_equal(got_s.numpy(), want_s)
    assert np.isnan(scales.numpy()[:6]).tolist() == [True, True, False, False,
                                                     True, True]
    assert scales.numpy()[6 if bits == 8 else 7] == 0.0
    bits_equal(ops.quantize_dequantize(torch.from_numpy(x), bits=bits)
               .numpy(), J.ref.quantize_dequantize_ref(J.jnp.asarray(x), bits))


@pytest.mark.parametrize("bits", [8, 2])
@pytest.mark.parametrize("k", [1, 64, 255])
def test_quantize_topk_special_rows(bits, k, J):
    """The same rows through the top-k quantizer: NaNs kept on top of k,
    subnormals tied with zeros, ties at the k-th magnitude kept in index
    order, bit for bit against the reference and the Pallas kernel."""
    x = special_rows(BLOCK, k)
    got = ref.quantize_topk_blocks_ref(torch.from_numpy(x), bits, k)
    wire = ops.quantize_wire(torch.from_numpy(x), bits=bits, topk=k)[:3]
    assert got[2].sum(dim=1).tolist() == kept_per_row(x, k)
    want = [J.ref.quantize_topk_blocks_ref(J.jnp.asarray(x), bits, k),
            pallas_rows(lambda t: J.wire.quantize_topk_blocks(
                t, bits, k, interpret=True), x, J)]
    for w in want:
        for g in (got, wire):
            for g_out, w_out in zip(g, w):
                bits_equal(g_out.numpy(), w_out)
    bits_equal(ops.quantize_dequantize(torch.from_numpy(x), bits=bits,
                                       topk=k).numpy(),
               J.ref.quantize_dequantize_ref(J.jnp.asarray(x), bits, topk=k))


@pytest.mark.parametrize("q,topk", [(1, None), (2, None), (1, 64), (2, 64)])
def test_compress_decompress_special_leaf(q, topk, J):
    """A tree holding a leaf of NaN, inf and subnormal rows and a ragged
    leaf with a NaN in its tail: the staged round trip equals
    ``repro.core.compression.compress_decompress`` leaf for leaf."""
    special = special_rows(BLOCK, 64, seed=q)
    ragged = (np.random.default_rng(q).normal(size=(300,)) * 1e-3).astype(
        np.float32)
    ragged[290] = np.nan
    ragged[3] = np.float32(2e-40)
    leaves = {"special": special, "ragged": ragged,
              "plain": delta_like(np.random.default_rng(q), 3)}
    got = compression.compress_decompress(
        {name: torch.from_numpy(x) for name, x in leaves.items()}, q,
        topk=topk)
    want = J.comp.compress_decompress(
        {name: J.jnp.asarray(x) for name, x in leaves.items()}, q, topk=topk)
    assert np.isnan(got["ragged"].numpy()[256:]).all()
    for name in leaves:
        bits_equal(got[name].numpy(), want[name])


SHAPES = [(), (1,), (37,), (3, 129), (5, 7, 11), (0,), (3, 256),
          (256 * 8 + 17,), (64, 256)]


@pytest.fixture(params=["ref", "pallas"])
def jax_backend(request, monkeypatch, J):
    monkeypatch.setattr(J.ops, "FORCE_BACKEND", request.param)
    return request.param


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("q,topk", [(1, None), (2, None), (1, 32), (2, 64),
                                    (2, 256)])
def test_quantize_dequantize_matches_jax(shape, q, topk, jax_backend, J):
    rng = np.random.default_rng(len(shape) * 7 + q)
    x = np.asarray(rng.normal(size=shape) * 1e-3, dtype=np.float32)
    if x.size > 300:
        x.reshape(-1)[:256] = 0.0                   # an all-zero block
    bits = 8 if q == 1 else 2
    got = ops.quantize_dequantize(torch.from_numpy(x), bits=bits, topk=topk)
    if x.size == 0:
        # the Pallas grid cannot take an empty operand: hold the empty
        # leaf against the reference's plain path only
        want = J.ref.quantize_dequantize_ref(J.jnp.asarray(x), bits, topk=topk)
    else:
        want = J.ops.quantize_dequantize(J.jnp.asarray(x), bits=bits, topk=topk)
    bits_equal(got.numpy(), want)
    # the tree-level entry point quantizes each leaf on its own
    tree = compression.compress_decompress(
        {"a": torch.from_numpy(x), "b": torch.from_numpy(x[..., None])},
        q, topk=topk)
    bits_equal(tree["a"].numpy(), want)
    bits_equal(tree["b"].numpy(), np.asarray(want)[..., None])


@pytest.mark.parametrize("n", [0, 1, 255, 256, 1000, 256 * 8 + 17])
@pytest.mark.parametrize("q,topk", [(1, None), (2, None), (1, 32), (2, 64),
                                    (1, 256)])
def test_quantize_wire_tuple_and_wire_bytes(n, q, topk, jax_backend, J):
    """The tuple equals the reference's, has exactly ceil(n/256) blocks,
    and wire_bytes prices exactly it (packed codes + 1-bit mask for
    top-k + fp32 scales) in both packages."""
    x = (np.random.default_rng(n).normal(size=(n,)) * 1e-3).astype(np.float32)
    bits = 8 if q == 1 else 2
    codes, scales, mask, n_valid = ops.quantize_wire(torch.from_numpy(x),
                                                     bits=bits, topk=topk)
    jc, js, jm, jn = J.ops.quantize_wire(J.jnp.asarray(x), bits=bits, topk=topk)
    n_blocks = -(-n // BLOCK)
    assert n_valid == jn == n
    assert codes.shape == (n_blocks, BLOCK) and scales.shape == (n_blocks,)
    bits_equal(codes.numpy(), jc)
    bits_equal(scales.numpy(), js)
    sparse = topk is not None and topk < BLOCK
    if sparse:
        bits_equal(mask.numpy(), jm)
        modeled = (n_blocks * topk * bits + mask.numel()) // 8 + scales.numel() * 4
    else:
        assert mask is None and jm is None
        modeled = codes.numel() * bits // 8 + scales.numel() * 4
    got = compression.wire_bytes(torch.from_numpy(x), q=q, topk=topk)
    assert got == modeled
    assert got == J.comp.wire_bytes(J.jnp.asarray(x), q=q, topk=topk)


def charlm_leaf_shapes():
    """The 16 parameter-leaf shapes of the full-width char-LM."""
    from repro_torch.configs.charlm_shakespeare import CONFIG
    from repro_torch.models import build
    params = build(CONFIG).init(torch.Generator().manual_seed(0),
                                "cpu").params()
    return [tuple(t.shape) for t in params.values()]


@pytest.mark.parametrize("q,topk", [(1, None), (2, None), (1, 64), (2, 64)])
def test_compress_decompress_tree_matches_jax_per_leaf(q, topk, J):
    """The staged round trip (one buffer of blocks for the whole tree)
    equals the reference's per-leaf ``ops.quantize_dequantize`` bit for
    bit: a scalar leaf, a leaf with a ragged tail, an empty leaf and the
    full-width char-LM's 16 leaf shapes, each leaf on its own blocks."""
    shapes = [(), (3, 129), (0,)] + charlm_leaf_shapes()
    assert len(shapes) == 19
    rng = np.random.default_rng(q * 10 + (topk or 0))
    leaves = {f"l{i}": np.asarray(rng.normal(size=shape) * 1e-3,
                                  dtype=np.float32)
              for i, shape in enumerate(shapes)}
    leaves["l1"].reshape(-1)[:256] = 0.0              # an all-zero block
    bits = 8 if q == 1 else 2
    got = compression.compress_decompress(
        {name: torch.from_numpy(x) for name, x in leaves.items()}, q,
        topk=topk)
    assert list(got) == list(leaves)
    for name, x in leaves.items():
        if x.size:
            want = J.ops.quantize_dequantize(J.jnp.asarray(x), bits=bits,
                                             topk=topk)
        else:
            want = J.ref.quantize_dequantize_ref(J.jnp.asarray(x), bits,
                                                 topk=topk)
        assert got[name].shape == x.shape
        bits_equal(got[name].numpy(), want)


@pytest.mark.parametrize("topk", [None, 64])
def test_compress_decompress_calls_each_wire_kernel_once(topk, monkeypatch):
    """One tree, one quantizer call and one ``dequantize_blocks`` call
    (counted on the plain versions the CPU takes), whatever its number of
    leaves; each leaf comes back as its own slice of the decoded blocks,
    equal to the per-leaf round trip."""
    calls = dict.fromkeys(("quantize_blocks_ref", "quantize_topk_blocks_ref",
                           "dequantize_blocks_ref"), 0)
    for name in calls:
        def counted(*args, _fn=getattr(ref, name), _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(ref, name, counted)
    rng = np.random.default_rng(5)
    tree = {f"w{i}": torch.from_numpy(
        np.asarray(rng.normal(size=shape) * 1e-3, dtype=np.float32))
        for i, shape in enumerate([(), (7,), (300,), (2, 256), (5, 3, 11)])}
    got = compression.compress_decompress(tree, 2, topk=topk)
    quantizer = ("quantize_blocks_ref" if topk is None
                 else "quantize_topk_blocks_ref")
    # (the plain top-k quantizer calls the plain dense one inside it)
    assert calls[quantizer] == 1 and calls["dequantize_blocks_ref"] == 1
    assert calls["quantize_topk_blocks_ref"] == (topk is not None)
    for name, x in tree.items():
        bits_equal(got[name].numpy(),
                   ref.quantize_dequantize_ref(x, 2, topk=topk).numpy())


def test_stage_blocks_layout():
    """Each leaf starts on a block boundary and its tail pads with zeros
    inside its own last block."""
    leaves = [torch.ones(()), torch.full((300,), 2.0), torch.zeros((0,)),
              torch.full((2, 128), 3.0)]
    buf, offsets = compression.stage_blocks(leaves, BLOCK)
    assert buf.shape == (1 + 2 + 0 + 1, BLOCK)
    assert offsets == [0, 256, 768, 768]
    flat = buf.view(-1)
    assert flat[0] == 1.0 and not flat[1:256].any()
    assert bool((flat[256:556] == 2.0).all()) and not flat[556:768].any()
    assert bool((flat[768:] == 3.0).all())


def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    """CPU tensors take the plain versions: the kernel loader is never
    called and no launch is counted."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel loader")

    monkeypatch.setattr(cuda_lib, "load_library", refuse)
    before = dict(ops.LAUNCHES)
    x = torch.from_numpy(delta_like(np.random.default_rng(3), 4))
    ops.quantize_dequantize(x, bits=8)
    ops.quantize_dequantize(x, bits=2, topk=32)
    ops.quantize_wire(x, bits=8, topk=64)
    c, s, _, _ = ops.quantize_wire(x, bits=2)
    ops.dequantize_blocks(c, s)
    compression.compress_decompress({"w": x}, 2, topk=64)
    vals = np.random.default_rng(3).integers(0, 2 ** 64, size=(6, 513),
                                             dtype=np.uint64)
    ops.masked_sum_u64(vals, device="cpu")
    ops.masked_sum(*ops.split_limbs(vals), device="cpu")
    assert ops.LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import quantize, wire
    x = torch.zeros((2, BLOCK))
    with pytest.raises(ValueError, match="CUDA"):
        quantize.quantize_blocks(x, 8)
    with pytest.raises(ValueError, match="CUDA"):
        wire.quantize_topk_blocks(x, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        quantize.dequantize_blocks(torch.zeros((2, BLOCK), dtype=torch.int8),
                                   torch.zeros(2))
    limbs = torch.zeros((2, 3), dtype=torch.uint32)
    with pytest.raises(ValueError, match="CUDA"):
        wire.masked_sum_limbs(limbs, limbs)
    with pytest.raises(ValueError, match="CUDA"):
        wire.masked_sum_u64(torch.zeros((2, 3), dtype=torch.int64))
    with pytest.raises(ValueError, match="int64"):
        wire.masked_sum_u64(torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        wire.masked_sum_u64(torch.zeros((3, 2), dtype=torch.int64).t())


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    SHAPES = [(1, BLOCK), (3, BLOCK), (64, BLOCK), (1728, BLOCK), (0, BLOCK),
              (5, 100), (7, 1024)]

    @pytest.mark.parametrize("shape", SHAPES, ids=str)
    @pytest.mark.parametrize("bits", [8, 2])
    def test_quantize_dequantize(self, card, shape, bits):
        from repro_torch.kernels import quantize
        x = torch.from_numpy(delta_like(np.random.default_rng(1), *shape)
                             ).to(card)
        codes, scales = quantize.quantize_blocks(x, bits)
        want_c, want_s = ref.quantize_blocks_ref(x, bits)
        deq = quantize.dequantize_blocks(codes, scales)
        torch.cuda.synchronize()
        bits_equal(codes.cpu().numpy(), want_c.cpu().numpy())
        bits_equal(scales.cpu().numpy(), want_s.cpu().numpy())
        bits_equal(deq.cpu().numpy(),
                   ref.dequantize_blocks_ref(want_c, want_s).cpu().numpy())

    @pytest.mark.parametrize("shape", SHAPES, ids=str)
    @pytest.mark.parametrize("bits,k", [(8, 32), (2, 64), (8, 1), (2, 99)])
    def test_quantize_topk(self, card, shape, bits, k):
        from repro_torch.kernels import wire
        x = torch.from_numpy(delta_like(np.random.default_rng(2), *shape)
                             ).to(card)
        got = wire.quantize_topk_blocks(x, bits, k)
        want = ref.quantize_topk_blocks_ref(x, bits, k)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            bits_equal(g.cpu().numpy(), w.cpu().numpy())

    def test_ops_count_launches(self, card):
        x = torch.from_numpy(delta_like(np.random.default_rng(4), 9)).to(card)
        before = dict(ops.LAUNCHES)
        y = ops.quantize_dequantize(x, bits=2, topk=64)
        assert ops.LAUNCHES["quantize_topk_blocks"] == \
            before["quantize_topk_blocks"] + 1
        assert ops.LAUNCHES["dequantize_blocks"] == \
            before["dequantize_blocks"] + 1
        bits_equal(y.cpu().numpy(),
                   ref.quantize_dequantize_ref(x, 2, topk=64).cpu().numpy())

    @pytest.mark.parametrize("q,topk", [(1, None), (2, None), (2, 64)])
    def test_compress_decompress_one_launch_per_tree(self, card, q, topk):
        """The full-width char-LM's 16 leaves plus a scalar and a ragged
        leaf on the card: one launch of the quantizer and one of
        ``dequantize_blocks`` for the whole tree, each leaf bit-equal to
        the per-leaf plain path."""
        shapes = [(), (3, 129)] + charlm_leaf_shapes()
        gen = torch.Generator().manual_seed(q)
        tree = {f"l{i}": (torch.randn(shape, generator=gen) * 1e-3).to(card)
                for i, shape in enumerate(shapes)}
        bits = 8 if q == 1 else 2
        quant = "quantize_blocks" if topk is None else "quantize_topk_blocks"
        before = dict(ops.LAUNCHES)
        got = compression.compress_decompress(tree, q, topk=topk)
        torch.cuda.synchronize()
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert launched[quant] == 1 and launched["dequantize_blocks"] == 1
        assert sum(launched.values()) == 2
        for name, x in tree.items():
            want = ref.quantize_dequantize_ref(x, bits, topk=topk)
            assert got[name].is_cuda and got[name].shape == x.shape
            bits_equal(got[name].cpu().numpy(), want.cpu().numpy())

    @pytest.mark.parametrize("n_blocks", [1, 7, 7428, 40_000])
    def test_dequantize_vec16_rows(self, card, n_blocks):
        """The 16-codes-a-thread path over many rows, and a row width that
        is not a multiple of 16 (the one-thread-per-value path)."""
        from repro_torch.kernels import quantize
        gen = torch.Generator().manual_seed(n_blocks)
        for block in (BLOCK, 100):
            codes = torch.randint(-127, 128, (n_blocks, block),
                                  generator=gen, dtype=torch.int8).to(card)
            scales = torch.rand((n_blocks,), generator=gen).to(card)
            got = quantize.dequantize_blocks(codes, scales)
            want = ref.dequantize_blocks_ref(codes, scales)
            torch.cuda.synchronize()
            bits_equal(got.cpu().numpy(), want.cpu().numpy())

    @pytest.mark.parametrize("block", [100, 128, 256, 257, 512, 1024])
    @pytest.mark.parametrize("bits", [8, 2])
    def test_quantize_blocks_widths(self, card, block, bits):
        """Both quantizer kernels against the plain version: the warp
        kernel (multiples of 128 on an aligned base, 1,001 rows so the
        last CTA is ragged), the CTA-per-row kernel (other widths, and the
        same rows one value off a 16-byte boundary)."""
        from repro_torch.kernels import quantize
        x = delta_like(np.random.default_rng(block), 1001, block)
        flat = torch.from_numpy(np.concatenate([[0.5], x.reshape(-1)])
                                .astype(np.float32)).to(card)
        aligned = flat[1:].clone().view(1001, block)
        offset = flat[1:].view(1001, block)          # 4 bytes off
        assert offset.data_ptr() % 16 == 4 and offset.is_contiguous()
        for x_t in (aligned, offset):
            before = ops.LAUNCHES["quantize_blocks"]
            codes, scales = quantize.quantize_blocks(x_t, bits)
            want_c, want_s = ref.quantize_blocks_ref(x_t, bits)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["quantize_blocks"] == before + 1
            bits_equal(codes.cpu().numpy(), want_c.cpu().numpy())
            bits_equal(scales.cpu().numpy(), want_s.cpu().numpy())

    @staticmethod
    def rows_on_card(x, card):
        """(rows, block) f32 on the card twice: on an aligned base, and as
        a view one value off a 16-byte boundary."""
        n, block = x.shape
        flat = torch.from_numpy(np.concatenate([[0.5], x.reshape(-1)])
                                .astype(np.float32)).to(card)
        offset = flat[1:].view(n, block)
        assert offset.data_ptr() % 16 == 4 and offset.is_contiguous()
        return flat[1:].clone().view(n, block), offset

    @pytest.mark.parametrize("block", [100, 128, 256, 257, 512, 1024])
    @pytest.mark.parametrize("bits", [8, 2])
    def test_quantize_blocks_special_rows(self, card, block, bits):
        """Both quantizer kernels on the NaN, inf and subnormal rows and an
        all-tied row, bit for bit against the plain version."""
        from repro_torch.kernels import quantize
        x = delta_like(np.random.default_rng(block), 64, block)
        x[:len(SPECIAL_ROWS)] = special_rows(block, 64, seed=block)
        x[-1] = -0.125
        for x_t in self.rows_on_card(x, card):
            codes, scales = quantize.quantize_blocks(x_t, bits)
            want_c, want_s = ref.quantize_blocks_ref(x_t, bits)
            torch.cuda.synchronize()
            bits_equal(codes.cpu().numpy(), want_c.cpu().numpy())
            bits_equal(scales.cpu().numpy(), want_s.cpu().numpy())
            assert np.isnan(scales.cpu().numpy()[0])

    @pytest.mark.parametrize("block", [128, 256, 384, 512, 1024, 100, 257])
    @pytest.mark.parametrize("bits", [8, 2])
    def test_quantize_topk_widths(self, card, block, bits):
        """Both top-k kernels against the plain version at k in {1, 2, 63,
        64, 65, block - 1}: the warp kernel (multiples of 128 on an aligned
        base, 1,001 rows so the last CTA is ragged) and the CTA-per-row
        kernel (other widths, and the same rows one value off a 16-byte
        boundary), on delta-like rows, the NaN, inf and subnormal rows and
        an all-tied row. One launch a call; every NaN is kept on top of
        k."""
        from repro_torch.kernels import wire
        for k in sorted({1, 2, 63, 64, 65, block - 1}):
            x = delta_like(np.random.default_rng(block + k), 1001, block)
            x[:len(SPECIAL_ROWS)] = special_rows(block, k, seed=k)
            x[-1] = 0.5
            for x_t, warp in zip(self.rows_on_card(x, card),
                                 (block % 128 == 0, False)):
                before = ops.LAUNCHES["quantize_topk_blocks"]
                kernel = "warp" if warp else "cta"
                before_kernel = cuda_lib.TOPK_VARIANTS[kernel]
                got = wire.quantize_topk_blocks(x_t, bits, k)
                want = ref.quantize_topk_blocks_ref(x_t, bits, k)
                torch.cuda.synchronize()
                assert ops.LAUNCHES["quantize_topk_blocks"] == before + 1
                assert cuda_lib.TOPK_VARIANTS[kernel] == before_kernel + 1
                for g, w in zip(got, want):
                    bits_equal(g.cpu().numpy(), w.cpu().numpy())
                assert (got[2].sum(dim=1).tolist()
                        == kept_per_row(x, k)), (block, k)

    @pytest.mark.parametrize("n", [0, 1, 511, 513, 100_003, 100_004])
    @pytest.mark.parametrize("c", [1, 2, 6, 17])
    def test_masked_sum_u64(self, card, c, n):
        """The uint64 fold against its plain version and NumPy on the card,
        bit for bit: random values with an all-ones row and column, on an
        aligned base (the two-columns-a-thread kernel for an even n) and
        on a view one column off it (the scalar kernel)."""
        from repro_torch.kernels import wire
        vals = np.random.default_rng(c * 11 + n).integers(
            0, 2 ** 64, size=(c, n), dtype=np.uint64)
        if n:
            vals[0, :] = np.uint64(2 ** 64 - 1)
            vals[:, 0] = np.uint64(2 ** 64 - 1)
        want = np.add.reduce(vals, axis=0)
        flat = torch.from_numpy(np.concatenate(
            [np.array([7], np.uint64), vals.reshape(-1)]).view(np.int64)
        ).to(card)
        aligned = flat[1:].clone().view(c, n)
        offset = flat[1:].view(c, n)                 # 8 bytes off
        for v in (aligned, offset):
            before = ops.LAUNCHES["masked_sum_u64"]
            got = wire.masked_sum_u64(v)
            plain = ref.masked_sum_u64_ref(v)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["masked_sum_u64"] == before + (1 if n else 0)
            bits_equal(got.cpu().numpy(), plain.cpu().numpy())
            np.testing.assert_array_equal(
                got.cpu().numpy().view(np.uint64), want)
        before = dict(ops.LAUNCHES)
        np.testing.assert_array_equal(ops.masked_sum_u64(vals, device=card),
                                      want)
        launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
        assert launched["masked_sum_u64"] == (1 if n else 0)
        assert sum(launched.values()) == launched["masked_sum_u64"]

    def test_masked_sum_u64_refuses(self, card):
        from repro_torch.kernels import wire
        with pytest.raises(ValueError, match="int64"):
            wire.masked_sum_u64(torch.zeros((2, 4), dtype=torch.int32,
                                            device=card))
        with pytest.raises(ValueError, match="contiguous"):
            wire.masked_sum_u64(torch.zeros((4, 2), dtype=torch.int64,
                                            device=card).t())

    @pytest.mark.parametrize("n", [0, 1, 511, 513, 100_003])
    @pytest.mark.parametrize("c", [1, 2, 6, 17])
    def test_masked_sum_limbs(self, card, c, n):
        """The fold against its plain version on the card, bit for bit:
        random uint64 with an all-ones row and column (every carry
        ripples), as uint32 limbs and as int32 views of them."""
        from repro_torch.kernels import wire
        vals = np.random.default_rng(c * 7 + n).integers(
            0, 2 ** 64, size=(c, n), dtype=np.uint64)
        if n:
            vals[0, :] = np.uint64(2 ** 64 - 1)
            vals[:, 0] = np.uint64(2 ** 64 - 1)
        hi, lo = ops.split_limbs(vals)
        hi_t = torch.from_numpy(hi).to(card)
        lo_t = torch.from_numpy(lo).to(card)
        before = ops.LAUNCHES["masked_sum_limbs"]
        got = wire.masked_sum_limbs(hi_t, lo_t)
        got_i32 = wire.masked_sum_limbs(hi_t.view(torch.int32),
                                        lo_t.view(torch.int32))
        want = ref.masked_sum_ref(hi_t, lo_t)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["masked_sum_limbs"] == before + (2 if n else 0)
        for g, g32, w in zip(got, got_i32, want):
            bits_equal(g.cpu().numpy(), w.cpu().numpy())
            bits_equal(g32.view(torch.uint32).cpu().numpy(), w.cpu().numpy())
        np.testing.assert_array_equal(ops.masked_sum_u64(vals, device=card),
                                      np.add.reduce(vals, axis=0))
