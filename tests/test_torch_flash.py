"""The port's flash attention against the JAX reference.

On the CPU: ``repro_torch.kernels.ref.flash_attention_ref`` (the plain
twin the CPU path and ``ops.flash_attention`` use) against
``repro.kernels.ref.flash_attention_ref`` and against the Pallas kernel
``flash_attention_bhsd`` run in interpret mode, as
``tests/test_kernels_flash.py`` runs it, on the same numpy inputs:
causal, sliding window, softcap, bidirectional, GQA with g in {1, 2},
f32 and bf16, S a multiple of the Pallas block; and the
cross-attention's non-causal pairs with q and k of different lengths
(Sq in {1, 7, 129} against Sk in {128, 1000, 4096}, D 64), the Pallas
kernel run with one q block and a k block that divides Sk.

Tolerances: f32 within 2e-5 absolute at unit-scale inputs (all sides do
fp32 math, summing in other orders; the reference's own kernel tests
use the same bound). bf16 within one bf16 ulp of the larger magnitude
plus that f32 bound: every side computes in fp32 from the same bf16
inputs (parting by up to the f32 bound) and rounds once to bf16 at the
end, so a value near a rounding boundary may land on either neighbour;
the f32 term covers outputs near zero, where heads of both signs cancel
and the ulp is far below the fp32 sums' own error.

Also on the CPU: a plain-torch emulation of the tensor-core variant's
roundings (bf16 Q/K/V exact in fp32, fp32 scores, an online softmax over
key tiles, P split into bf16 hi + lo for the PV product, one bf16
rounding of the output) held to the twin within the bf16 bound, and one
rounding of P shown to break it: the reason the kernel splits P.

On a card (marked ``cuda``): the CUDA kernel against the twin on the
same CUDA tensors, at the same tolerances, with S not a multiple of any
tile, S = 1 and D not a multiple of 32; the tensor-core variant at its
tile edges; the f32 row variant at the char-LM eval's shapes; strided
(non-contiguous) inputs; the per-variant launch counts; and the
cross-attention's non-causal pairs with Sq != Sk at D 64 (SeamlessM4T)
and D 256 with 10 query heads over 1 (RecurrentGemma's MQA group).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_lib, ops, ref  # noqa: E402

F32_ATOL = 2e-5


def over_bound(got, want, dtype: str) -> int:
    """How many values of ``got`` lie outside the bound around ``want``."""
    got = torch.as_tensor(got).to(torch.float32)
    want = torch.as_tensor(want).to(torch.float32)
    gap = (got - want).abs()
    if dtype == "bfloat16":
        bound = bf16_ulp(torch.maximum(got.abs(), want.abs())) + F32_ATOL
    else:
        bound = torch.full_like(gap, F32_ATOL)
    return int((gap > bound).sum())


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().to(torch.float32))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def assert_close(got, want, dtype: str) -> None:
    """``got`` within the stated tolerance of ``want`` (numpy or torch)."""
    got = torch.from_numpy(np.array(got, np.float32))
    want = torch.from_numpy(np.array(want, np.float32))
    assert got.shape == want.shape
    gap = (got - want).abs()
    if dtype == "bfloat16":
        bound = bf16_ulp(torch.maximum(got.abs(), want.abs())) + F32_ATOL
    else:
        bound = torch.full_like(gap, F32_ATOL)
    over = gap > bound
    assert not bool(over.any()), (
        f"{int(over.sum())} values over the bound; max |gap| "
        f"{float(gap.max())}")


def inputs(seed, b, s, h, kvh, d, dtype):
    """Unit normal q, k, v as numpy (bf16 rounded where asked) and their
    torch twins; the same values feed both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for heads in (h, kvh, kvh):
        x = torch.from_numpy(rng.normal(size=(b, s, heads, d)).astype(
            np.float32))
        out.append(x.to(getattr(torch, dtype)))
    return out


def to_jax(t, jnp):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.to(torch.float32).numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def J():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_bhsd
    return jnp, jref, flash_attention_bhsd


CASES = [
    # (s, h, kvh, d, causal, window, softcap)
    (64, 2, 2, 32, True, None, None),
    (128, 4, 2, 64, True, None, None),
    (128, 4, 2, 32, True, 48, None),
    (256, 2, 1, 16, True, 64, 30.0),
    (128, 2, 2, 32, True, None, 50.0),
    (64, 4, 2, 24, False, None, None),
    (128, 2, 1, 32, False, 40, 20.0),
]
IDS = [f"s{c[0]}-h{c[1]}kv{c[2]}-d{c[3]}-{'causal' if c[4] else 'bidir'}"
       f"-w{c[5]}-cap{c[6]}" for c in CASES]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_twin_matches_reference_oracle(case, dtype, J):
    jnp, jref, _ = J
    s, h, kvh, d, causal, window, softcap = case
    q, k, v = inputs(s + d, 2, s, h, kvh, d, dtype)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    want = jref.flash_attention_ref(to_jax(q, jnp), to_jax(k, jnp),
                                    to_jax(v, jnp), causal=causal,
                                    window=window, softcap=softcap)
    assert got.dtype == q.dtype and tuple(got.shape) == tuple(want.shape)
    assert_close(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                 dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES[:5], ids=IDS[:5])
def test_twin_matches_pallas_kernel_in_interpret_mode(case, dtype, J):
    """The twin against the TPU kernel itself (interpret mode, 64-row
    blocks so several kv blocks are skipped or masked)."""
    jnp, _, pallas = J
    s, h, kvh, d, causal, window, softcap = case
    q, k, v = inputs(s * 3 + d, 1, s, h, kvh, d, dtype)
    got = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
    tq, tk, tv = (to_jax(t, jnp).transpose(0, 2, 1, 3) for t in (q, k, v))
    want = pallas(tq, tk, tv, causal=causal, window=window, softcap=softcap,
                  blk_q=64, blk_k=64, interpret=True).transpose(0, 2, 1, 3)
    assert_close(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                 dtype)


#: non-causal pairs with q and k of different lengths (the cross-attention:
#: Sq 4,096 in prefill and 1 in decode against Sk 4,096 source frames, at
#: sizes the CPU holds), and the Pallas k block for each Sk
CROSS = [(sq, sk) for sq in (1, 7, 129) for sk in (128, 1000, 4096)]
CROSS_BLK_K = {128: 128, 1000: 200, 4096: 512}


def cross_inputs(seed, b, sq, sk, h, kvh, d, dtype):
    """Unit normal q (B,Sq,H,D) and k, v (B,Sk,KVH,D), as ``inputs``."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, s, heads, d)).astype(
        np.float32)).to(getattr(torch, dtype))
        for s, heads in ((sq, h), (sk, kvh), (sk, kvh))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", CROSS, ids=str)
def test_twin_matches_pallas_kernel_with_sq_ne_sk(sq, sk, dtype, J):
    """Bidirectional attention with Sq != Sk: the twin against the
    reference's oracle and against the Pallas kernel in interpret mode
    (one q block of Sq rows, k blocks of ``CROSS_BLK_K[sk]``)."""
    jnp, jref, pallas = J
    q, k, v = cross_inputs(sq * 7 + sk, 1, sq, sk, 4, 2, 64, dtype)
    got = ref.flash_attention_ref(q, k, v, causal=False)
    assert tuple(got.shape) == (1, sq, 4, 64) and got.dtype == q.dtype
    want = jref.flash_attention_ref(to_jax(q, jnp), to_jax(k, jnp),
                                    to_jax(v, jnp), causal=False)
    assert_close(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                 dtype)
    tq, tk, tv = (to_jax(x, jnp).transpose(0, 2, 1, 3) for x in (q, k, v))
    kernel = pallas(tq, tk, tv, causal=False, blk_q=sq,
                    blk_k=CROSS_BLK_K[sk], interpret=True)
    assert_close(got.to(torch.float32).numpy(),
                 np.asarray(kernel.transpose(0, 2, 1, 3), np.float32), dtype)


def test_scale_argument_matches_reference(J):
    jnp, jref, _ = J
    q, k, v = inputs(5, 1, 64, 4, 2, 32, "float32")
    got = ref.flash_attention_ref(q, k, v, scale=0.3, softcap=10.0)
    want = jref.flash_attention_ref(to_jax(q, jnp), to_jax(k, jnp),
                                    to_jax(v, jnp), scale=0.3, softcap=10.0)
    assert_close(got.numpy(), np.asarray(want), "float32")


def test_cpu_tensors_take_the_twin(monkeypatch):
    """``ops.flash_attention`` on CPU tensors is the twin, exactly; the
    kernel loader is never called and no launch is counted."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel loader")

    monkeypatch.setattr(cuda_lib, "load_library", refuse)
    before = dict(ops.LAUNCHES)
    q, k, v = inputs(9, 2, 33, 4, 2, 24, "float32")
    got = ops.flash_attention(q, k, v, window=8, softcap=50.0)
    want = ref.flash_attention_ref(q, k, v, window=8, softcap=50.0)
    assert torch.equal(got, want)
    assert ops.LAUNCHES == before


def test_kernel_wrapper_refuses_cpu_tensors():
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bhsd(q, q, q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_attention_bhsd(q.half(), q.half(), q.half())


# ---------------------------------------------------------------------------
# the tensor-core variant's roundings, emulated in plain torch
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def emulate_mma_bf16(q, k, v, *, causal, window, softcap, split_p=True,
                     block_k=32):
    """The ``mma_bf16`` variant's arithmetic on the CPU: q (B,S,H,D),
    k/v (B,S,KVH,D) in bf16 -> (B,S,H,D) bf16. Scores and sums in fp32
    (the inputs and their products are exact in fp32); the online softmax
    runs over key tiles of ``block_k`` with fp32 m, l and accumulator; P
    enters the PV product as bf16 hi + lo (or one bf16 rounding); the
    output is rounded to bf16 once."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).transpose(1, 2)                    # B,H,S,D
    kf = k.to(torch.float32).repeat_interleave(h // kvh, 2).transpose(1, 2)
    vf = v.to(torch.float32).repeat_interleave(h // kvh, 2).transpose(1, 2)
    qpos = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq, 1), -1e30)
    l_ = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    for k0 in range(0, sk, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        s = (qf @ kt.transpose(-1, -2)) * (1.0 / np.sqrt(d))
        if softcap is not None:
            s = softcap * torch.tanh(s * np.float32(1.0 / softcap))
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        keep = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window is not None:
            keep &= kpos > qpos - window
        s = s.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new), torch.zeros(()))
        l_ = l_ * corr + p.sum(-1, keepdim=True)
        hi = _bf16(p)
        pv = hi @ vt
        if split_p:
            pv = pv + _bf16(p - hi) @ vt
        acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp(l_, min=1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


EMULATED = [  # (s, h, kvh, d, causal, window, softcap)
    (1, 2, 1, 24, True, None, 50.0),
    (65, 4, 2, 24, True, 16, None),
    (129, 2, 2, 128, True, None, 50.0),
    (200, 4, 2, 128, False, 64, 50.0),
    (256, 2, 1, 256, True, None, None),
    (256, 2, 2, 256, True, 100, 50.0),
]


@pytest.mark.parametrize("case", EMULATED, ids=str)
def test_split_p_emulation_within_bf16_bound(case):
    s, h, kvh, d, causal, window, softcap = case
    q, k, v = inputs(s * 5 + d, 1, s, h, kvh, d, "bfloat16")
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = emulate_mma_bf16(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert over_bound(got, want, "bfloat16") == 0


def test_one_bf16_rounding_of_p_breaks_the_bound():
    """P rounded once to bf16 (no lo part) puts outputs near zero outside
    the bound: the split is needed, not a refinement."""
    q, k, v = inputs(3, 1, 256, 2, 2, 128, "bfloat16")
    kw = dict(causal=True, window=None, softcap=None)
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert over_bound(emulate_mma_bf16(q, k, v, split_p=False, **kw), want,
                      "bfloat16") > 0
    assert over_bound(emulate_mma_bf16(q, k, v, **kw), want, "bfloat16") == 0


# ---------------------------------------------------------------------------
# the CUDA kernel against the twin (on a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaFlash:
    SHAPES = [  # (b, s, h, kvh, d)
        (1, 1, 2, 1, 24), (2, 7, 4, 2, 24), (1, 129, 4, 4, 128),
        (2, 200, 16, 8, 256), (1, 64, 8, 2, 64)]
    OPTIONS = [(True, None, None), (True, 64, None), (True, 64, 50.0),
               (False, None, None), (False, 64, 50.0), (True, None, 50.0)]

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("opts", OPTIONS, ids=str)
    @pytest.mark.parametrize("shape", SHAPES, ids=str)
    def test_kernel_matches_twin(self, card, shape, opts, dtype):
        b, s, h, kvh, d = shape
        causal, window, softcap = opts
        q, k, v = (t.to(card) for t in inputs(s + h, b, s, h, kvh, d, dtype))
        before = ops.LAUNCHES["flash_attention_bhsd"]
        got = ops.flash_attention(q, k, v, causal=causal, window=window,
                                  softcap=softcap)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_attention_bhsd"] == before + 1
        assert got.dtype == q.dtype and got.shape == q.shape
        assert_close(got.cpu().float().numpy(), want.cpu().float().numpy(),
                     dtype)

    @pytest.mark.parametrize("g", [1, 2])
    @pytest.mark.parametrize("d", [24, 64, 96, 128, 192, 256])
    @pytest.mark.parametrize("s", [1, 15, 16, 63, 64, 65, 127, 129, 1000])
    def test_mma_bf16_tile_edges(self, card, s, d, g):
        """The tensor-core variant around its 16-row, 64-row and 32/64-key
        tiles, for every mask option, at each padded head width (24 -> 32,
        64, 96 -> 128, 128, 192 (MLA's q/k width) -> 256, 256)."""
        q, k, v = (t.to(card) for t in inputs(s * 3 + d + g, 1, s, 2 * g, 2,
                                              d, "bfloat16"))
        for causal, window, softcap in self.OPTIONS:
            kw = dict(causal=causal, window=window, softcap=softcap)
            before = dict(cuda_lib.FLASH_VARIANTS)
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            assert cuda_lib.FLASH_VARIANTS["mma_bf16"] == \
                before["mma_bf16"] + 1
            assert over_bound(got.cpu(), want.cpu(), "bfloat16") == 0, kw

    @pytest.mark.parametrize("shape", [(64, 32, 8, 8, 24),
                                       (64, 128, 8, 8, 24),
                                       (3, 7, 4, 2, 24), (2, 33, 2, 1, 20),
                                       (1, 1000, 2, 2, 32)], ids=str)
    def test_rows_f32_at_eval_shapes(self, card, shape):
        """The f32 row variant at the char-LM eval's shapes (B 64, S 32
        and 128, H 8, D 24) and at ragged ones."""
        b, s, h, kvh, d = shape
        q, k, v = (t.to(card) for t in inputs(s + d, b, s, h, kvh, d,
                                              "float32"))
        for causal, window, softcap in self.OPTIONS:
            kw = dict(causal=causal, window=window, softcap=softcap)
            before = cuda_lib.FLASH_VARIANTS["rows_f32"]
            got = ops.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            assert cuda_lib.FLASH_VARIANTS["rows_f32"] == before + 1
            assert over_bound(got.cpu(), want.cpu(), "float32") == 0, kw

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d", [24, 20, 128])
    def test_strided_inputs(self, card, dtype, d):
        """q, k, v as slices of one fused projection (B, S, 3, H, D) and
        the (B, H, S, D) entry on transposed views: strides the kernel
        reads in place, and a head width that is not a multiple of 8
        (bf16's element-wise staging path)."""
        from repro_torch.kernels import flash_attention as fa
        gen = torch.Generator().manual_seed(d)
        fused = torch.randn((2, 77, 3, 4, d), generator=gen).to(
            getattr(torch, dtype)).to(card)
        q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
        assert not q.is_contiguous()
        kw = dict(causal=True, window=32, softcap=50.0)
        want = ref.flash_attention_ref(q, k, v, **kw)
        got = ops.flash_attention(q, k, v, **kw)
        got_bhsd = fa.flash_attention_bhsd(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            **kw).transpose(1, 2)
        torch.cuda.synchronize()
        for out in (got, got_bhsd):
            assert out.dtype == q.dtype and out.shape == q.shape
            assert over_bound(out.cpu(), want.cpu(), dtype) == 0

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("sq,sk", CROSS, ids=str)
    def test_kernel_with_sq_ne_sk(self, card, sq, sk, dtype):
        """Non-causal, q and k of different lengths (the
        cross-attention), with and without a softcap: D 64 (SeamlessM4T,
        H 16 over 16 and 4 over 2) and D 256 with 10 query heads over 1
        (RecurrentGemma's group)."""
        for h, kvh, d in ((16, 16, 64), (4, 2, 64), (10, 1, 256)):
            q, k, v = (x.to(card) for x in cross_inputs(
                sq + sk + h, 1, sq, sk, h, kvh, d, dtype))
            for softcap in (None, 50.0):
                before = ops.LAUNCHES["flash_attention_bhsd"]
                got = ops.flash_attention(q, k, v, causal=False,
                                          softcap=softcap)
                want = ref.flash_attention_ref(q, k, v, causal=False,
                                               softcap=softcap)
                torch.cuda.synchronize()
                assert ops.LAUNCHES["flash_attention_bhsd"] == before + 1
                assert got.dtype == q.dtype and got.shape == q.shape
                assert over_bound(got.cpu(), want.cpu(), dtype) == 0, \
                    (h, kvh, d, softcap)

    def test_variant_counts(self, card):
        """One launch per call, counted in total and under the variant
        the dtype and head width choose."""
        from repro_torch.kernels import flash_attention as fa
        cases = [("bfloat16", 24, "mma_bf16"), ("bfloat16", 256, "mma_bf16"),
                 ("float32", 24, "rows_f32"), ("float32", 32, "rows_f32"),
                 ("float32", 64, "tiled_f32"), ("float32", 256, "tiled_f32")]
        for dtype, d, name in cases:
            assert fa.variant(getattr(torch, dtype), d) == name
            q, k, v = (t.to(card) for t in inputs(d, 1, 9, 2, 1, d, dtype))
            before = dict(cuda_lib.FLASH_VARIANTS)
            total = ops.LAUNCHES["flash_attention_bhsd"]
            ops.flash_attention(q, k, v)
            assert ops.LAUNCHES["flash_attention_bhsd"] == total + 1
            after = dict(cuda_lib.FLASH_VARIANTS)
            assert {n: after[n] - before[n] for n in after} == {
                n: int(n == name) for n in after}
