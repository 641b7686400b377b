"""The port's flash attention against the JAX reference.

On the CPU: ``repro_torch.kernels.ref.flash_attention_ref`` (the plain
twin the CPU path and ``ops.flash_attention`` use) against
``repro.kernels.ref.flash_attention_ref`` and against the Pallas kernel
``flash_attention_bhsd`` run in interpret mode, as
``tests/test_kernels_flash.py`` runs it, on the same numpy inputs:
causal, sliding window, softcap, bidirectional, GQA with g in {1, 2},
f32 and bf16, S a multiple of the Pallas block.

Tolerances: f32 within 2e-5 absolute at unit-scale inputs (all sides do
fp32 math, summing in other orders; the reference's own kernel tests
use the same bound). bf16 within one bf16 ulp of the larger magnitude
plus that f32 bound: every side computes in fp32 from the same bf16
inputs (parting by up to the f32 bound) and rounds once to bf16 at the
end, so a value near a rounding boundary may land on either neighbour;
the f32 term covers outputs near zero, where heads of both signs cancel
and the ulp is far below the fp32 sums' own error.

On a card (marked ``cuda``): the CUDA kernel against the twin on the
same CUDA tensors, at the same tolerances, with S not a multiple of any
tile, S = 1 and D not a multiple of 32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import cuda_lib, ops, ref  # noqa: E402

F32_ATOL = 2e-5


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
