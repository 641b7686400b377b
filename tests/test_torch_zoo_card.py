"""The model zoo on a card (marked ``cuda``; skips without one), with no
JAX, so that it runs where the port does.

- Each new config's SMOKE prefill (f32: the flash kernel's f32
  variants) on the card against the same prefill on the CPU from the
  same weights: logits and every cache within 1e-4 of the tensor's
  largest magnitude (fp32 on both, sums in other orders, no TF32).
- RecurrentGemma, xLSTM and SeamlessM4T at SMOKE size (f32) likewise,
  prefill and then 4 decode steps fed the same tokens, card against CPU
  from the same weights: logits and every cache (the recurrent states
  included) within the same 1e-4; the flash kernel once per attention
  layer in prefill (SeamlessM4T: its encoder layers and the decoder's
  self- and cross-attention) and, in SeamlessM4T's decode, once per
  decoder layer (the cross-attention at Sq 1).
- MLA at DeepSeek-V3's head widths (q/k 128 + 64 = 192, v 128, padded
  to 192 for the kernel) in bf16 on the card, the flash kernel's
  ``mma_bf16`` variant, against the same layer in f32 on the CPU:
  relative L2 within 2^-6 (a few bf16 roundings of 2^-8 each along the
  layer).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import MLAConfig, get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.kernels import cuda_lib, ops  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import flatten, unflatten  # noqa: E402

NEW = ["qwen2-72b", "mistral-large-123b", "minitron-8b", "paligemma-3b",
       "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"]
RECURRENT = ["recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-medium"]
RTOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernel has no CPU mode)")
    return torch.device("cuda")


def to(tree, dev, dtype=None):
    return {k: v.to(dev, dtype) if dtype and v.is_floating_point()
            else v.to(dev) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW)
def test_smoke_prefill_card_matches_cpu(card, arch):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(3), "cpu").params()
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 2, 64, seed=3).items()}
    want, want_cache = model.prefill(params, batch, max_new_tokens=4)
    before = ops.LAUNCHES["flash_attention_bhsd"]
    got, got_cache = model.prefill(to(params, card), to(batch, card),
                                   max_new_tokens=4)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bhsd"] == before + cfg.num_layers
    pairs = [("logits", got, want)] + [
        (name, flatten(got_cache)[name], w)
        for name, w in flatten(want_cache).items()]
    for name, g, w in pairs:
        w = w.double()
        gap = float((g.cpu().double() - w).abs().max())
        assert gap <= RTOL * max(float(w.abs().max()), 1e-30), name


def flash_per_prefill(cfg) -> int:
    if cfg.encdec:
        return cfg.enc_layers + 2 * cfg.num_layers
    return sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))


def assert_within(name, got, want):
    want = want.double()
    gap = float((got.cpu().double() - want).abs().max())
    assert gap <= RTOL * max(float(want.abs().max()), 1e-30), (name, gap)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_smoke_card_matches_cpu(card, arch):
    cfg = get_smoke_config(arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(4), "cpu").params()
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 2, 96, seed=4).items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 4),
                         generator=torch.Generator().manual_seed(5))
    want, want_cache = model.prefill(params, batch, max_new_tokens=4)
    before = ops.LAUNCHES["flash_attention_bhsd"]
    got, got_cache = model.prefill(to(params, card), to(batch, card),
                                   max_new_tokens=4)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bhsd"] == \
        before + flash_per_prefill(cfg)
    assert_within("prefill logits", got, want)
    before = ops.LAUNCHES["flash_attention_bhsd"]
    for i in range(4):
        want, want_cache = model.decode_step(params, want_cache,
                                             toks[:, i:i + 1])
        got, got_cache = model.decode_step(to(params, card), got_cache,
                                           toks[:, i:i + 1].to(card))
        assert_within(f"decode {i}", got, want)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bhsd"] == before + (
        4 * cfg.num_layers if cfg.encdec else 0)
    for name, w in flatten(want_cache).items():
        assert_within(name, flatten(got_cache)[name], w)


@pytest.mark.cuda
def test_mla_at_full_head_widths_on_the_card(card):
    cfg = get_smoke_config("deepseek-v3-671b").replace(
        d_model=64, num_heads=2, num_kv_heads=2,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128))
    cfg16 = cfg.replace(param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)
    p = L.mla_init(torch.Generator().manual_seed(8), cfg,
                   torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(1, 300, cfg.d_model)).astype(np.float32))
    pos = torch.arange(300)[None]
    with torch.no_grad():
        want, _ = L.mla_apply_full(p, x, pos, cfg)
        before = cuda_lib.FLASH_VARIANTS["mma_bf16"]
        got, _ = L.mla_apply_full(
            unflatten(to(flatten(p), card, torch.bfloat16)),
            x.to(card, torch.bfloat16), pos.to(card), cfg16)
        torch.cuda.synchronize()
    assert cuda_lib.FLASH_VARIANTS["mma_bf16"] == before + 1
    got = got.float().cpu()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 2.0 ** -6, rel
