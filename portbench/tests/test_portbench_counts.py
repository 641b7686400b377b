"""The benchmark's FLOP and byte counts against torch's FLOP counter and
hand counts, and the check that nothing the command runs imports JAX or
the JAX package (top-level module names compared whole)."""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, harness
from portbench.reference import charlm, moe_lm, weights

ROOT = harness.ROOT

MOE = {"num_layers": 2, "d_model": 32, "num_heads": 4, "num_kv_heads": 2,
       "head_dim": 8, "num_experts": 4, "top_k": 2, "d_ff_expert": 48,
       "capacity_factor": 100.0, "group_size": 64, "aux_loss_weight": 0.01,
       "vocab_size": 40, "rope_theta": 10000.0, "tie_embeddings": False,
       "dtype": "float32"}
CHARLM = {"num_layers": 2, "d_model": 16, "num_heads": 2, "num_kv_heads": 2,
          "head_dim": 8, "d_ff": 32, "vocab_size": 24, "learned_pos_emb": 64,
          "rope_theta": 10000.0, "mlp_type": "gelu", "tie_embeddings": True,
          "dtype": "float32"}


def _full_attention(cfg, batch, seq):
    """What the counter sees of attention: the full S x S products."""
    return cfg["num_layers"] * batch * 4 * cfg["head_dim"] * cfg[
        "num_heads"] * seq * seq


def test_causal_pairs_and_attention_by_hand():
    assert counts.causal_pairs(1) == 1
    assert counts.causal_pairs(4) == 10
    # 2 heads of width 8 over 4 positions: 10 pairs x 2 products x 2 x 8
    assert counts.attention_flops(4, 2, 8) == 10 * 2 * 2 * 8 * 2


def test_moe_forward_flops_match_the_counter():
    """A forward pass of the reference MoE decoder (capacity wide enough
    that no pair drops): the counter's FLOPs minus its full S x S
    attention equal the benchmark's count minus its causal attention."""
    seq = 24
    w = weights.make_weights(MOE, 5, "cpu")
    ws = [weights.layer_weights(MOE, 5, "cpu", i) for i in range(2)]
    io = weights.io_weights(MOE, 5, "cpu")
    tok = torch.randint(0, MOE["vocab_size"], (seq,))
    with FlopCounterMode(display=False) as fc:
        x = moe_lm.embed(io, tok)
        for lw in ws:
            x, _, _ = moe_lm.block(lw, x, MOE)
        moe_lm.head_logits(io, x)
    causal = MOE["num_layers"] * counts.attention_flops(seq, 4, 8)
    assert (fc.get_total_flops() - _full_attention(MOE, 1, seq)
            == counts.forward_flops(MOE, 1, seq) - causal)
    assert len(w) == len(weights.leaf_specs(MOE))


def test_charlm_train_flops_match_the_counter_when_everything_trains():
    """Forward and backward of the reference char-LM with every leaf
    trainable: the counter's matrix FLOPs (its attention full S x S, 3x
    for forward and backward) against ``train_flops`` with every layer
    trainable. The tied unembedding's weight gradient is the head's."""
    b, s = 3, 12
    p = {k: v.unsqueeze(0).requires_grad_(True)
         for k, v in weights.make_weights(CHARLM, 1, "cpu").items()}
    tok = torch.randint(0, CHARLM["vocab_size"], (1, b, s))
    with FlopCounterMode(display=False) as fc:
        loss = charlm.losses(p, tok, tok, CHARLM).sum()
        loss.backward()
    full = 3 * _full_attention(CHARLM, b, s)
    causal = 3 * CHARLM["num_layers"] * b * counts.attention_flops(s, 2, 8)
    ours = counts.train_flops(CHARLM, b, s, [True, True],
                              head_trainable=True)
    # the counter also sees the first layer's input gradient, which the
    # benchmark counts (every layer from the lowest trainable one up)
    assert fc.get_total_flops() - full == ours - causal


def test_train_flops_leave_frozen_layers_out():
    cfg = dict(CHARLM, num_layers=3)
    p = counts.layer_matmul_params(cfg)
    tokens, b, s = 40, 5, 8
    mm = 2 * tokens * (p["attn"] + p["mlp"])
    att = b * counts.attention_flops(s, 2, 8)
    fwd = counts.forward_flops(cfg, b, s)
    head = 2 * tokens * p["head"]
    # only the top layer trains: its input and weight gradients and
    # attention's backward, the head's input gradient
    assert counts.train_flops(cfg, b, s, [False, False, True],
                              head_trainable=False) == (
        fwd + head + (2 * mm + 2 * att))
    # the middle one trains: the top layer passes gradients down
    assert counts.train_flops(cfg, b, s, [False, True, False],
                              head_trainable=True) == (
        fwd + 2 * head + (2 * mm + 2 * att) + (mm + 2 * att))


def test_wire_bytes_by_hand():
    wb = counts.wire_bytes([300, 256, 1])
    assert wb["blocks"] == 2 + 1 + 1
    values = 4 * 256
    assert wb["quantize"] == values * 4 + values + 4 * 4
    assert wb["dequantize"] == values + 4 * 4 + values * 4


def test_flash_bound_by_hand():
    # 8,192 tokens, 32 heads over 8, D 128: compute-bound
    t = counts.flash_bound_seconds(8192, 32, 8, 128)
    flops = 4 * 128 * 32 * 8192 * 8193 // 2
    assert t == pytest.approx(flops / 989e12)
    # one position: bytes-bound
    t1 = counts.flash_bound_seconds(1, 32, 8, 128)
    assert t1 == pytest.approx(2 * 128 * (64 + 16) / 3.35e12)


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules({"repro_torch": 1, "repro_torch.fl": 1,
                                      "jaxtyping": 1}) == []
    assert harness.forbidden_modules({"repro.core": 1, "jax.numpy": 1}) == [
        "jax", "repro"]


def test_nothing_the_command_runs_imports_jax_or_the_jax_package():
    """Import every module of the benchmark and every module of the
    program its drivers import, in a fresh process, and list the
    top-level names loaded."""
    code = """
import glob, json, os, sys
root = sys.argv[1]
sys.path[:0] = [root, os.path.join(root, "src")]
from portbench import harness
for sub in ("drivers", "metrics"):
    for path in sorted(glob.glob(os.path.join(root, "portbench", sub, "*.py"))):
        harness.load_module(path, "m_" + os.path.basename(path)[:-3])
import portbench.tools.settle_duals
import repro_torch.fl, repro_torch.launch.steps, repro_torch.models
import repro_torch.core.freezing, repro_torch.optim
import repro_torch.analysis.runtime, repro_torch.data.shakespeare
import repro_torch.configs.charlm_shakespeare, repro_torch.configs.phi3_5_moe
print(json.dumps(harness.forbidden_modules()))
"""
    env = dict(os.environ, USE_FLAX="0")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(ROOT, "portbench", "reference")
    for name in os.listdir(ref_dir):
        if name.endswith(".py"):
            with open(os.path.join(ref_dir, name)) as f:
                text = f.read()
            for bad in ("import repro", "from repro", "import jax",
                        "from jax"):
                assert bad not in text, (name, bad)
