#!/usr/bin/env python3
"""How far two bf16 runs of Gemma2's 42-layer serving path part, on the CPU.

    PYTHONPATH=src python3 scripts/serve_bf16_gaps.py [--widths 512 1024 2048]

The logit checks of ``chip_smoke.py``'s serving phase (the flash kernel
against its plain version inside the model, decode against prefill) need
a bound set from the bf16 path's own rounding, before the card is asked.
This script sizes it at full depth (42 layers) and reduced widths, with
the plain attention on the CPU: for each width it prints, as one JSON
line, the relative L2 gap of the last-token logits

- ``flip``: between a prefill and the same prefill with one bf16 ulp
  added to 0.1% of the attention outputs (a stand-in for a kernel that
  rounds a few values the other way);
- ``decode``: between one decode step after a prefill and a prefill
  over the prompt plus that token.

Numbers from this script are CPU numbers: they size a tolerance, they
are no device metric.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def gaps(width: int, seq: int) -> dict:
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build

    cfg = get_config("gemma2-9b").replace(
        d_model=width, num_heads=4, num_kv_heads=2, head_dim=128,
        d_ff=2 * width, vocab_size=4096, window=seq // 2)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu").params()
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen)
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=seq,
                                global_batch=1)
    prefill = make_prefill_step(model, shape, max_new_tokens=1)
    logits, caches = prefill(params, {"tokens": prompt})

    plain = ops.flash_attention

    def flipped(q, k, v, **kw):
        out = plain(q, k, v, **kw)
        pick = torch.rand(out.shape, generator=gen) < 1e-3
        bits = out.view(torch.int16)
        return torch.where(pick, bits + 1, bits).view(torch.bfloat16)

    ops.flash_attention = flipped
    try:
        perturbed, _ = prefill(params, {"tokens": prompt})
    finally:
        ops.flash_attention = plain
    tok = logits.argmax(-1)
    decoded, _ = make_decode_step(model)(params, caches, tok)
    full, _ = prefill(params, {"tokens": torch.cat([prompt, tok], 1)})
    return {"width": width, "layers": cfg.num_layers, "seq": seq,
            "flip": rel_l2(perturbed, logits), "decode": rel_l2(decoded, full)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+",
                    default=[512, 1024, 2048])
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    for width in args.widths:
        print(json.dumps(gaps(width, args.seq)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
