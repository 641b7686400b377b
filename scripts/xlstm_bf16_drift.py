#!/usr/bin/env python3
"""How far two runs of xLSTM-1.3B part, block by block, on one CUDA card.

    python3 scripts/xlstm_bf16_drift.py [--prompt 2048] [--steps 16]

The full-width, full-depth model (48 blocks, random weights from a seed)
in bf16 and then in float32 (the same weights cast). Per block, the
relative L2 distance between:

- ``prefix``: the block's output at position S - 1 in a prefill over S
  + 1 tokens against the same position in a prefill over S tokens. The
  two compute the same function of the same tokens; only the GEMMs' M
  (S vs S + 1) differs, so any gap is rounding;
- ``decode``: one decode step after a prefill over S tokens against the
  prefill over S + 1 tokens, at the new position.

Then the logits of decode steps 1 and ``--steps`` against a prefill over
the prompt plus the tokens so far (greedy tokens of the bf16 run), as
``chip_smoke.py``'s check (b) takes them. One JSON line per dtype.
Needs a card; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def run(dtype, prompt, steps: int, dev, tokens=None) -> dict:
    """Per-block prefix and decode gaps and the logit gaps in ``dtype``;
    ``tokens``: the decode's inputs (greedy when None)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import transformer as T

    cfg = get_config("xlstm-1.3b").replace(param_dtype=dtype,
                                           compute_dtype=dtype)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        dev).params()
    s = prompt.shape[1]
    seen = {"tag": None}
    outs = {}
    real_full, real_decode = T.block_apply_full, T.block_apply_decode

    def full(p, x, positions, c, spec, s_buf=None):
        out = real_full(p, x, positions, c, spec, s_buf)
        if seen["tag"]:
            outs.setdefault(seen["tag"], []).append(
                out[0][:, s - 1:s + 1].float().clone())
        return out

    def decode(p, x, cache, c, spec):
        out = real_decode(p, x, cache, c, spec)
        if seen["tag"]:
            outs.setdefault(seen["tag"], []).append(out[0][:, -1:].float())
        return out

    T.block_apply_full, T.block_apply_decode = full, decode
    try:
        with torch.no_grad():
            first_tok = tokens[0] if tokens else None
            seen["tag"] = "short"
            logits, caches = model.prefill(params, {"tokens": prompt},
                                           max_new_tokens=steps)
            tok = logits.argmax(-1) if first_tok is None else first_tok
            seen["tag"] = "decode"
            first, caches = model.decode_step(params, caches, tok)
            first = first.clone()
            seen["tag"] = "long"
            after_one, _ = model.prefill(params, {"tokens": torch.cat(
                [prompt, tok], 1)})
            seen["tag"] = None
            fed = [tok]
            out = first
            for i in range(1, steps):
                tok = out.argmax(-1) if tokens is None else tokens[i]
                fed.append(tok)
                out, caches = model.decode_step(params, caches, tok)
            after_all, _ = model.prefill(params, {"tokens": torch.cat(
                [prompt] + fed, 1)})
    finally:
        T.block_apply_full, T.block_apply_decode = real_full, real_decode
    blocks = [[i, T.block_spec(cfg, i).kind,
               rel_l2(outs["long"][i][:, 0], outs["short"][i][:, 0]),
               rel_l2(outs["decode"][i][:, 0], outs["long"][i][:, 1])]
              for i in range(cfg.num_layers)]
    return {"dtype": str(dtype), "prompt": s, "steps": steps,
            "blocks [i, kind, prefix, decode]": blocks,
            "logits_step_1": rel_l2(first, after_one),
            f"logits_step_{steps}": rel_l2(out, after_all), "tokens": fed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xlstm_bf16_drift: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    dev = resolve_device("cuda")
    vocab = get_config("xlstm-1.3b").vocab_size
    prompt = torch.randint(0, vocab, (1, args.prompt),
                           generator=torch.Generator(device=dev).manual_seed(
                               1), device=dev)
    tokens = None
    for dtype in (torch.bfloat16, torch.float32):
        rec = run(dtype, prompt, args.steps, dev, tokens)
        tokens = rec.pop("tokens")
        print(json.dumps({"phase": "xlstm_drift",
                          "device": torch.cuda.get_device_name(0), **rec}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
