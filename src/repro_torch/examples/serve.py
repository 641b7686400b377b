"""Serving-path demo on a reduced assigned architecture: batched prefill
and sliding-window decode (the long_500k mechanism) on RecurrentGemma,
through ``launch.steps.make_prefill_step`` and ``make_decode_step``
(without a gradient every attention is the flash kernel on the card).

    PYTHONPATH=src python -m repro_torch.examples.serve [--arch recurrentgemma-2b] [--device cpu]
"""
import time

import numpy as np
import torch

from repro_torch.configs import INPUT_SHAPES, get_smoke_config
from repro_torch.examples._common import parse, parser
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import build


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    args, dev = parse(ap, argv)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = get_smoke_config(args.arch)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), dev).params()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len))
             .astype(np.int32)}
    if cfg.frontend and cfg.frontend.kind == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(args.batch, cfg.frontend.num_prefix_tokens,
                  cfg.frontend.embed_dim)).astype(np.float32)
    if cfg.encdec:
        batch["src_embeds"] = rng.normal(
            size=(args.batch, 32, cfg.frontend.embed_dim)).astype(np.float32)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    prefill = make_prefill_step(model, INPUT_SHAPES["prefill_32k"],
                                max_new_tokens=args.new_tokens)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    sync()
    print(f"[{args.arch}] prefill {args.batch}x{args.prompt_len} "
          f"in {time.perf_counter() - t0:.2f}s -> logits "
          f"{tuple(logits.shape)}")

    step = make_decode_step(model)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    for _ in range(args.new_tokens):
        logits, cache = step(params, cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    sync()
    dt = time.perf_counter() - t0
    print(f"decoded {args.new_tokens} tokens/seq in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s); "
          f"cache is O(window) for local-attn/recurrent blocks")
    return logits


if __name__ == "__main__":
    main()
