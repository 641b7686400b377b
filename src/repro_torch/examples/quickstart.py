"""Quickstart: train the paper's char-LM locally for a few steps, then
sample text through the serving path (prefill + decode).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import load_corpus, sample_batch
from repro_torch.examples._common import parse, parser
from repro_torch.models import build
from repro_torch.optim import adamw, apply_updates


def main(argv=None):
    _, dev = parse(parser(__doc__), argv)
    # CI smoke budget: REPRO_EXAMPLE_ROUNDS=2 trims steps and sampling
    budget = os.environ.get("REPRO_EXAMPLE_ROUNDS")
    steps = 60 if budget is None else max(5, int(budget) * 5)
    new_tokens = 200 if budget is None else 40

    ds = load_corpus()
    cfg = get_config("charlm-shakespeare").replace(
        vocab_size=max(ds.vocab_size, 64))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), dev).params()
    opt = adamw(3e-3)
    opt_state = opt.init(params)

    rng = np.random.default_rng(0)
    print(f"training {steps} steps on", len(ds.train), "chars ...")
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in sample_batch(ds.train, rng, 32, 64).items()}
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, _ = model.train_loss(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        ups, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, ups)
        if step % 10 == 0:
            print(f"  step {step:3d} loss {float(loss.detach()):.3f}")

    # sample through the serving path
    prompt = "HAMLET:\n"
    toks = torch.as_tensor(ds.encode(prompt), device=dev)[None, :]
    logits, cache = model.prefill(params, {"tokens": toks},
                                  max_new_tokens=new_tokens)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = toks[0].tolist()
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(new_tokens):
        out.append(int(tok[0, 0]))
        logits, cache = model.decode_step(params, cache, tok)
        probs = torch.softmax(logits[:, -1] / 0.8, dim=-1)
        tok = torch.multinomial(probs, 1, generator=gen)
    print("\n--- sample ---")
    print(ds.decode(out))
    return out


if __name__ == "__main__":
    main()
