#!/usr/bin/env python3
"""Times the char-LM client's LocalTrain of one checkout's port on one
CUDA card, so that two checkouts can be compared on one card and host.

    python3 scripts/client_ab.py [--root DIR] [--label NAME]

``repro_torch`` comes from ``DIR/src`` (default: this checkout). The
full-width char-LM (``configs/charlm_shakespeare.py``, vocabulary
widened to the corpus) trains clients through
``ClientRunner.train_client`` at FedAvg's knobs (k 6, s 40, b 16,
grad_accum 1, q 0: no wire kernel), one warm-up client and then
``--clients`` timed ones, each on the host clock and ended by the
client's own sync. Prints one JSON line: seconds per client (each and
the median) and per microbatch. To compare two checkouts, run it in
turns in one call: A, B, B, A. Needs one card; imports neither JAX nor
the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--clients", type=int, default=6)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))

    import torch
    from repro_torch.configs.charlm_shakespeare import CONFIG, FL
    from repro_torch.core import ClientRunner, calibrate
    from repro_torch.core.policy import fedavg_knobs
    from repro_torch.data import FederatedData, load_corpus
    from repro_torch.models import build

    if not torch.cuda.is_available():
        print("client_ab: no CUDA device", file=sys.stderr)
        return 2
    ds = load_corpus()
    cfg = CONFIG.replace(vocab_size=max(CONFIG.vocab_size, ds.vocab_size))
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(1), "cuda").params()
    n_params = sum(t.numel() for t in params.values())
    runner = ClientRunner(model, FL, FederatedData(ds.train, FL.num_clients,
                                                   seed=FL.seed),
                          calibrate(n_params, FL), device="cuda")
    knobs = fedavg_knobs(FL)
    runner.train_client(0, params, knobs)              # warm-up
    seconds = []
    for c in range(args.clients):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.train_client(1 + c % (FL.num_clients - 1), params, knobs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    micro = knobs.s * knobs.grad_accum
    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"label": args.label, "root": args.root,
                      "knobs": knobs.as_dict(), "seconds": seconds,
                      "median_s": statistics.median(seconds),
                      "ms_per_microbatch":
                          1e3 * statistics.median(seconds) / micro,
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
