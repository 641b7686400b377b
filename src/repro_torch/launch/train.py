"""FL training entry point (the paper's experiment), on the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.train --method both \\
        --rounds 25 --out results/fl               # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu ...

Writes <out>_<method>.json (round-by-round history, the reference's
format) and <out>_<method>.ckpt (final params, readable by both packages)
through engine callbacks. The flags are the reference's plus
``--device``; ``--executor`` and ``--server-opt`` go into ``FLConfig``
(``executor``, ``server_opt``), as in the reference.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict

from repro_torch.configs import get_config, get_fl_config
from repro_torch.core.server import FLResult
from repro_torch.data import load_corpus
from repro_torch.fl import (CheckpointCallback, FederatedEngine,
                            HistoryWriterCallback, LoggingCallback)
from repro_torch.models import build


def main(argv=None) -> Dict[str, FLResult]:
    """Run the methods the flags name; returns each method's result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="charlm-shakespeare")
    ap.add_argument("--method", default="both",
                    help='"cafl", "fedavg", "both", or any strategy name '
                         'the engine resolves (e.g. "fedadam", "cafl+adam")')
    ap.add_argument("--executor", default="sequential",
                    choices=["sequential", "batched"])
    ap.add_argument("--server-opt", default="",
                    help='server optimizer composed onto the method '
                         '("adam" = FedAdam, "momentum" = FedAvgM)')
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default="results/fl")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (the card; raises without one) or "cpu"')
    args = ap.parse_args(argv)

    ds = load_corpus()
    cfg = get_config(args.arch)
    if cfg.vocab_size < ds.vocab_size:
        cfg = cfg.replace(vocab_size=ds.vocab_size)
    fl = get_fl_config().replace(executor=args.executor,
                                 server_opt=args.server_opt)
    if args.rounds:
        fl = fl.replace(rounds=args.rounds)
    if args.seed is not None:
        fl = fl.replace(seed=args.seed)
    model = build(cfg)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".",
                exist_ok=True)

    results = {}
    methods = ["fedavg", "cafl"] if args.method == "both" else [args.method]
    for method in methods:
        path = f"{args.out}_{method}.json"
        callbacks = [HistoryWriterCallback(path),
                     CheckpointCallback(f"{args.out}_{method}.ckpt")]
        if not args.quiet:
            callbacks.append(LoggingCallback())
        engine = FederatedEngine(model, fl, ds, strategy=method,
                                 callbacks=callbacks, device=args.device)
        results[method] = result = engine.run()
        print(f"[{method}] saved {path}; summary:", result.summary())
    return results


if __name__ == "__main__":
    main()
