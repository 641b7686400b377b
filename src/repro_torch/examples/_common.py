"""What the examples share: the ``--device`` flag, the round budget and
the small federated char-LM setting of the reference's scripts."""
from __future__ import annotations

import argparse
import dataclasses
import os

from repro_torch.configs import get_config, get_fl_config
from repro_torch.data import load_corpus
from repro_torch.device import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def parse(ap: argparse.ArgumentParser, argv=None):
    """-> (args, the resolved device)."""
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)


def rounds(default: int) -> int:
    """``REPRO_EXAMPLE_ROUNDS`` (the reference's CI budget) or ``default``."""
    return int(os.environ.get("REPRO_EXAMPLE_ROUNDS", str(default)))


def small_fleet(rounds: int, clients_per_round: int):
    """-> (corpus, config, FL config): the reference examples' 3-layer
    char-LM (d 96) over 8 clients."""
    ds = load_corpus(target_bytes=120_000)
    cfg = get_config("charlm-shakespeare").replace(
        vocab_size=max(ds.vocab_size, 64), num_layers=3, d_model=96,
        num_heads=4, num_kv_heads=4, head_dim=24, d_ff=192)
    fl = get_fl_config().replace(
        rounds=rounds, num_clients=8, clients_per_round=clients_per_round,
        s_base=10, b_base=16, seq_len=32, eval_batches=2,
        eval_batch_size=32)
    fl = fl.replace(duals=dataclasses.replace(fl.duals, s_min=4, b_min=4))
    return ds, cfg, fl
