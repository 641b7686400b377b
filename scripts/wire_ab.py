#!/usr/bin/env python3
"""Times the wire kernels of one checkout's port on one CUDA card, so
that two checkouts can be compared on one card and host.

    python3 scripts/wire_ab.py [--root DIR] [--label NAME]

``repro_torch`` comes from ``DIR/src`` (default: this checkout); the
timing is this checkout's ``profile_port.py``, so both checkouts are
timed by the same functions that give PERF.md §6's columns:

- ``profile_port.wire_records``: ``quantize_blocks``,
  ``dequantize_blocks`` and ``quantize_topk_blocks`` per client delta of
  the full-width char-LM;
- ``profile_port.masked_sum_records``: both masked-sum entries at one
  full-width round's fold;
- ``profile_port.masked_round_host``: three full-width masked rounds'
  host work (6 ``submit`` calls and the ``flush``).

Prints those lines, each with ``label`` and ``port`` (the package timed)
added. To compare two checkouts, run it in turns in one call: A, B, B, A.
Needs one card and the CUDA toolkit; imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

from chip_smoke import emit, full_width, nvidia_smi_line  # noqa: E402
from profile_port import (masked_round_host,  # noqa: E402
                          masked_sum_records, wire_records)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wire_ab: no CUDA device", file=sys.stderr)
        return 2
    # this checkout's helpers are imported; the port comes from --root
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import ops
    src = os.path.dirname(os.path.dirname(os.path.abspath(ops.__file__)))
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    tag = {"label": args.label, "port": src}
    emit({"phase": "device", "nvidia_smi": nvidia_smi_line(), "name": name,
          **tag})
    model, leaves = full_width(dev)[3:]
    for row in wire_records(leaves, name) + masked_sum_records(dev, name):
        emit({**row, **tag})
    for _ in range(3):
        emit({**masked_round_host(dev, model), **tag})
    return 0


if __name__ == "__main__":
    sys.exit(main())
