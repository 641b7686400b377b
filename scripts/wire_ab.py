#!/usr/bin/env python3
"""Times the redesigned wire kernels of one checkout's port on one CUDA
card, so that two checkouts can be compared on one card and host.

    python3 scripts/wire_ab.py [--root DIR] [--label NAME]

``repro_torch`` comes from ``DIR/src`` (default: this checkout); the
timing helpers are this checkout's (``chip_smoke.py``,
``profile_port.py``), so both checkouts are timed the same way. At the
main path's shapes:

- ``quantize_blocks`` and ``quantize_topk_blocks`` (k 64) per client
  delta (7,428 blocks of 256, bits 2) and ``dequantize_blocks`` (a
  control where the two checkouts share the kernel);
- the masked fold (6 clients x 1,900,800 uint64): the limb entry
  (``wire.masked_sum_limbs``), the uint64 entry (``wire.masked_sum_u64``)
  where the checkout has one, ``torch.sum`` over int64, and
  ``ops.masked_sum_u64`` (the aggregator's flush path, NumPy in and out);
- three full-width masked rounds' host work (``chip_smoke``'s
  ``masked_round_host``: 6 ``submit`` calls and the ``flush``).

Each kernel's CUDA-event ms of one call (all timed in turns with
``time_turns_ms``), its wrapper's host us a call (``host_us``; 100 calls
for the folds), and its device us under torch.profiler; the whole
``ops.masked_sum_u64`` on the host clock (median of 5). Prints one JSON
line. To compare two checkouts, run it in turns in one call: A, B, B, A.
Needs one card and the CUDA toolkit; imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (BLOCK, SUM_TIMED, delta_like,  # noqa: E402
                        full_width, host_us, masked_round_host,
                        nvidia_smi_line, time_turns_ms)
from profile_port import kernel_device_us  # noqa: E402

#: blocks of one full-width char-LM delta (1,900,800 values, per-leaf
#: padding included)
DELTA_BLOCKS = 7428


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
    from repro_torch.kernels import ops, quantize, wire
    src = os.path.dirname(os.path.dirname(os.path.abspath(ops.__file__)))
    dev = torch.device("cuda")

    buf = delta_like(torch.Generator().manual_seed(2),
                     (DELTA_BLOCKS, BLOCK)).to(dev)
    codes, scales = quantize.quantize_blocks(buf, 2)
    out = torch.empty_like(buf)
    c, n = SUM_TIMED
    vals = np.random.default_rng(12).integers(0, 2 ** 64, size=(c, n),
                                              dtype=np.uint64)
    hi, lo = (torch.from_numpy(x).to(dev) for x in ops.split_limbs(vals))
    stacked = torch.from_numpy(vals.view(np.int64)).to(dev)
    calls = {
        "quantize_blocks": (lambda: quantize.quantize_blocks(buf, 2), 1000),
        "quantize_topk_blocks": (lambda: wire.quantize_topk_blocks(buf, 2, 64),
                                 1000),
        "dequantize_blocks": (lambda: quantize.dequantize_blocks(
            codes, scales, out=out), 1000),
        "masked_sum_limbs": (lambda: wire.masked_sum_limbs(hi, lo), 100),
        "torch.sum int64": (lambda: torch.sum(stacked, dim=0), 100)}
    if hasattr(wire, "masked_sum_u64"):
        calls["masked_sum_u64"] = (lambda: wire.masked_sum_u64(stacked), 100)
    names = list(calls)
    ms = time_turns_ms(*(calls[k][0] for k in names))
    device_names = {"quantize_blocks": "quantize_blocks",
                    "quantize_topk_blocks": "quantize_topk_blocks",
                    "dequantize_blocks": "dequantize_blocks",
                    "masked_sum_limbs": "masked_sum_limbs",
                    "masked_sum_u64": "masked_sum_u64",
                    "torch.sum int64": "reduce_kernel"}
    rows = {}
    for k, t in zip(names, ms):
        fn, n_calls = calls[k]
        rows[k] = {"ms": t, "host_us": host_us(fn, calls=n_calls),
                   "device_us": kernel_device_us(fn, device_names[k])}
    total = ops.masked_sum_u64(vals, device=dev)
    if not np.array_equal(total, np.add.reduce(vals, axis=0)):
        raise RuntimeError("ops.masked_sum_u64 differs from np.add.reduce")
    fold_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.masked_sum_u64(vals, device=dev)
        fold_s.append(time.perf_counter() - t0)
    model = full_width(dev)[3]
    rounds = [masked_round_host(dev, model) for _ in range(3)]
    print(json.dumps({"phase": "wire_ab", "label": args.label, "port": src,
                      "nvidia_smi": nvidia_smi_line(), "kernels": rows,
                      "ops_masked_sum_u64_s": statistics.median(fold_s),
                      "ops_masked_sum_u64_all_s": fold_s,
                      "masked_flush_s": [r["flush_s"] for r in rounds],
                      "masked_submit_s": [sum(r["submit_s"])
                                          for r in rounds]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
