"""The controls and planted faults of each cell's correctness check, read
on the card at the cell's own size.

For each seed the reference is computed as the check computes it, then
put in the program's place: in the next precision below the
configuration's (the control: TF32 for the char-LM's fp32, float8 e4m3
products for Phi-3.5-MoE's bf16), and, for the training cells, with half
of each batch left out and the mean taken over the rest (a fault). Each
is judged against the reference by the cell's own comparison (for
Phi-3.5-MoE the judge follows the expert choices of the side it judges,
as the check follows the program's); the lines printed are the
numbers beside the cell's limits. The readings set each limit's upper
end (PERF.md).

    python3 -m portbench.tools.controls --workload <name> --seeds 1 2 3

With ``--program`` (and ``--fault <name>``, a fault planted in the
timed path) it runs the program itself through the harness, one short
window a seed in one process, and prints the same numbers: the lower
readings of each limit, and a planted fault's.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


#: requests a prefill window of ``run_seconds`` serves, about: the
#: control's sample is drawn over as many
WINDOW_BLOCKS = 9


def prefill_sample(drv, t, seed: int):
    """The (index, length) requests a run's ``Sampler`` holds after a
    window of ``WINDOW_BLOCKS`` blocks of requests."""
    plan = drv.lengths(t, seed, WINDOW_BLOCKS * t["block"])
    pick, held = drv.Sampler(t, seed), set()
    for i, length in enumerate(plan):
        out = pick.offer(i, length)
        if out is not False:
            held.discard(out)
            held.add(i)
    return [(i, plan[i]) for i in sorted(held)]


def program(cell, seed: int, seconds: float, device, fault=None):
    """One run of the cell through the harness (a short window), its
    planted ``fault`` in the timed path -> its compared and read
    numbers."""
    from portbench import harness
    res = harness.run_cell(cell, seed, seconds, False, device, fault,
                           t_start=time.perf_counter())
    vals = {k: c["value"] for k, c in res["checks"].items()}
    vals.update(res["read"])
    return {"correct": res["correct"], "attempted": res["attempted"],
            "numbers": vals}


def readings(cell, seed: int, device):
    from portbench import harness
    t = cell.traffic
    drv = harness.load_module(cell.driver_path, "drv_" + t["driver"])
    limits = t["limits"]
    out = {}
    if t["driver"] == "fl_round":
        # the set-up rounds from the seed, then round setup_rounds + 1 as
        # the window's round, from the reference's parameters after the
        # set-up rounds, as the check follows a window round
        m, idx = cell.config["model"], t["setup_rounds"] + 1
        ref = drv.reference_readings(cell.config, t, seed, device)
        start = ref["params"]
        ref = {"setup": ref["setup"], "window": drv.reference_window(
            cell.config, t, seed, device, idx, start)}
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("fault_half_batch", {"half_batch": True})):
            side = drv.reference_readings(cell.config, t, seed, device, **kw)
            side = {"setup": side["setup"], "window": drv.reference_window(
                cell.config, t, seed, device, idx, start, **kw)}
            vals = drv.readings(side, ref, m)
            out[name] = {k: {"value": v, "limit": limits.get(
                k, float("inf"))} for k, v in vals.items()}
    elif t["driver"] == "train_step":
        from portbench.reference import moe_train
        m = cell.config["model"]
        for name, kw in (("control_fp8", {"mode": "fp8"}),
                         ("fault_half_batch", {"half_batch": True})):
            side = moe_train.follow(m, t, seed, device, **kw)
            judge = moe_train.follow(m, t, seed, device,
                                     routes=side["routes"])
            vals = drv.readings(side, judge, m)
            out[name] = {k: {"value": v, "limit": limits.get(
                k, float("inf"))} for k, v in vals.items()}
    elif t["driver"] == "prefill":
        pairs = prefill_sample(drv, t, seed)
        low = drv.reference_outputs(cell.config, seed, pairs, device,
                                    mode="fp8", keep=True)
        ref = drv.reference_outputs(cell.config, seed, pairs, device,
                                    against=low["kv"], routes=low["routes"])
        vals = drv.readings(low["logits"], ref)
        out["control_fp8"] = {k: {"value": v, "limit": limits.get(
            k, float("inf"))} for k, v in vals.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true",
                    help="run the program through the harness instead")
    ap.add_argument("--fault", default=None,
                    help="with --program: the fault planted in its timed "
                         "path (the drivers name theirs)")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="with --program: the window")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench import harness
    harness._environment()
    cell = harness.resolve(harness.load_spec(), args.workload)
    device = harness.card(cell.workload["chips"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.program:
            line = program(cell, seed, args.seconds, device, args.fault)
            line["fault"] = args.fault
        else:
            res = readings(cell, seed, device)
            line = {"readings": {k: {n: c["value"] for n, c in v.items()}
                                 for k, v in res.items()}}
        print(json.dumps(dict({"workload": args.workload, "seed": seed,
                               "seconds": time.perf_counter() - t0},
                              **line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
