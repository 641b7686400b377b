"""Small copies of the benchmark's cells for the CPU tests: the real
drivers and metric readers, the real traffic and configuration files
with their sizes cut to what a test run holds."""
import copy
import json
import os
import shutil

from portbench import harness

TINY_MODEL = {
    "charlm-shakespeare": dict(num_layers=2, d_model=32, num_heads=2,
                               num_kv_heads=2, head_dim=16, d_ff=64),
    "phi3.5-moe-l16": dict(num_layers=2, d_model=64, num_heads=4,
                           num_kv_heads=2, head_dim=16, num_experts=4,
                           d_ff_expert=64, group_size=32, vocab_size=256,
                           dtype="float32"),
    "phi3.5-moe-l2": dict(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, head_dim=16, num_experts=4,
                          d_ff_expert=64, group_size=32, vocab_size=256,
                          dtype="float32"),
}
TINY_FL = dict(num_clients=20, clients_per_round=4, k_base=2, s_base=10,
               b_base=4, seq_len=16, eval_batches=2, eval_batch_size=8)
TINY_TRAFFIC = {
    "cafl_c115": {},
    "train_8x4k": dict(rows=4, seq=48, microbatches=4, trace_steps=1),
    "prefill_2k-8k": dict(min_len=40, max_len=100, block=8,
                          trace_requests=4, check_requests=3, late_from=64),
}


def make(tmp, spec=None):
    """A bench directory under ``tmp`` holding every cell of ``spec``
    (default: ``BENCHMARK.json``) at test size -> (spec, bench_dir)."""
    spec = copy.deepcopy(spec or harness.load_spec())
    bench = os.path.join(str(tmp), "portbench")
    for sub in ("drivers", "metrics"):
        shutil.copytree(os.path.join(harness.BENCH_DIR, sub),
                        os.path.join(bench, sub))
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "traffic"))
    for c in spec["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["model"].update(TINY_MODEL[c["name"]])
        if "fl" in cfg:
            cfg["fl"].update(TINY_FL)
        with open(os.path.join(str(tmp), c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in spec["workloads"]:
        with open(os.path.join(harness.BENCH_DIR, "traffic",
                               w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        traffic.update(TINY_TRAFFIC[w["traffic"]])
        with open(os.path.join(bench, "traffic", w["traffic"] + ".json"),
                  "w") as f:
            json.dump(traffic, f)
    return spec, bench


def run(tmp, workload, seed=2 ** 31 + 12345, trace=False, fault=None,
        seconds=0.5):
    spec, bench = make(tmp)
    cell = harness.resolve(spec, workload, bench)
    import time
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            fault=fault, t_start=time.perf_counter())
