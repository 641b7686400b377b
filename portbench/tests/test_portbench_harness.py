"""The harness on the CPU: every cell of ``BENCHMARK.json`` resolves by
name to its configuration, traffic, driver and metric readers; a cell
and a metric are added as new files alone; names, units and counts keep
to the limits of the benchmark's format; the command fails without
a card."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import tiny

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.resolve(SPEC, workload)
    assert os.path.exists(cell.driver_path)
    assert cell.traffic["limits"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names
        assert os.path.exists(harness.metric_path(m["name"]))
        mod = harness.load_module(harness.metric_path(m["name"]), "m")
        assert callable(mod.read)
        assert mod.read({"spans": {}, "counters": {}, "counts": {},
                         "trace": None, "memory_peak_bytes": 0}) is None


def test_names_units_and_counts_keep_to_the_format():
    s = SPEC
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(s["paths"]) <= 16 and all(PATH.match(p)
                                              for p in s["paths"])
    assert len(s["command"]) <= 32 and "portbench/run.py" in s["command"]
    assert 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits its allowance
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in s["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/")
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c[
            "source"]
    cells = [w["name"] for w in s["workloads"]]
    assert len(cells) == len(set(cells)) and 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(cells)
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(cells) // 4)
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    metrics = s["end_to_end"] + s["per_layer"]
    mnames = [m["name"] for m in metrics]
    assert len(mnames) == len(set(mnames))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "workloads" in m:
            assert set(m["workloads"]) <= set(cells)
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])
    for m in s["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}
    assert len(json.dumps(s)) <= 64 * 1024


def test_a_cell_and_a_metric_are_added_as_files_alone(tmp_path):
    """A new traffic mix (a data file), a new cell in the spec and a new
    per-layer metric (a reader of its own): the harness runs the cell
    and reports the metric, with no file of the harness edited."""
    spec, bench = tiny.make(tmp_path)
    with open(os.path.join(bench, "traffic", "prefill_2k-8k.json")) as f:
        traffic = json.load(f)
    traffic.update(min_len=20, max_len=30, block=4)
    with open(os.path.join(bench, "traffic", "prefill_short.json"),
              "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench, "metrics", "requests_served_prefill.py"),
              "w") as f:
        f.write("def read(rec):\n    return rec['counters'].get("
                "'requests')\n")
    spec["workloads"].append({"name": "phi35moe.prefill.short",
                              "config": "phi3.5-moe-l16",
                              "traffic": "prefill_short", "chips": 1,
                              "why": "short prompts"})
    for m in spec["end_to_end"]:
        if m["name"] in ("prefill_tokens_per_s", "ttft_ms.p90"):
            m["workloads"].append("phi35moe.prefill.short")
    spec["per_layer"].append({"name": "requests_served.prefill",
                              "unit": "requests", "better": "higher",
                              "source": "program_counter",
                              "layer": "prefill step",
                              "moves": "prefill_tokens_per_s",
                              "workloads": ["phi35moe.prefill.short"]})
    cell = harness.resolve(spec, "phi35moe.prefill.short", bench)
    import time
    res = harness.run_cell(cell, 77, 0.3, True, device="cpu",
                           t_start=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["requests_served.prefill"]["value"] >= 1
    res = harness.run_cell(cell, 78, 0.3, False, device="cpu",
                           t_start=time.perf_counter())
    assert set(res["metrics"]) == {"prefill_tokens_per_s", "ttft_ms.p90",
                                   "setup_s"}


def test_prefill_lengths_are_the_same_set_for_every_seed():
    cell = harness.resolve(SPEC, "phi35moe.prefill.2k-8k")
    drv = harness.load_module(cell.driver_path, "prefill")
    t = cell.traffic
    a = drv.lengths(t, 1, t["block"] * 3)
    b = drv.lengths(t, 2 ** 31 + 99, t["block"] * 3)
    assert a != b and sorted(a) == sorted(b)
    assert min(a) >= t["min_len"] and max(a) <= t["max_len"]


def test_command_fails_without_a_card(tmp_path):
    """From a copy holding only BENCHMARK.json and the benchmark's files
    (no program), and from the checkout on a machine without CUDA, the
    command exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    args = [sys.executable, "portbench/run.py", "--workload",
            "charlm.cafl.c115", "--seed", str(2 ** 31 + 5), "--seconds",
            "1", "--trace", "0"]
    for cwd in (harness.ROOT, str(tmp_path)):
        out = subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"correct"' not in out.stdout


#: a published (Hugging Face) key of a configuration file -> the key of
#: its ``model`` section that the drivers and the reference read
PUBLISHED = {"hidden_size": "d_model", "intermediate_size": "d_ff_expert",
             "num_attention_heads": "num_heads",
             "num_key_value_heads": "num_kv_heads",
             "num_hidden_layers": "num_layers",
             "num_local_experts": "num_experts",
             "num_experts_per_tok": "top_k", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "torch_dtype": "dtype",
             "tie_word_embeddings": "tie_embeddings"}


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_the_run_sizes_are_the_published_ones(config):
    """Where a configuration file holds the published keys, the ``model``
    section that is run holds the same numbers under its own names (and
    the head width is the published hidden size over the heads)."""
    entry = {c["name"]: c for c in SPEC["configs"]}[config]
    with open(os.path.join(harness.ROOT, entry["file"])) as f:
        cfg = json.load(f)
    published = {k: v for k, v in cfg.items() if k in PUBLISHED}
    for key, value in published.items():
        assert cfg["model"][PUBLISHED[key]] == value, key
    if "hidden_size" in published:
        assert (cfg["model"]["head_dim"] * cfg["num_attention_heads"]
                == cfg["hidden_size"])
    assert set(cfg["reduced"]) <= set(cfg.get("assumed", {})) | set(
        cfg["model"]) | set(cfg.get("fl", {}))
