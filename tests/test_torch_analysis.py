"""The port's static analysis (``repro_torch.analysis``): the rule
engine over its seeded-violation / clean fixture trees
(``tests/fixtures/analysis_torch``), baseline round trips, CLI exit
codes and JSON, parity with the reference's analyzer
(``repro.analysis``) on the reference's own seeded tree, and the repo's
zero-new-findings policy under ``ANALYSIS_BASELINE_TORCH.json``.

Parity is exact: the shared rules (REPRO002, REPRO003, SCHED001-004 and
JAX004 <-> TORCH004) give equal (rule, line, message, snippet,
occurrence) on the mapped tree, and equal ``Finding`` fields give
bit-equal fingerprints."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.analysis import Finding as JFinding
from repro.analysis import run_analysis as j_run_analysis
from repro_torch.analysis import (Analyzer, Baseline, Finding, rule_ids,
                                  run_analysis)
from repro_torch.analysis.cli import main as cli_main

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "analysis_torch")
SEEDED = os.path.join(FIXTURES, "seeded")
CLEAN = os.path.join(FIXTURES, "clean")
REF_SEEDED = os.path.join(HERE, "fixtures", "analysis", "seeded")
#: the fixture trees' code: the package and a benchmarks directory
#: (REPRO002's scope; the port has no benchmark package of its own)
PATHS = ["src/repro_torch", "benchmarks"]

ALL_RULES = ("TORCH001", "TORCH003", "TORCH004",
             "REPRO001", "REPRO002", "REPRO003",
             "SCHED001", "SCHED002", "SCHED003", "SCHED004")
#: the reference's rule id -> the port's, for the rules both share
SHARED = {"REPRO002": "REPRO002", "REPRO003": "REPRO003",
          "SCHED001": "SCHED001", "SCHED002": "SCHED002",
          "SCHED003": "SCHED003", "SCHED004": "SCHED004",
          "JAX004": "TORCH004"}


@pytest.fixture(scope="module")
def seeded_result():
    return run_analysis(SEEDED, paths=PATHS)


@pytest.fixture(scope="module")
def clean_result():
    return run_analysis(CLEAN, paths=PATHS)


# ---------------------------------------------------------------------------
# rule engine over the fixture trees
# ---------------------------------------------------------------------------


def test_registry_has_all_rules():
    assert set(rule_ids()) == set(ALL_RULES)


def test_every_rule_fires_on_seeded_tree(seeded_result):
    assert set(seeded_result.by_rule()) == set(ALL_RULES)


def test_clean_tree_is_clean(clean_result):
    assert clean_result.findings == []
    assert clean_result.files_scanned >= 9


P = "src/repro_torch/"


@pytest.mark.parametrize("rule,path,needle", [
    ("TORCH001", P + "mod_torch001.py", "'torch.manual_seed(...)' seeds"),
    ("TORCH001", P + "mod_torch001.py", "'torch.randn(...)' draws"),
    ("TORCH001", P + "mod_torch001.py", "'w.uniform_(...)' draws"),
    ("TORCH001", P + "mod_torch001.py", "'torch.randperm(...)' draws"),
    ("TORCH001", P + "mod_torch001.py", "dropout takes no generator"),
    ("TORCH003", P + "mod_torch003.py", "device=cuda)' makes a tensor"),
    ("TORCH003", P + "mod_torch003.py", "'torch.cuda.synchronize(...)'"),
    ("TORCH003", P + "mod_torch003.py", "loads the kernel library"),
    ("TORCH003", P + "mod_torch003.py", "'.cuda()' moves"),
    ("TORCH004", P + "fl/engine.py", "per-client Python loop"),
    ("REPRO001", P + "kernels/cuda_lib.py", "no extern \"C\" definition"),
    ("REPRO001", P + "kernels/cuda_lib.py", "no LAUNCHES counter"),
    ("REPRO001", P + "kernels/cuda_lib.py", "'no_twin' has no plain twin"),
    ("REPRO001", P + "kernels/cuda_lib.py",
     "'no_dispatch' is not dispatched"),
    ("REPRO001", P + "kernels/cuda_lib.py",
     "twin 'twin_undispatched_ref' is not dispatched"),
    ("REPRO001", P + "kernels/cuda_lib.py", "'no_test' has no tests/"),
    ("REPRO002", "benchmarks/bench_bad.py", "no MetricSpec"),
    ("REPRO002", "benchmarks/bench_bad.py", "direction"),
    ("REPRO003", P + "mod_repro003.py", "wire accounting"),
    ("REPRO003", P + "mod_repro003.py", "token_budget"),
    ("SCHED001", P + "fl/aggregator.py", "accumulation inside a loop"),
    ("SCHED001", P + "fl/aggregator.py", "np.mean() folds report buffer"),
    ("SCHED001", P + "fl/aggregator.py", "torch.sum() folds report buffer"),
    ("SCHED001", P + "fl/aggregator.py",
     "stacked.mean() folds report buffer"),
    ("SCHED002", P + "fl/clock.py", "insertion order"),
    ("SCHED002", P + "fl/clock.py", "per-process order"),
    ("SCHED003", P + "fl/clock.py", "bare timestamp '.arrival'"),
    ("SCHED003", P + "fl/clock.py", "bare timestamp '.t'"),
    ("SCHED004", P + "fl/aggregator.py", "module-level RNG"),
    ("SCHED004", P + "fl/aggregator.py", "without a seed"),
    ("SCHED004", P + "fl/aggregator.py", "component state (self.rng)"),
    ("SCHED004", P + "fl/aggregator.py", "component state (self.gen)"),
    ("SCHED004", P + "fl/aggregator.py", "global RNG singleton"),
])
def test_seeded_violation_is_found(seeded_result, rule, path, needle):
    hits = [f for f in seeded_result.findings
            if f.rule == rule and f.path == path and needle in f.message]
    assert hits, (f"{rule} should flag {path} with {needle!r}; got "
                  f"{[f.format() for f in seeded_result.findings]}")


def test_repro001_flags_only_the_broken_kernels(seeded_result):
    """The seeded tree's first kernel keeps its whole contract (an
    extern "C" one-liner, a counter, a twin, a dispatch, a test): no
    finding names it; each other kernel is flagged exactly once."""
    hits = [f.message for f in seeded_result.by_rule()["REPRO001"]]
    assert not [m for m in hits if "good_kernel" in m]
    for kernel in ("no_extern", "no_counter", "no_twin", "no_dispatch",
                   "twin_undispatched", "no_test"):
        assert len([m for m in hits if f"'{kernel}" in m]) == 1, kernel


def test_repro001_reads_the_ports_kernels(tmp_path):
    """On a copy of the port's own kernels, dropping a piece of one
    kernel's contract is found: a LAUNCHES key, the extern "C" entry,
    the tests' references."""
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(REPO, "src", "repro_torch", "kernels"),
                    root / "src" / "repro_torch" / "kernels")
    tests = root / "tests"
    shutil.copytree(HERE, tests, ignore=shutil.ignore_patterns(
        "fixtures", "golden", "__pycache__"))
    rules = [r for r in Analyzer(str(root)).rules if r.id == "REPRO001"]
    assert run_analysis(str(root), rules=rules).findings == []
    lib = root / "src" / "repro_torch" / "kernels" / "cuda_lib.py"
    lib.write_text(lib.read_text().replace('"masked_sum_u64": 0,', ""))
    cu = root / "src" / "repro_torch" / "kernels" / "csrc" / \
        "flash_attention.cu"
    cu.write_text(cu.read_text().replace('extern "C" int flash_attention',
                                         'int flash_attention'))
    for path in tests.glob("test_torch_*.py"):
        path.write_text(path.read_text().replace("dequantize_blocks", "x"))
    msgs = sorted(f.message for f in run_analysis(str(root),
                                                  rules=rules).findings)
    assert msgs == [
        "kernel 'dequantize_blocks' has no tests/test_torch_* test "
        "referencing it or its twin",
        "kernel 'flash_attention_bhsd': no extern \"C\" definition of "
        "'flash_attention_bhsd_launch' in kernels/csrc/*.cu",
        "kernel 'masked_sum_u64' has no LAUNCHES counter in "
        "kernels/cuda_lib.py"]


def test_findings_carry_location_and_hint(seeded_result):
    for f in seeded_result.findings:
        assert f.line >= 1 and f.path and f.hint
        assert f"{f.path}:{f.line}" in f.format()


def test_rule_filtering():
    only = run_analysis(SEEDED, paths=PATHS, rules=[
        r for r in Analyzer(SEEDED).rules if r.id == "TORCH003"])
    assert {f.rule for f in only.findings} == {"TORCH003"}


def test_static_half_imports_no_torch():
    """The engine, the rules, the baseline, the CLI and the sched rules
    import and run without torch (the reference's static half never
    imports jax)."""
    code = (
        "import sys\n"
        "import repro_torch.analysis as a\n"
        "import repro_torch.analysis.cli, repro_torch.analysis.sched\n"
        f"r = a.run_analysis({SEEDED!r}, paths={PATHS!r})\n"
        "assert r.findings\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or\n"
        "             m.startswith('torch.') or m == 'jax')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# baseline round-trip
# ---------------------------------------------------------------------------


def test_baseline_roundtrip(tmp_path, seeded_result):
    path = str(tmp_path / "base.json")
    Baseline.from_findings(seeded_result.findings).save(path)
    base = Baseline.load(path)
    new, suppressed, stale = base.diff(seeded_result.findings)
    assert new == [] and stale == []
    assert len(suppressed) == len(seeded_result.findings)


def test_baseline_flags_new_and_stale(seeded_result):
    findings = list(seeded_result.findings)
    held_out, rest = findings[0], findings[1:]
    base = Baseline.from_findings(rest)
    new, _, _ = base.diff(findings)
    assert [f.fingerprint for f in new] == [held_out.fingerprint]
    extra = Finding(rule="TORCH001", path="src/gone.py", line=1,
                    message="was fixed", hint="", snippet="x = 1")
    _, _, stale = Baseline.from_findings(rest + [extra]).diff(rest)
    assert [e["fingerprint"] for e in stale] == [extra.fingerprint]


def test_fingerprint_survives_line_drift():
    a = Finding(rule="R", path="p.py", line=3, message="m", hint="",
                snippet="x = torch.ones(4)")
    b = Finding(rule="R", path="p.py", line=300, message="m", hint="",
                snippet="x = torch.ones(4)")
    c = Finding(rule="R", path="p.py", line=3, message="m", hint="",
                snippet="y = torch.ones(4)")
    assert a.fingerprint == b.fingerprint != c.fingerprint


@pytest.mark.parametrize("fields", [
    dict(rule="TORCH004", path="src/repro_torch/fl/dynamics.py", line=337,
         message="m", hint="h", snippet="for i in survivor_idx:",
         occurrence=0),
    dict(rule="SCHED001", path="src/x.py", line=1, message="", hint="",
         snippet="total += r.value", occurrence=3),
    dict(rule="REPRO003", path="a/b.py", line=9, message="é", hint="",
         snippet="token_budget = rounds * 0.5  # ünïcode", occurrence=1),
])
def test_fingerprint_equals_the_references(fields):
    """Bit-equal: both packages hash (rule, path, snippet, occurrence)
    the same way."""
    port, ref = Finding(**fields), JFinding(**fields)
    assert port.fingerprint == ref.fingerprint
    assert port.to_json() == ref.to_json()
    assert port.format() == ref.format()


# ---------------------------------------------------------------------------
# parity with the reference's analyzer
# ---------------------------------------------------------------------------


def _mapped_seeded_tree(tmp_path):
    """The reference's seeded tree with ``src/repro/`` -> ``src/repro_torch/``."""
    root = tmp_path / "mapped"
    shutil.copytree(REF_SEEDED, root)
    os.rename(root / "src" / "repro", root / "src" / "repro_torch")
    return str(root)


def _key(f, rule):
    return (rule, f.path.replace("src/repro/", "src/repro_torch/"), f.line,
            f.message, f.snippet, f.occurrence)


def test_shared_rules_match_the_references_on_its_seeded_tree(tmp_path):
    """Both analyzers on the same code (the reference's seeded tree and
    its mapped copy): equal findings rule by rule, bit for bit."""
    ref = j_run_analysis(REF_SEEDED)
    port = run_analysis(_mapped_seeded_tree(tmp_path),
                        paths=["src", "benchmarks", "examples"])
    want = sorted(_key(f, SHARED[f.rule]) for f in ref.findings
                  if f.rule in SHARED)
    got = sorted(_key(f, f.rule) for f in port.findings
                 if f.rule in SHARED.values())
    assert {k[0] for k in want} == set(SHARED.values())
    assert got == want


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_exit_codes(capsys):
    assert cli_main(["--root", SEEDED, *PATHS]) == 1
    assert cli_main(["--root", CLEAN, *PATHS]) == 0
    assert cli_main(["--root", SEEDED, "--rules", "NOPE"]) == 2
    assert cli_main(["--root", SEEDED, "--rules", "JAX002"]) == 2
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr()
    assert "TORCH001" in out.out and "JAX002" in out.err


def test_cli_json_output(capsys):
    assert cli_main(["--root", SEEDED, "--json", *PATHS]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["new"] and not payload["suppressed"]
    assert {f["rule"] for f in payload["new"]} == set(ALL_RULES)
    assert set(payload["rules"]) == set(ALL_RULES)
    assert payload["stale_baseline"] == []


def test_cli_update_baseline_then_clean(tmp_path, capsys):
    root = str(tmp_path / "tree")
    shutil.copytree(SEEDED, root)
    base = os.path.join(root, "base.json")
    assert cli_main(["--root", root, *PATHS]) == 1
    assert cli_main(["--root", root, "--baseline", base,
                     "--update-baseline", *PATHS]) == 0
    assert cli_main(["--root", root, "--baseline", base, *PATHS]) == 0
    assert "suppressed by baseline" in capsys.readouterr().out
    # fixing a violation makes its baseline entry stale -> exit 1
    eng = os.path.join(root, "src", "repro_torch", "fl", "engine.py")
    with open(eng, "w") as f:
        f.write("def aggregate_round(stacked):\n    return stacked.sum(0)\n")
    assert cli_main(["--root", root, "--baseline", base, *PATHS]) == 1
    assert "STALE" in capsys.readouterr().out
    assert cli_main(["--root", root, "--baseline", base,
                     "--update-baseline", *PATHS]) == 0
    assert cli_main(["--root", root, "--baseline", base, *PATHS]) == 0


def test_cli_trace_names_item_14b():
    with pytest.raises(NotImplementedError, match="item 14b"):
        cli_main(["--root", CLEAN, "--trace"])


# ---------------------------------------------------------------------------
# the repo itself: the zero-new-findings policy
# ---------------------------------------------------------------------------


def test_repo_is_clean_under_committed_baseline():
    """CI's analysis gate for the port, as a test: every finding in
    ``src/repro_torch`` is owned by ANALYSIS_BASELINE_TORCH.json."""
    assert os.path.exists(os.path.join(REPO, "ANALYSIS_BASELINE_TORCH.json"))
    assert cli_main(["--root", REPO]) == 0


def test_committed_baseline_owns_only_the_two_dynamics_loops():
    """The port's baseline owns the counterparts of the reference's two
    entries (fl/dynamics.py adjust_knobs and settle) and nothing else."""
    base = Baseline.load(os.path.join(REPO, "ANALYSIS_BASELINE_TORCH.json"))
    owned = sorted((e["rule"], e["path"], e["message"])
                   for e in base.entries.values())
    assert owned == [
        ("TORCH004", "src/repro_torch/fl/dynamics.py",
         "per-client Python loop over 'survivor_idx' in settle()"),
        ("TORCH004", "src/repro_torch/fl/dynamics.py",
         "per-client Python loop over 'zip(sampled, knobs)' in "
         "adjust_knobs()")]


def test_module_entry_point_runs(tmp_path):
    """``python -m repro_torch.analysis --root REPO`` exits 0."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--root", REPO], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "0 new finding(s)" in out.stdout
