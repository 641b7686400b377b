"""Package-level contracts of the port: it imports neither JAX nor the JAX
package, its entry points default to the card and raise without one
(nothing falls back to the CPU), ``chip_smoke.py`` refuses to run
without a card or without the rest of the repository, and the card tools
point one way: ``chip_smoke.py`` checks and times nothing, the scripts
take no timing from it."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("quickstart", "federated_train", "heterogeneous_fleet",
            "unreliable_fleet", "async_fleet", "constraint_controllers",
            "constraint_sweep", "serve")
SRC = os.path.join(REPO, "src")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_port_imports_no_jax_and_no_reference():
    """Import every repro_torch module (and chip_smoke, the profile script,
    the A/B script and the xLSTM drift script) in a fresh interpreter;
    neither jax nor any repro module may be loaded."""
    import repro_torch
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.core.client" in names and len(names) >= 25
    for sub in ("fl.engine", "constraints.knobs", "checkpointing.checkpoint",
                "launch.train", "models.rglru", "models.ssm",
                "models.encdec", "configs.recurrentgemma_2b",
                "configs.xlstm_1_3b", "configs.seamless_m4t_medium",
                "launch.specs", "launch.mesh", "launch.dryrun",
                "analysis.engine", "analysis.rules_torch",
                "analysis.sched.permute", "analysis.sched.gate",
                "analysis.runtime", "analysis.cli", "analysis.trace.cost",
                "analysis.trace.registry", "analysis.trace.rules",
                "analysis.trace.gate", "kernels.stand_ins",
                *(f"examples.{name}" for name in EXAMPLES)):
        assert f"repro_torch.{sub}" in names
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'scripts')!r}]\n"
        f"for name in {names!r} + ['chip_smoke', 'profile_port', "
        "'wire_ab', 'xlstm_bf16_drift']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib', 'msgpack')) or\n"
        "             m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    from repro_torch.configs.charlm_shakespeare import FL, SMOKE
    from repro_torch.core import ClientRunner, calibrate, make_eval_fn
    from repro_torch.data import FederatedData, load_corpus
    from repro_torch.fl import FederatedEngine
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build, params_from_numpy

    model = build(SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    ds = load_corpus(target_bytes=20_000)
    data = FederatedData(ds.train, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        ClientRunner(model, FL, data, calibrate(1000, FL))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_fn(model, ds, FL)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"io": {"embed": np.zeros((4, 2), np.float32)}})
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.quantize_dequantize(np.zeros(300, np.float32), bits=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        FederatedEngine(model, FL, ds)
    # MaskedSumAggregator's fold
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.masked_sum_u64(np.zeros((2, 3), np.uint64))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--rounds", "1", "--quiet",
                    "--out", str(tmp_path / "fl")])
    # the examples, before any work
    import importlib
    for name in EXAMPLES:
        example = importlib.import_module(f"repro_torch.examples.{name}")
        with pytest.raises(RuntimeError, match="CUDA"):
            example.main([])
    # an explicit CPU request runs
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert next(iter(params.params().values())).device.type == "cpu"


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the port beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _ast(*path):
    with open(os.path.join(REPO, *path)) as f:
        return ast.parse(f.read())


def _times(node) -> list:
    """What in ``node`` times: a CUDA event made with a timing argument,
    torch.profiler, any use of the ``time`` module's clocks, an
    nvidia-smi clock or power query."""
    found = []
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr == "Event" and (n.args or any(
                    k.arg in ("enable_timing", None) for k in n.keywords)):
                found.append("torch.cuda.Event(<timing>)")
            if n.func.attr == "elapsed_time":
                found.append(n.func.attr)
        if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id == "time"):
            found.append(f"time.{n.attr}")
        if isinstance(n, ast.ImportFrom) and n.module and (
                "profiler" in n.module or n.module == "time"):
            found.append(f"from {n.module} import")
        if isinstance(n, ast.Import) and any(
                "profiler" in a.name or (a.name == "time" and a.asname)
                for a in n.names):
            found.append("import profiler or time as")
        if isinstance(n, ast.Attribute) and n.attr == "profiler":
            found.append("torch.profiler")
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and (
                "clocks.sm" in n.value or "power.draw" in n.value):
            found.append(n.value)
    return found


@pytest.mark.parametrize("rule", ["chip_smoke_imports_no_script",
                                  "chip_smoke_does_not_time",
                                  "scripts_take_no_timing_from_chip_smoke"])
def test_card_tools_point_one_way(rule):
    """``chip_smoke.py`` checks, ``scripts/profile_port.py`` times a kernel
    alone, ``portbench/`` measures the system: the checker imports none
    of the scripts and times nothing (its one ``total`` line aside, a host
    clock in ``main``), and neither timing script imports from it a
    function that times."""
    smoke = _ast("chip_smoke.py")
    defs = {n.name: n for n in smoke.body if isinstance(n, ast.FunctionDef)}
    if rule == "chip_smoke_imports_no_script":
        scripts = {name[:-3] for name in os.listdir(os.path.join(REPO,
                                                                 "scripts"))
                   if name.endswith(".py")}
        assert {"profile_port", "wire_ab"} <= scripts
        imported = [a.name.split(".")[0] for n in ast.walk(smoke)
                    if isinstance(n, ast.Import) for a in n.names]
        imported += [n.module.split(".")[0] for n in ast.walk(smoke)
                     if isinstance(n, ast.ImportFrom) and n.module]
        assert not scripts & set(imported), scripts & set(imported)
        assert not any(isinstance(n, ast.Constant) and n.value == "scripts"
                       for n in ast.walk(smoke))
    elif rule == "chip_smoke_does_not_time":
        timed = {name: _times(node) for name, node in defs.items()
                 if name != "main" and _times(node)}
        assert not timed, timed
        # main's one host clock: the run's total seconds
        assert _times(defs["main"]) == ["time.perf_counter"] * 2
        rest = [n for n in smoke.body if not isinstance(n, ast.FunctionDef)]
        assert not [t for n in rest for t in _times(n)]
    else:
        for script in ("profile_port.py", "wire_ab.py"):
            tree = _ast("scripts", script)
            names = [a.name for n in ast.walk(tree)
                     if isinstance(n, ast.ImportFrom)
                     and n.module == "chip_smoke" for a in n.names]
            assert names, f"{script} imports nothing from chip_smoke"
            timing = {name: _times(defs[name]) for name in names
                      if name in defs and _times(defs[name])}
            assert not timing, (script, timing)
