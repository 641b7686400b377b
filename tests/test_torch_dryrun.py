"""The port's dry-run (``repro_torch.launch.dryrun``) and its specs and
mesh (``launch.specs``, ``launch.mesh``), against the reference's
``repro.launch.dryrun`` / ``specs``.

- Every arch x shape at SMOKE size and the SMOKE shapes of
  ``tests/test_system.py`` (train 8 x 128, prefill 8 x 256, decode 8 over
  256, long 1 over 2,048) gives an ``ok`` record with the reference's
  keys, and ``benchmarks.roofline`` reads the records unchanged.
- ``model_flops`` equals the reference's for every full arch x shape and
  for the SMOKE cells below.
- ``dot_flops`` against the reference's HLO ``dot_flops`` at SMOKE size,
  for ``gemma2-9b x train_4k`` (forward, the per-unit recompute and the
  backward; equal to the FLOP) and ``xlstm-1.3b x long_500k`` (one decode
  step; 0.19% apart: the reference's HLO has a few more small products
  than the port's aten ops). The tolerance is 1%; no gap is near 5%.
  The reference runs in a subprocess with one placeholder device and a
  (1, 1) mesh (``REPRO_MESH_OVERRIDE``), as ``tests/test_system.py`` runs
  it: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``, so the
  pytest worker never does.
- A full-width record allocates nothing: it is traced in a subprocess
  held to 8 GiB of address space (Gemma2's 9.2 B parameters alone are
  18.5 GB).
- The input and cache stand-ins have the reference's shapes and dtypes.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_tiny  # noqa: E402,F401  (one torch thread per worker)
from torch_tiny import flat_paths  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 get_config, get_smoke_config)
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.kernels import stand_ins  # noqa: E402
from repro_torch.launch import dryrun, mesh, specs  # noqa: E402
from repro_torch.models import build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SMOKE_SHAPES = {"train_4k": InputShape("train_4k", 128, 8, "train"),
                "prefill_32k": InputShape("prefill_32k", 256, 8, "prefill"),
                "decode_32k": InputShape("decode_32k", 256, 8, "decode"),
                "long_500k": InputShape("long_500k", 2048, 1, "decode")}
HLO_CELLS = [("gemma2-9b", "train_4k"), ("xlstm-1.3b", "long_500k")]
DOT_RTOL = 1e-2
KEYS = {"status": None, "n_chips": None,
        "memory": ("argument_size_in_bytes", "temp_size_in_bytes",
                   "per_device_total_gb", "fits_h100_80gb"),
        "cost": ("flops", "dot_flops", "bytes"),
        "collectives": ("total_bytes_per_device",),
        "roofline": ("hlo_flops_per_device", "hlo_flops_with_elementwise",
                     "hlo_bytes_per_device", "t_compute_s", "t_memory_s",
                     "t_collective_s", "dominant", "model_flops_total",
                     "model_flops_per_device", "useful_flops_ratio")}

_REFERENCE = """
import json, sys
import repro.launch.dryrun as d
import repro.configs.registry as reg
from repro.configs.base import INPUT_SHAPES, InputShape
full = {a: {s: d.model_flops(reg.get_config(a), INPUT_SHAPES[s])
            for s in INPUT_SHAPES} for a in reg.ARCH_IDS}
d.get_config = reg.get_smoke_config
INPUT_SHAPES['train_4k'] = InputShape('train_4k', 128, 8, 'train')
INPUT_SHAPES['decode_32k'] = InputShape('decode_32k', 256, 8, 'decode')
INPUT_SHAPES['prefill_32k'] = InputShape('prefill_32k', 256, 8, 'prefill')
INPUT_SHAPES['long_500k'] = InputShape('long_500k', 2048, 1, 'decode')
cells = {}
for arch, shape in %r:
    rec = d.run_one(arch, shape, False, out_dir=sys.argv[1], force=True)
    assert rec['status'] == 'ok', rec.get('error', '')[-2000:]
    cells[arch + ' ' + shape] = {'cost': rec['cost'],
                                 'roofline': rec['roofline']}
print(json.dumps({'full': full, 'cells': cells}))
""" % (HLO_CELLS,)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's model_flops of every full cell, and its dry-run
    records of the HLO cells at SMOKE size."""
    env = dict(os.environ, PYTHONPATH=SRC, DRYRUN_DEVICES="1",
               REPRO_MESH_OVERRIDE="1,1", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE,
         str(tmp_path_factory.mktemp("jdry"))],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def records_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("results")


def smoke_record(records_dir, arch, shape):
    return dryrun.run_one(get_smoke_config(arch), SMOKE_SHAPES[shape],
                          out_dir=str(records_dir / "dryrun"))


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_record(records_dir, arch, shape):
    rec = smoke_record(records_dir, arch, shape)
    assert rec["status"] == "ok", rec.get("error")
    for key, sub in KEYS.items():
        assert key in rec, key
        for name in sub or ():
            assert name in rec[key], (key, name)
    assert rec["n_chips"] == 1 and rec["mesh"] == "h100"
    assert rec["collectives"]["total_bytes_per_device"] == 0
    r, c, m = rec["roofline"], rec["cost"], rec["memory"]
    assert 0 < c["dot_flops"] <= c["flops"] and c["bytes"] > 0
    assert r["t_compute_s"] == pytest.approx(c["dot_flops"]
                                             / mesh.PEAK_FLOPS_BF16)
    assert r["t_memory_s"] == pytest.approx(c["bytes"] / mesh.HBM_BW)
    assert r["dominant"] in ("compute", "memory")
    # the arguments are the parameters (+ AdamW's two fp32 moments and
    # the batch, or the caches); the peak holds them
    params = sum(t.numel() * t.element_size() for t in build(
        get_smoke_config(arch)).init(None, "meta").params().values())
    assert m["argument_size_in_bytes"] >= params
    assert m["per_device_total_gb"] * 1e9 >= m["argument_size_in_bytes"]
    assert r["model_flops_total"] == dryrun.model_flops(
        get_smoke_config(arch), SMOKE_SHAPES[shape])


def test_roofline_reads_the_records(records_dir):
    for arch in ARCH_IDS:
        for shape in SMOKE_SHAPES:
            smoke_record(records_dir, arch, shape)
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{SRC}",
               RESULTS_DIR=str(records_dir))
    out = subprocess.run([sys.executable, "-m", "benchmarks.roofline"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    n = len(ARCH_IDS) * len(SMOKE_SHAPES)
    assert lines[-1].endswith(f"{n} ok, 0 errors"), lines[-1]
    assert sum("__h100," in line and "dom=" in line for line in lines) == n


def test_model_flops_equal_the_reference(reference):
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            assert dryrun.model_flops(get_config(arch), INPUT_SHAPES[shape]) \
                == reference["full"][arch][shape], (arch, shape)


@pytest.mark.parametrize("arch,shape", HLO_CELLS)
def test_dot_flops_against_the_reference_hlo(reference, tmp_path, arch,
                                             shape):
    rec = dryrun.run_one(get_smoke_config(arch), SMOKE_SHAPES[shape],
                         out_dir=str(tmp_path))
    want = reference["cells"][f"{arch} {shape}"]
    assert rec["roofline"]["model_flops_total"] == \
        want["roofline"]["model_flops_total"]
    assert rec["cost"]["dot_flops"] == pytest.approx(
        want["cost"]["dot_flops"], rel=DOT_RTOL)


def test_full_width_record_allocates_nothing(tmp_path):
    code = (
        "import resource, sys\n"
        "resource.setrlimit(resource.RLIMIT_AS, (8 << 30, 8 << 30))\n"
        "from repro_torch.launch import dryrun\n"
        "rec = dryrun.run_one('gemma2-9b', 'prefill_32k',\n"
        "                     out_dir=sys.argv[1])\n"
        "assert rec['status'] == 'ok', rec.get('error')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    with open(tmp_path / "gemma2-9b__prefill_32k__h100.json") as f:
        rec = json.load(f)
    # 42 layers of B 32 x 32,768 tokens: the record describes far more
    # than the process could have held
    assert rec["memory"]["argument_size_in_bytes"] == 2 * build(
        get_config("gemma2-9b")).param_count()["total"] + 32 * 32768 * 4
    assert rec["memory"]["per_device_total_gb"] > 100
    assert not rec["memory"]["fits_h100_80gb"]


def test_full_width_mesh_records_allocate_nothing(tmp_path):
    """Gemma2-9B at full width, each input shape on rank 0 of both
    production meshes (256 and 512 cards), traced in a subprocess held
    to 8 GiB of address space: every record ok, a rank's arguments its
    share of the parameters (and the state, batch or caches), its
    products its share of the model's (at most a few times the model
    FLOPs a device needs: recompute, attention), collectives priced."""
    code = (
        "import resource, sys\n"
        "resource.setrlimit(resource.RLIMIT_AS, (8 << 30, 8 << 30))\n"
        "from repro_torch.launch import dryrun\n"
        "for mesh in ('single', 'multi'):\n"
        "    for shape in ('train_4k', 'prefill_32k', 'decode_32k',\n"
        "                  'long_500k'):\n"
        "        rec = dryrun.run_one('gemma2-9b', shape, mesh=mesh,\n"
        "                             out_dir=sys.argv[1])\n"
        "        assert rec['status'] == 'ok', rec.get('error')\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("REPRO_MESH_OVERRIDE", None)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    n_params = build(get_config("gemma2-9b")).param_count()["total"]
    for name, n in (("h100x256", 256), ("h100x512", 512)):
        for shape in INPUT_SHAPES:
            with open(tmp_path / f"gemma2-9b__{shape}__{name}.json") as f:
                rec = json.load(f)
            m, r = rec["memory"], rec["roofline"]
            assert rec["n_chips"] == n and rec["layers"] == 42
            assert m["argument_size_in_bytes"] >= 2 * n_params / n
            assert m["per_device_total_gb"] * 1e9 < 80e9, (name, shape)
            assert r["collective_bytes_per_device"] > 0
            assert r["t_collective_s"] == pytest.approx(
                r["collective_bytes_per_device"] / mesh.COLLECTIVE_BW)
            if INPUT_SHAPES[shape].kind != "decode":
                assert 1.0 < r["hlo_flops_per_device"] \
                    / r["model_flops_per_device"] < 3.0, (name, shape)


def test_flash_pairs():
    """The flash stand-in's work: the pairs a causal, windowed or full
    mask admits (top-left aligned, as the kernel)."""
    assert stand_ins.attended_pairs(4, 4, True, None) == 10
    assert stand_ins.attended_pairs(6, 6, True, 2) == 1 + 2 * 5
    assert stand_ins.attended_pairs(3, 5, False, None) == 15
    assert stand_ins.attended_pairs(1, 4096, False, None) == 4096
    assert stand_ins.attended_pairs(8, 3, True, None) == 1 + 2 + 3 * 6


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_the_reference(arch, shape):
    """Batch stand-ins (encoder-decoder split, 4,096 decode frames,
    vision patches) and decode caches: paths, shapes and dtypes."""
    cfg, jcfg, s = get_config(arch), j_get_config(arch), INPUT_SHAPES[shape]
    from repro.configs.base import INPUT_SHAPES as J_SHAPES
    got, want = specs.input_specs(cfg, s), JS.input_specs(jcfg,
                                                          J_SHAPES[shape])
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype), name
    if s.kind != "decode":
        return
    got = flat_paths(specs.cache_specs(build(cfg), cfg, s))
    want = flat_paths(JS.cache_specs(jbuild(jcfg), jcfg, J_SHAPES[shape]))
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].device.type == "meta", name
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype).split(".")[-1] == str(np.dtype(w.dtype)), \
            name


def test_mesh(monkeypatch, tmp_path):
    """The production meshes are ported: ``make_mesh`` builds them (over a
    fake group, gone after ``use_mesh``), the override resizes them, the
    cluster's rates are the datasheet's, and ``dryrun --mesh`` writes
    their records."""
    import torch.distributed as dist
    monkeypatch.delenv("REPRO_MESH_OVERRIDE", raising=False)
    assert mesh.make_mesh() == mesh.make_mesh("card") == 1
    assert (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW) == (989e12, 3.35e12)
    assert (mesh.NVLINK_BW, mesh.IB_BW) == (450e9, 50e9)
    assert mesh.COLLECTIVE_BW == mesh.IB_BW
    for name, shape, axes in (("single", (16, 16), ("data", "model")),
                              ("multi", (2, 16, 16),
                               ("pod", "data", "model"))):
        with mesh.use_mesh(name, "cpu") as m:
            assert tuple(m.shape) == shape
            assert tuple(m.mesh_dim_names) == axes
        assert not dist.is_initialized()
        assert dryrun.mesh_name(name) == f"h100x{np.prod(shape)}"
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "2,4")
    assert mesh.mesh_layout("multi") == ((2, 4), ("data", "model"))
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "decode_32k",
                        SMOKE_SHAPES["decode_32k"])
    dryrun.main(["--arch", "gemma2-9b", "--shape", "decode_32k", "--mesh",
                 "both", "--recipe", "tp_serve", "--out", str(tmp_path)])
    with open(tmp_path / "gemma2-9b__decode_32k__h100x8__tp_serve.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok" and rec["recipe"] == "tp_serve"
    assert rec["n_chips"] == 8
    with pytest.raises(ValueError):
        mesh.make_mesh("pod")
