"""The port's dry-run on a mesh (``repro_torch.launch.dryrun --mesh``) at
SMOKE size, against the reference's (``repro.launch.dryrun``).

- Every arch x input shape at SMOKE size (the shapes of
  ``tests/test_system.py``) under ``REPRO_MESH_OVERRIDE`` "2,4" (the
  single mesh's axes, data 2 x model 4) and "2,2,2" (the multi mesh's,
  pod 2 x data 2 x model 2) gives an ``ok`` record of rank 0 of 8 cards:
  collective bytes above 0 (every recipe splits some parameter, so every
  step gathers), the collective roofline term at the cluster's rate,
  the arguments a rank holds below the one card's, and its dot FLOPs
  between an 8th of the one card's and the card's (a count of DTensor
  ops at their global shapes, not of the rank's local ops, reaches the
  card's).
- For the reference's two HLO cells (``gemma2-9b`` x ``train_4k`` and
  ``xlstm-1.3b`` x ``long_500k``) at (2, 4), the reference run as
  ``tests/test_system.py`` runs it (a subprocess, 8 placeholder
  devices): the argument bytes a device holds are equal; the dot FLOPs
  of rank 0 are held to its share of the port's one-card record
  (``HLO_SHARE``); the dot FLOPs and the collective bytes per type are
  printed beside the reference's with their ratios, not held. GSPMD
  and DTensor place the work differently; under the installed JAX the
  reference's ``shard_batch`` is a no-op (its
  ``with_sharding_constraint`` raises on the mesh's explicit axes and
  the exception is swallowed), so its Gemma2 step runs 92% of the
  unsharded step's products on every device (ROADMAP queue 3 has the
  ratios).
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_tiny  # noqa: E402,F401  (one torch thread per worker)

from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.launch import dryrun, mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
SMOKE_SHAPES = {"train_4k": InputShape("train_4k", 128, 8, "train"),
                "prefill_32k": InputShape("prefill_32k", 256, 8, "prefill"),
                "decode_32k": InputShape("decode_32k", 256, 8, "decode"),
                "long_500k": InputShape("long_500k", 2048, 1, "decode")}
OVERRIDES = {"single": "2,4", "multi": "2,2,2"}
HLO_CELLS = [("gemma2-9b", "train_4k"), ("xlstm-1.3b", "long_500k")]
#: rank 0's dot FLOPs at (2, 4) over the one card's: (its share, the
#: most above it). Gemma2's train batch of 8 splits over data and every
#: product's columns or rows over model: an 8th, within the 5% asked of
#: the reference. xLSTM's long_500k decodes a batch of 1, which cannot
#: split over data: a 4th, and up to 15% more for the products whose
#: weight is split 2 ways only (rows over data; 1.115 at this size).
HLO_SHARE = {("gemma2-9b", "train_4k"): (1 / 8, 1.05),
             ("xlstm-1.3b", "long_500k"): (1 / 4, 1.15)}

_REFERENCE = """
import json, sys
import repro.launch.dryrun as d
import repro.configs.registry as reg
from repro.configs.base import INPUT_SHAPES, InputShape
d.get_config = reg.get_smoke_config
INPUT_SHAPES['train_4k'] = InputShape('train_4k', 128, 8, 'train')
INPUT_SHAPES['long_500k'] = InputShape('long_500k', 2048, 1, 'decode')
cells = {}
for arch, shape in %r:
    rec = d.run_one(arch, shape, False, out_dir=sys.argv[1], force=True)
    assert rec['status'] == 'ok', rec.get('error', '')[-2000:]
    cells[arch + ' ' + shape] = {k: rec[k] for k in
                                 ('memory', 'cost', 'collectives')}
print(json.dumps(cells))
""" % (HLO_CELLS,)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's dry-run records of the HLO cells at (2, 4)."""
    env = dict(os.environ, PYTHONPATH=SRC, DRYRUN_DEVICES="8",
               REPRO_MESH_OVERRIDE="2,4", JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE,
         str(tmp_path_factory.mktemp("jdry8"))],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def card_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("card")


def mesh_record(tmp_path, monkeypatch, mesh_name, arch, shape):
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", OVERRIDES[mesh_name])
    return dryrun.run_one(get_smoke_config(arch), SMOKE_SHAPES[shape],
                          out_dir=str(tmp_path), mesh=mesh_name)


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("mesh_name", list(OVERRIDES))
def test_mesh_smoke_record(tmp_path, card_dir, monkeypatch, mesh_name, arch,
                           shape):
    rec = mesh_record(tmp_path, monkeypatch, mesh_name, arch, shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_chips"] == 8 and rec["mesh"] == "h100x8"
    assert rec["recipe"] == "default"
    coll, r = rec["collectives"], rec["roofline"]
    assert set(coll["counts"]) == set(dryrun.COLLECTIVES.values())
    assert coll["total_bytes_per_device"] == sum(
        coll["bytes_per_device"].values()) > 0
    assert r["t_collective_s"] == pytest.approx(
        coll["total_bytes_per_device"] / mesh.COLLECTIVE_BW)
    assert r["model_flops_per_device"] == pytest.approx(
        r["model_flops_total"] / 8)
    assert 0 < rec["cost"]["dot_flops"] <= rec["cost"]["flops"]
    assert rec["memory"]["per_device_total_gb"] * 1e9 >= \
        rec["memory"]["argument_size_in_bytes"]
    card = dryrun.run_one(get_smoke_config(arch), SMOKE_SHAPES[shape],
                          out_dir=str(card_dir))
    assert rec["memory"]["argument_size_in_bytes"] < \
        card["memory"]["argument_size_in_bytes"]
    dot, card_dot = rec["cost"]["dot_flops"], card["cost"]["dot_flops"]
    assert card_dot / 8 <= dot < card_dot


@pytest.mark.parametrize("arch,shape", HLO_CELLS)
def test_mesh_record_against_the_reference_hlo(reference, tmp_path,
                                               monkeypatch, arch, shape):
    rec = mesh_record(tmp_path, monkeypatch, "single", arch, shape)
    assert rec["status"] == "ok", rec.get("error")
    want = reference[f"{arch} {shape}"]
    assert rec["memory"]["argument_size_in_bytes"] == \
        want["memory"]["argument_size_in_bytes"]
    card = dryrun.run_one(get_smoke_config(arch), SMOKE_SHAPES[shape],
                          out_dir=str(tmp_path / "card"))
    share, above = HLO_SHARE[(arch, shape)]
    expect = share * card["cost"]["dot_flops"]
    assert expect <= rec["cost"]["dot_flops"] <= above * expect
    ratios = {"dot_flops": rec["cost"]["dot_flops"]
              / want["cost"]["dot_flops"]}
    for name, b in want["collectives"]["bytes_per_device"].items():
        got = rec["collectives"]["bytes_per_device"][name]
        ratios[name] = got / b if b else (None if got == 0 else float("inf"))
    print(json.dumps({"cell": f"{arch} {shape}", "mesh": "2,4",
                      "port": {"dot_flops": rec["cost"]["dot_flops"],
                               **rec["collectives"]["bytes_per_device"]},
                      "reference": {
                          "dot_flops": want["cost"]["dot_flops"],
                          **want["collectives"]["bytes_per_device"]},
                      "port_over_share": rec["cost"]["dot_flops"] / expect,
                      "ratios": ratios}))
