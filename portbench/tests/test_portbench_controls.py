"""Each cell's control comes out as not correct under the cell's limits:
the reference put in the program's place and computed one precision
below the configuration's (TF32 products for the char-LM's fp32; float8
e4m3 products for Phi-3.5-MoE's bf16), judged by the cell's own
comparison, at test size. TF32 exists only on the card, so the
federated cell's control runs there (``cuda``); the float8 controls run
on the CPU. The readings at each cell's own size are in PERF.md
(``python3 -m portbench.tools.controls``)."""
import pytest
import torch

from portbench import harness
from portbench.tests import tiny
from portbench.tools import controls

SEEDS = (3, 2 ** 31 + 17, 4_000_000_001)


def _fails(readings, key):
    return any(c["value"] > c["limit"] for c in readings[key].values())


def _cell(tmp_path, workload):
    spec, bench = tiny.make(tmp_path)
    return harness.resolve(spec, workload, bench)


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_control_is_not_correct(tmp_path, seed):
    cell = _cell(tmp_path, "phi35moe.prefill.2k-8k")
    assert _fails(controls.readings(cell, seed, torch.device("cpu")),
                  "control_fp8")


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_train_control_is_not_correct(tmp_path, seed):
    cell = _cell(tmp_path, "phi35moe.train.8x4k")
    assert _fails(controls.readings(cell, seed, torch.device("cpu")),
                  "control_fp8")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_is_not_correct(tmp_path, seed):
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need the card")
    cell = _cell(tmp_path, "charlm.cafl.c115")
    assert _fails(controls.readings(cell, seed, torch.device("cuda")),
                  "control_tf32")


@pytest.mark.parametrize("workload", ["charlm.cafl.c115",
                                      "phi35moe.train.8x4k"])
def test_half_batch_fault_in_the_reference_is_not_correct(tmp_path,
                                                          workload):
    cell = _cell(tmp_path, workload)
    assert _fails(controls.readings(cell, SEEDS[0], torch.device("cpu")),
                  "fault_half_batch")
