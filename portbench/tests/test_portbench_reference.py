"""The reference against the port on the CPU, at test sizes: each cell
run through the harness (its look for a card skipped) with the real
drivers, and the numbers that decide ``correct`` read far inside their
limits. With the timed path broken underneath (a step that returns its
state unchanged and half of each batch left out with the mean over the
rest, for the training cells; a served token altered where it is
produced, and the flash attention's output scaled at every position
past a length, for the prefill cell), ``correct`` comes out false. A cell on one card has no exchange between chips to leave
out."""
import pytest

from portbench.tests import tiny

CELLS = ["charlm.cafl.c115", "phi35moe.train.8x4k", "phi35moe.prefill.2k-8k"]
#: the port and the reference at test size, in fp32 on the CPU: the
#: exact numbers are 0, the rest within float reassociation
AGREE = 1e-3
FAULTS = [("charlm.cafl.c115", "unchanged"),
          ("charlm.cafl.c115", "half_batch"),
          ("phi35moe.train.8x4k", "unchanged"),
          ("phi35moe.train.8x4k", "half_batch"),
          ("phi35moe.prefill.2k-8k", "token"),
          ("phi35moe.prefill.2k-8k", "late")]


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference(tmp_path, workload):
    res = tiny.run(tmp_path, workload)
    assert res["correct"], res["checks"]
    for name, c in res["checks"].items():
        assert c["value"] <= AGREE, (name, c)
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tmp_path, workload, fault):
    res = tiny.run(tmp_path, workload, fault=fault)
    assert not res["correct"], res["checks"]


def test_traced_run_reads_its_spans(tmp_path):
    """A traced CPU run: the span-based readers find their spans; the
    device readers find no device operation and report nothing."""
    res = tiny.run(tmp_path, "charlm.cafl.c115", trace=True)
    m = res["metrics"]
    assert m["localtrain_s_per_round.fl"]["value"] > 0
    assert "server_s_per_round.fl" in m
    for name in ("device_idle.fl", "step_mfu.fl", "wire_roofline.fl",
                 "host_syncs_per_round.fl"):
        assert name not in m
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0
