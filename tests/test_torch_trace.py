"""The port's trace analysis (``repro_torch.analysis.trace``): the aten
cost model, the TRACE rules (a seeded case and a pure one each), the
registered entry points, the Budgets.memory gate, the committed
``TRACE_BUDGETS_TORCH.json``, the static peak against ``MemTracker``'s
measured peak of the real client step on the CPU, the traceable dual
update against both packages' laws, and ``--trace`` on the CLI.

Every entry traces on fake tensors (nothing is allocated), so these
tests run the same here and on the card. Parity with the reference's
jaxpr trace is ``tests/test_torch_trace_parity.py``."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tiny  # noqa: E402,F401  (one CPU thread, as every port test)
from repro_torch.analysis.trace import (DEFAULT_TRACE_TABLE,  # noqa: E402
                                        EntryPoint, charlm_trace_setup,
                                        collect_entry_points, cost_of_graph,
                                        memory_gate, run_trace,
                                        run_trace_rules, trace_entry,
                                        trace_rule_ids, traced_entries)
from repro_torch.analysis.trace.gate import (PEAK_RTOL,  # noqa: E402
                                             build_table, diff_table,
                                             load_table)
from repro_torch.analysis.trace.rules import DEVICE_PUT_MIN_BYTES  # noqa
from repro_torch.core import client as tclient  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
F32 = torch.float32

#: the paper's surfaces, the reference's eleven entry names
ENTRY_NAMES = {
    "fl.client_grad_step", "fl.client_update_step", "fl.client_local_step",
    "fl.client_local_step@baseline", "fl.executor_batched_round",
    "fl.aggregate_sync", "fl.aggregate_weighted", "kernels.wire_dense",
    "kernels.wire_topk", "kernels.masked_sum", "constraints.dual_update"}

#: the reference's bracket of the static peak against a measured one
BRACKET_LO = 0.5
BRACKET_HI = 4.0


def _entry(fn, args, name="fixture.entry", **kw):
    return EntryPoint(name=name, path="tests/test_torch_trace.py", line=1,
                      build=lambda: (fn, args), **kw)


def _traced(fn, args, **kw):
    return trace_entry(_entry(fn, args, **kw))


def _rules(fn, args, rule, **kw):
    return [f for f in run_trace_rules([_traced(fn, args, **kw)])
            if f.rule == rule]


def _by_name():
    return {t.entry.name: t for t in traced_entries()}


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------


def test_matmul_cost_exact():
    t = _traced(lambda x, y: x @ y,
                (torch.zeros(64, 128), torch.zeros(128, 32)))
    cost = t.cost
    assert cost.flops == cost.dot_flops == 2 * 64 * 32 * 128
    assert cost.input_bytes == (64 * 128 + 128 * 32) * 4
    assert cost.output_bytes == 64 * 32 * 4
    # inputs held by the caller + the output live together
    assert cost.peak_bytes == cost.input_bytes + cost.output_bytes
    assert cost.transfer_bytes == 0
    assert cost.eqns == 1


def _chain(x):
    a = x * 2.0
    b = a + 1.0
    return b * 3.0


def _chain_(x):
    return x.mul_(2.0).add_(1.0).mul_(3.0)


def test_liveness_chain_and_donation():
    """a = x*2; b = a+1; c = b*3: with x held by the caller the worst
    instant holds x and two temporaries; donating x frees it after its
    one read, one buffer less."""
    n = 1024
    t = _traced(_chain, (torch.zeros(n),))
    assert t.cost.peak_bytes == 3 * n * 4
    assert cost_of_graph(t.graph, donated=[0]).peak_bytes == 2 * n * 4
    assert t.cost.flops == 3 * n


def test_liveness_in_allocator_blocks():
    """granule=512 rounds each storage up to the CUDA allocator's block:
    the chain of 10 floats holds three storages, 3 x 512 bytes."""
    t = _traced(_chain, (torch.zeros(10),))
    assert t.cost.peak_bytes == 3 * 40
    assert cost_of_graph(t.graph, granule=512).peak_bytes == 3 * 512


def test_liveness_in_place_writes_allocate_nothing():
    """The same chain written into x: every node writes x's storage, so
    the peak is x alone, and the entry counts x as written in place."""
    n = 1024
    t = _traced(_chain_, (torch.zeros(n),), donatable=(0,))
    assert t.cost.peak_bytes == n * 4
    assert t.inplace_leaves == t.donatable_leaves == 1
    assert t.cost.flops == 3 * n


def test_liveness_counts_storages_not_views():
    """y = x*2; v = y.view(-1) (no allocation, keeps y alive); z = x+1;
    out = v + z: x, y, z and out live together, 4 buffers (per node, 5;
    had the view not kept y alive, 3)."""
    n = 32

    def f(x):
        y = x * 2.0
        v = y.view(-1)
        z = x.reshape(-1) + 1.0
        return v + z

    t = _traced(f, (torch.zeros(n, n),))
    assert t.cost.peak_bytes == 4 * n * n * 4
    assert t.cost.eqns == 5


# ---------------------------------------------------------------------------
# TRACE001 64-bit promotion
# ---------------------------------------------------------------------------


def test_trace001_fires_on_f64_widening():
    assert _rules(lambda x: x.to(torch.float64) * 2.0, (torch.zeros(8),),
                  "TRACE001")


def test_trace001_fires_on_default_int64_arange():
    """torch.arange defaults to int64; positions feeding arithmetic are
    the promotion the port's models pin to int32."""
    def f(x):
        pos = torch.arange(x.shape[0], device=x.device)
        return x * pos.to(torch.float32)
    finds = _rules(f, (torch.zeros(8),), "TRACE001")
    assert [f.snippet for f in finds] == [
        "trace:fixture.entry:widen:arange:int64"]


def test_trace001_fires_on_int64_reaching_an_output():
    finds = _rules(lambda i: i.long() + 1,
                   (torch.zeros(8, dtype=torch.int32),), "TRACE001")
    assert {f.snippet.split(":", 2)[2] for f in finds} == {
        "widen:_to_copy:int64", "wide-output:int64"}


def test_trace001_clean_on_f32_path():
    assert not _rules(lambda x: x * 2.0 + 1.0, (torch.zeros(8),), "TRACE001")


def test_trace001_skips_int64_read_only_as_an_index():
    """The loss widens int32 targets for torch.gather (index ops take
    int64 only): a platform requirement, not a promotion."""
    def f(x, t):
        return torch.gather(x, -1, t.long()[..., None])[..., 0].sum()
    args = (torch.zeros(4, 8), torch.zeros(4, dtype=torch.int32))
    assert not _rules(f, args, "TRACE001")


# ---------------------------------------------------------------------------
# TRACE002 missed in-place update
# ---------------------------------------------------------------------------


def _update_args():
    runner, params, _ = charlm_trace_setup(b=2)
    mask, _ = runner.mask_for(params, 0)
    grads = {k: torch.full_like(p, 1e-3) for k, p in params.items()}
    return runner.opt, (params, runner.opt.init(params), grads, mask)


def test_trace002_fires_on_the_out_of_place_update():
    """The client's update before the repair: built out of place, it
    writes none of the opt-state and gradient leaves it is handed."""
    opt, args = _update_args()
    fn = lambda *a: tclient.apply_masked_update(opt, *a)  # noqa: E731
    finds = _rules(fn, args, "TRACE002", donatable=(1, 2))
    assert [f.snippet for f in finds] == [
        "trace:fixture.entry:missed-donation"]


def test_trace002_clean_on_the_in_place_update():
    opt, args = _update_args()
    fn = lambda *a: tclient.apply_masked_update_(opt, *a)  # noqa: E731
    assert not _rules(fn, args, "TRACE002", donatable=(1, 2))


def test_in_place_update_is_bit_equal_to_the_out_of_place_one():
    """Three steps of the in-place update from the same state give the
    out-of-place update's parameters and state bit for bit (frozen
    leaves included)."""
    runner, params, _ = charlm_trace_setup(b=2)
    mask, _ = runner.mask_for(params, 2)
    gen = torch.Generator().manual_seed(7)
    w1, s1 = params, runner.opt.init(params)
    w2, s2 = params, runner.opt.init(params)
    for _ in range(3):
        grads = {k: torch.randn(p.shape, generator=gen)
                 for k, p in params.items()}
        w1, s1 = tclient.apply_masked_update(runner.opt, w1, s1, grads, mask)
        w2, s2 = tclient.apply_masked_update_(
            runner.opt, w2, s2, {k: g.clone() for k, g in grads.items()}, mask)
    for k in params:
        assert torch.equal(w1[k], w2[k]), k
        assert torch.equal(s1.mu[k], s2.mu[k])
        assert torch.equal(s1.nu[k], s2.nu[k])
    assert int(s1.count) == int(s2.count) == 3


# ---------------------------------------------------------------------------
# TRACE003 dense cohort materialisation
# ---------------------------------------------------------------------------


def test_trace003_fires_on_stacked_combine():
    deltas = tuple(torch.zeros(256) for _ in range(4))
    assert _rules(lambda *ds: torch.stack(ds).mean(dim=0), deltas,
                  "TRACE003", cohort=4)


def test_trace003_clean_on_incremental_combine():
    from repro_torch.core.aggregation import aggregate
    deltas = tuple({"w": torch.zeros(256)} for _ in range(4))
    assert not _rules(lambda *ds: aggregate(list(ds)), deltas, "TRACE003",
                      cohort=4)


# ---------------------------------------------------------------------------
# TRACE004 host transfers
# ---------------------------------------------------------------------------


def test_trace004_fires_on_a_host_read():
    """.item() cannot be traced on fake tensors: the registry records the
    read on the entry instead of failing, and TRACE004 reports it."""
    t = _traced(lambda x: x * x.sum().item(), (torch.zeros(8),))
    assert t.graph is None and "_local_scalar_dense" in t.host_read
    finds = [f for f in run_trace_rules([t]) if f.rule == "TRACE004"]
    assert [f.snippet for f in finds] == ["trace:fixture.entry:host-read"]


def test_trace004_fires_on_nonzero():
    """nonzero's output size is the data's: the host waits for it."""
    t = _traced(lambda x: torch.nonzero(x).sum(), (torch.zeros(8),))
    assert t.graph is None and "nonzero" in t.host_read
    assert [f.rule for f in run_trace_rules([t])] == ["TRACE004"]


def test_trace004_fires_on_a_copy_to_the_host():
    finds = _rules(lambda x: (x * 2.0).cpu(), (torch.zeros(8),), "TRACE004")
    assert [f.snippet for f in finds] == [
        "trace:fixture.entry:host-boundary:_to_copy"]


def test_trace004_clean_on_pure_fn():
    assert not _rules(lambda x: x * 2.0, (torch.zeros(8),), "TRACE004")


# ---------------------------------------------------------------------------
# the registered entry points
# ---------------------------------------------------------------------------


def test_trace_rule_registry():
    assert trace_rule_ids() == ["TRACE001", "TRACE002", "TRACE003",
                                "TRACE004"]


def test_registry_covers_the_paper_surfaces():
    assert {e.name for e in collect_entry_points()} == ENTRY_NAMES


def test_entry_anchors_point_at_their_code():
    for e in collect_entry_points():
        with open(os.path.join(REPO, e.path)) as fh:
            line = fh.read().splitlines()[e.line - 1]
        assert line.lstrip().startswith(("def ", "class ")), (e.name, line)


def test_repo_entries_trace_clean():
    findings = run_trace_rules(traced_entries())
    assert findings == [], [f.format() for f in findings]


def test_every_entry_costs_something():
    for t in traced_entries():
        assert t.graph is not None and not t.host_read, t.entry.name
        assert t.cost.peak_bytes > 0, t.entry.name
        assert t.cost.eqns > 0, t.entry.name
        assert t.cost.transfer_bytes < DEVICE_PUT_MIN_BYTES, t.entry.name


def test_kernel_entries_trace_through_the_stand_ins():
    """The wire and fold entries take the card's branch: each kernel is
    one stand-in node, and no twin's temporaries enter the trace."""
    from repro_torch.analysis.trace import iter_nodes
    want = {"kernels.wire_dense": ["quantize_blocks"],
            "kernels.wire_topk": ["quantize_topk_blocks"],
            "kernels.masked_sum": ["masked_sum_u64"]}
    for name, kernels in want.items():
        t = _by_name()[name]
        ops = [str(n.target) for n in iter_nodes(t.graph)]
        assert [o.split(".")[1] for o in ops if o.startswith("repro_torch.")] \
            == kernels, (name, ops)


def test_client_update_step_writes_in_place():
    t = _by_name()["fl.client_update_step"]
    assert t.donatable_leaves > 0
    assert t.inplace_leaves == t.donatable_leaves


def test_in_place_update_shrinks_static_peak():
    """TRACE002's repair, statically visible: the update step written in
    place peaks below the same step built out of place (the old client
    update), and below its own graph with nothing consumed."""
    t = _by_name()["fl.client_update_step"]
    runner, params, _ = charlm_trace_setup(b=8)
    mask, _ = runner.mask_for(params, 0)
    old = _traced(lambda *a: tclient.apply_masked_update(runner.opt, *a),
                  (params, runner.opt.init(params),
                   {k: torch.zeros_like(p) for k, p in params.items()}, mask))
    assert t.cost.input_bytes == old.cost.input_bytes
    assert t.cost.peak_bytes < old.cost.peak_bytes
    assert t.cost.peak_bytes < cost_of_graph(t.graph).peak_bytes


# ---------------------------------------------------------------------------
# the memory gate and the committed table
# ---------------------------------------------------------------------------


def test_memory_gate_baseline_violates_and_adapted_fits():
    """The paper's Fig. 2 shape, statically: at FedAvg's baseline knobs
    the client step exceeds Budgets.memory (0.31 > 0.26 by Table 1's
    calibration); at the adapted operating point it fits."""
    rows = {r.entry: r for r in memory_gate(traced_entries())}
    base = rows["fl.client_local_step@baseline"]
    adapted = rows["fl.client_local_step"]
    assert base.memory_units == pytest.approx(0.31)
    assert base.violated and not base.gated       # negative control
    assert adapted.gated and not adapted.violated
    assert adapted.memory_units < base.memory_units


def test_trace_table_committed_and_clean():
    """The committed TRACE_BUDGETS_TORCH.json matches a fresh trace (the
    ratchet) row for row, and the full run reports no problems."""
    report = run_trace(root=REPO)
    assert report.problems == [], report.problems
    assert report.findings == []
    table = load_table(os.path.join(REPO, DEFAULT_TRACE_TABLE))
    assert table is not None
    fresh = build_table(report.traced, report.gate)
    assert table == json.loads(json.dumps(fresh))


def test_diff_table_catches_regression_and_stale_rows():
    traced = list(traced_entries())
    table = build_table(traced, memory_gate(traced))
    name = traced[0].entry.name
    table["entries"][name]["peak_bytes"] = int(
        table["entries"][name]["peak_bytes"] * (1 - 2 * PEAK_RTOL))
    table["entries"]["ghost.entry"] = {"peak_bytes": 1}
    problems = diff_table(table, traced)
    assert any("peak regressed" in p and name in p for p in problems)
    assert any("ghost.entry" in p for p in problems)
    assert diff_table(None, traced)


# ---------------------------------------------------------------------------
# the static peak against a measured one
# ---------------------------------------------------------------------------


def test_static_peak_brackets_the_measured_cpu_peak():
    """The adapted local step run for real on the CPU under MemTracker
    (arguments, outputs and temporaries, as the reference counts XLA's
    memory analysis): the static estimate lies within the reference's
    band of it."""
    from torch.distributed._tools.mem_tracker import MemTracker
    ep = {e.name: e for e in collect_entry_points()}["fl.client_local_step"]
    static = _by_name()["fl.client_local_step"].cost.peak_bytes
    fn, args = ep.build()
    leaves = [t for t in torch.utils._pytree.tree_leaves(args)
              if isinstance(t, torch.Tensor)]
    tracker = MemTracker()
    tracker.track_external(*leaves)
    with tracker:
        fn(*args)
    measured = max(snap["Total"] for snap in
                   tracker.get_tracker_snapshot("peak").values())
    assert measured > 0
    ratio = static / measured
    assert BRACKET_LO <= ratio <= BRACKET_HI, (static, measured, ratio)


# ---------------------------------------------------------------------------
# the traceable dual update
# ---------------------------------------------------------------------------

#: the reference's ratios, and the band's float edge
RATIOS = [0.2, 0.89, 0.95, 1.0, 1.04, 1.05, 1.051, 1.3, 5.0]


def _law(lam, ratios):
    from repro_torch.configs import get_fl_config
    from repro_torch.constraints.controllers import DeadzoneSubgradient
    cfg = get_fl_config().duals
    return [DeadzoneSubgradient().step("k", lam, r, cfg) for r in ratios]


@pytest.mark.parametrize("lam", [0.0, 0.5, "max"])
def test_dual_step_torch_matches_the_scalar_law(lam):
    """In f64 the vectorised step is the scalar law exactly, the band's
    edge (1.05 - 1.0 > 0.05) included; in f32 it matches off the edge
    at the reference's tolerance."""
    from repro_torch.constraints.controllers import dual_step_torch
    from repro_torch.configs import get_fl_config
    cfg = get_fl_config().duals
    lam = cfg.lambda_max if lam == "max" else lam
    want = _law(lam, RATIOS)
    got = dual_step_torch(torch.full((len(RATIOS),), lam, dtype=torch.float64),
                          torch.tensor(RATIOS, dtype=torch.float64),
                          cfg.eta, cfg.deadzone, cfg.lambda_max)
    assert got.tolist() == want
    off_edge = [r for r in RATIOS if r != 1.05]
    want32 = _law(lam, off_edge)
    got32 = dual_step_torch(torch.full((len(off_edge),), lam, dtype=F32),
                            torch.tensor(off_edge, dtype=F32),
                            cfg.eta, cfg.deadzone, cfg.lambda_max)
    np.testing.assert_allclose(got32.numpy(), np.float32(want32), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("lam", [0.0, 0.5, "max"])
def test_dual_step_torch_matches_dual_step_jnp(lam):
    """f32 against the reference's jnp twin, bit for bit, at 1.05 too
    (in f32, 1.05 - 1.0 lies inside the 0.05 band in both)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.constraints.controllers import dual_step_jnp
    from repro_torch.configs import get_fl_config
    from repro_torch.constraints.controllers import dual_step_torch
    cfg = get_fl_config().duals
    lam = cfg.lambda_max if lam == "max" else lam
    want = np.asarray(dual_step_jnp(jnp.full((len(RATIOS),), lam, jnp.float32),
                                    jnp.asarray(RATIOS, jnp.float32),
                                    cfg.eta, cfg.deadzone, cfg.lambda_max))
    got = dual_step_torch(torch.full((len(RATIOS),), lam, dtype=F32),
                          torch.tensor(RATIOS, dtype=F32),
                          cfg.eta, cfg.deadzone, cfg.lambda_max)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def test_cli_trace_exits_clean_on_repo(capsys):
    from repro_torch.analysis.cli import EXIT_CLEAN, main
    assert main(["--root", REPO, "--trace"]) == EXIT_CLEAN
    out = capsys.readouterr().out
    assert "trace: 11 entry point(s), 4 TRACE rules" in out
    assert "gate[memory] fl.client_local_step@baseline: 0.310 / 0.26 " \
        "units (calibration)" in out
    assert "0 new finding(s)" in out and "0 runtime problem(s)" in out


def test_cli_trace_json_shape(capsys):
    from repro_torch.analysis.cli import main
    main(["--root", REPO, "--trace", "--json"])
    payload = json.loads(capsys.readouterr().out)
    trace = payload["trace"]
    assert {r["entry"] for r in trace["entries"]} == ENTRY_NAMES
    assert all("peak_bytes" in r and "flops" in r for r in trace["entries"])
    update = next(r for r in trace["entries"]
                  if r["entry"] == "fl.client_update_step")
    assert update["inplace_leaves"] == update["donatable_leaves"] > 0
    assert {r["entry"] for r in trace["gate"]} == {
        "fl.client_local_step", "fl.client_local_step@baseline"}
    assert trace["problems"] == []


def test_cli_trace_fails_on_a_regressed_table(tmp_path, capsys):
    """A table row below the traced peak is a problem: exit 1."""
    from repro_torch.analysis.cli import EXIT_FINDINGS, main
    table = load_table(os.path.join(REPO, DEFAULT_TRACE_TABLE))
    table["entries"]["fl.client_local_step"]["peak_bytes"] //= 2
    (tmp_path / "src").mkdir()
    with open(tmp_path / DEFAULT_TRACE_TABLE, "w") as fh:
        json.dump(table, fh)
    assert main(["--root", str(tmp_path), "--trace", "src"]) == EXIT_FINDINGS
    assert "TRACE PROBLEM" in capsys.readouterr().out


def test_charlm_trace_setup_shapes():
    runner, params, batch = charlm_trace_setup(b=4)
    assert batch["tokens"].shape == (4, runner.fl.seq_len)
    assert batch["tokens"].dtype == torch.int32
    assert len(params) > 0
    full = {"vocab": 128, "num_layers": 6, "d_model": 192, "num_heads": 8,
            "head_dim": 24, "d_ff": 384, "seq_len": 32}
    runner, params, batch = charlm_trace_setup(b=8, model=full)
    assert sum(p.numel() for p in params.values()) == 1_900_800
    assert batch["targets"].shape == (8, 32)
