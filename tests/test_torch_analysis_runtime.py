"""The port's runtime sanitizers (``repro_torch.analysis.runtime``): the
sync guard's and the rebuild watcher's bookkeeping over a tiny engine
run on the CPU (where the sync debug mode is inert), the call-site
mapping and the allow-list; then, on a card only (marked ``cuda``), the
sync sites a round records, ``no_syncs`` raising, and zero kernel-library
builds or loads after round 1."""
import ast
import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.runtime import (EXPLICIT_READS,  # noqa: E402
                                          RecompileWatchCallback,
                                          RecompileWatcher, SyncGuardCallback,
                                          SyncRecorder, call_site,
                                          compile_count, no_syncs,
                                          sync_debug_supported)
from repro_torch.configs import get_config, get_fl_config  # noqa: E402
from repro_torch.data import load_corpus  # noqa: E402
from repro_torch.fl import FederatedEngine  # noqa: E402
from repro_torch.kernels import cuda_lib, ops  # noqa: E402
from repro_torch.models import build  # noqa: E402

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro_torch")


def _tiny_engine(device, callbacks, aggregator="sync"):
    """The reference runtime test's engine: 3 rounds, 4 clients, 2 a
    round, a 3-layer d_model 48 char-LM."""
    ds = load_corpus(target_bytes=60_000)
    cfg = get_config("charlm-shakespeare").replace(
        vocab_size=max(ds.vocab_size, 64), num_layers=3, d_model=48,
        num_heads=4, num_kv_heads=4, head_dim=12, d_ff=96)
    fl = get_fl_config().replace(
        rounds=3, num_clients=4, clients_per_round=2, s_base=3, b_base=8,
        seq_len=16, eval_batches=1, eval_batch_size=8)
    fl = fl.replace(duals=dataclasses.replace(fl.duals, s_min=2, b_min=4))
    return FederatedEngine(build(cfg), fl, ds, strategy="cafl",
                           executor="sequential", aggregator=aggregator,
                           callbacks=callbacks, device=device)


@pytest.fixture(scope="module")
def cpu_run():
    guard = SyncGuardCallback(from_round=2)
    watch = RecompileWatchCallback()
    try:
        result = _tiny_engine("cpu", [guard, watch]).run()
    finally:
        guard.close()
    return result, guard, watch


# ---------------------------------------------------------------------------
# bookkeeping on the CPU
# ---------------------------------------------------------------------------


def test_sync_guard_bookkeeping(cpu_run):
    """Rounds >= 2 are guarded; without CUDA the mode is inert, so
    nothing is recorded and nothing is a fault."""
    result, guard, _ = cpu_run
    assert len(result.history) == 3
    assert guard.guarded_rounds == [2, 3]
    if not sync_debug_supported():
        assert guard.per_round == {} and guard.faults() == {}
    guard.close()                       # idempotent


def test_rebuild_watch_bookkeeping(cpu_run):
    """Every round is bucketed; a CPU run builds and loads nothing."""
    _, _, watch = cpu_run
    assert sorted(watch.per_round) == [1, 2, 3]
    assert watch.steady_state_compiles(first_steady_round=2) == 0
    if not torch.cuda.is_available():
        assert watch.per_round == {1: 0, 2: 0, 3: 0}


def test_guard_faults_are_the_sites_outside_the_allow_list():
    guard = SyncGuardCallback(from_round=2,
                              allowed={"core/client.py:train_client": "x"})
    guard.per_round = {2: {"core/client.py:train_client": 6},
                       3: {"core/client.py:train_client": 6,
                           "fl/engine.py:run": 1}}
    assert guard.faults() == {3: {"fl/engine.py:run": 1}}


def test_watcher_counts_library_events_and_dynamo_graphs(monkeypatch):
    w = RecompileWatcher()
    with w:
        assert w.mark("idle") == 0
        monkeypatch.setitem(cuda_lib.LIBRARY_EVENTS, "loads",
                            cuda_lib.LIBRARY_EVENTS["loads"] + 1)
        assert w.mark("load") == 1
        f = torch.compile(lambda x: x * 3, backend="eager")
        x = torch.arange(8.0)
        f(x)
        first = w.mark("compile")
        f(x)                            # same shape: no new graph
        assert w.mark("warm") == 0
    assert first >= 1
    assert w.buckets == {"idle": 0, "load": 1, "compile": first, "warm": 0}
    assert w.total == 1 + first
    assert compile_count() >= w.total


def test_no_syncs_and_recorder_are_inert_without_cuda():
    if sync_debug_supported():
        pytest.skip("a CUDA device is present: the mode is live")
    x = torch.arange(4.0)
    with no_syncs():
        assert float(x.sum().item()) == 6.0
    rec = SyncRecorder()
    rec.start()
    float(x.sum())
    rec.stop()
    assert rec.counts == {}


def test_call_site_names_the_package_relative_file_and_function():
    assert call_site() == ("test_torch_analysis_runtime.py:"
                           "test_call_site_names_the_package_relative_"
                           "file_and_function")
    src = os.path.join(PACKAGE, "fl", "callbacks.py")
    code = compile("import sys\nsite = call_site(sys._getframe())", src,
                   "exec")
    scope = {"call_site": call_site}
    exec(code, scope)
    assert scope["site"] == "fl/callbacks.py:<module>"


@pytest.mark.parametrize("site", sorted(EXPLICIT_READS))
def test_explicit_reads_name_real_functions(site):
    """Each allow-list entry names a function of a port module, with a
    reason."""
    path, func = site.split(":")
    with open(os.path.join(PACKAGE, path)) as f:
        tree = ast.parse(f.read())
    names = {n.name for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    assert func in names
    assert len(EXPLICIT_READS[site]) > 20


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sync debug mode and the "
                    "kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_no_syncs_raises_on_a_host_read(card):
    x = torch.arange(4.0, device=card)
    y = x * 2                           # no sync: allowed
    with pytest.raises(RuntimeError, match="synchroniz"):
        with no_syncs():
            y.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_recorder_attributes_syncs_to_their_call_site(card):
    rec = SyncRecorder()
    rec.start()
    try:
        ops.masked_sum_u64(np.ones((2, 3), np.uint64), device=card)
        torch.arange(3.0, device=card).sum().item()
    finally:
        rec.stop()
    assert rec.counts["kernels/ops.py:masked_sum_u64"] >= 2
    assert rec.counts[
        "test_torch_analysis_runtime.py:"
        "test_recorder_attributes_syncs_to_their_call_site"] == 1
    assert torch.cuda.get_sync_debug_mode() == 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        torch.arange(3.0, device=card).sum().item()   # mode restored


@pytest.mark.cuda
@pytest.mark.parametrize("aggregator", ["sync", "masked"])
def test_card_round_loop_syncs_only_where_allowed(card, aggregator):
    """The tiny engine on the card: every steady-state sync comes from
    an EXPLICIT_READS site, and nothing is built or loaded after
    round 1."""
    guard = SyncGuardCallback(from_round=2)
    watch = RecompileWatchCallback()
    try:
        _tiny_engine(card, [guard, watch], aggregator).run()
    finally:
        guard.close()
    assert guard.guarded_rounds == [2, 3]
    assert all(guard.per_round[r] for r in (2, 3)), guard.per_round
    assert guard.faults() == {}, guard.per_round
    assert watch.steady_state_compiles(2) == 0, watch.per_round
    assert torch.cuda.get_sync_debug_mode() == 0
