"""The port's trace against the reference's, run live.

``repro.analysis.trace`` fails to import on the installed jax: its cost
model imports ``ClosedJaxpr``, ``Jaxpr``, ``JaxprEqn``, ``Literal`` and
``Var`` from ``jax.core``, which now keeps them in ``jax.extend.core``.
So the reference runs here in a subprocess that binds those five names
onto ``jax.core`` before the import, and is never compared through its
committed ``TRACE_BUDGETS.json`` (recorded on an older jax; its
``fl.client_update_step`` row no longer matches a live run). No file of
``repro`` changes for it.

It runs twice, at once: as it is, and with ``jax.checkpoint`` as the
identity. The reference's train loss recomputes each stacked unit and
each loss chunk in the backward pass (``jax.checkpoint``), the port's
client does not (``remat=False``), so the live reference counts more
matrix products than the port; without the recompute the counts are
equal, product for product.

Held equal: the eleven entry names, every entry's input and output
bytes, the fl.* entries' matrix-product FLOPs (against the run without
the recompute; the live run's are higher by the recompute alone), and
the memory gate's verdicts, with the adapted step's units within
``UNITS_ATOL``. Peaks and the kernels.* entries' total FLOPs are not
compared: the reference prices the Pallas bodies' interpret-mode
jaxprs (80.56 MiB for the top-k quantizer), the port each kernel as one
op; and a jaxpr is unfused where the port's aten graph has fused ops
(softmax, layer norm)."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_tiny  # noqa: E402,F401
from repro_torch.analysis.trace import (memory_gate,  # noqa: E402
                                        traced_entries)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

#: the adapted step's memory units, port against reference: the two
#: graphs price the same step at different granularity (aten ops against
#: jaxpr equations), so the ratio of its peaks at b 8 and b 32 may differ
#: by a few percent of the 0.26 budget
UNITS_ATOL = 0.01

_REFERENCE = r'''
import json, sys
import jax
import jax.core
import jax.extend.core as jec
for _n in ("ClosedJaxpr", "Jaxpr", "JaxprEqn", "Literal", "Var"):
    setattr(jax.core, _n, getattr(jec, _n))
if sys.argv[1] == "no-recompute":
    jax.checkpoint = lambda f=None, **kw: f if f is not None else (lambda g: g)
from repro.analysis.trace import memory_gate, traced_entries
from repro.analysis.trace.cost import _dot_general_flops, _sub_jaxprs


def dots(jaxpr, mult=1):
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += mult * _dot_general_flops(eqn)
        for sub, m, _ in _sub_jaxprs(eqn):
            total += dots(sub.jaxpr, mult * m)
    return total


traced = traced_entries()
print(json.dumps({
    "entries": {t.entry.name: dict(t.cost.to_json(),
                                   dot_flops=dots(t.closed_jaxpr.jaxpr))
                for t in traced},
    "gate": {r.entry: {"units": r.memory_units, "violated": r.violated,
                       "gated": r.gated} for r in memory_gate(traced)}}))
'''


def _run_reference(mode: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, mode], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    with ThreadPoolExecutor(2) as pool:
        live, flat = pool.map(_run_reference, ["live", "no-recompute"])
    return {"live": live, "no-recompute": flat}


@pytest.fixture(scope="module")
def port():
    return {t.entry.name: t for t in traced_entries()}


ENTRIES = sorted([
    "fl.client_grad_step", "fl.client_update_step", "fl.client_local_step",
    "fl.client_local_step@baseline", "fl.executor_batched_round",
    "fl.aggregate_sync", "fl.aggregate_weighted", "kernels.wire_dense",
    "kernels.wire_topk", "kernels.masked_sum", "constraints.dual_update"])
FL_ENTRIES = [e for e in ENTRIES if e.startswith("fl.")]


def test_same_entry_names(reference, port):
    assert sorted(reference["live"]["entries"]) == ENTRIES
    assert sorted(port) == ENTRIES


@pytest.mark.parametrize("name", ENTRIES)
def test_input_and_output_bytes_equal(reference, port, name):
    want = reference["live"]["entries"][name]
    got = port[name].cost
    assert (got.input_bytes, got.output_bytes) == (
        want["input_bytes"], want["output_bytes"])


@pytest.mark.parametrize("name", FL_ENTRIES)
def test_matmul_flops_equal_without_the_recompute(reference, port, name):
    """Product for product without the reference's jax.checkpoint; the
    live reference's excess is that recompute alone (none where nothing
    differentiates)."""
    got = port[name].cost.dot_flops
    assert got == reference["no-recompute"]["entries"][name]["dot_flops"]
    live = reference["live"]["entries"][name]["dot_flops"]
    assert live >= got
    assert (live > got) == (got > 0)


def test_gate_verdicts_equal(reference, port):
    want = reference["live"]["gate"]
    got = {r.entry: r for r in memory_gate(list(port.values()))}
    assert set(got) == set(want)
    for name, row in got.items():
        assert (row.gated, row.violated) == (want[name]["gated"],
                                             want[name]["violated"]), name
    assert got["fl.client_local_step@baseline"].memory_units == \
        pytest.approx(want["fl.client_local_step@baseline"]["units"])
    assert abs(got["fl.client_local_step"].memory_units
               - want["fl.client_local_step"]["units"]) <= UNITS_ATOL
