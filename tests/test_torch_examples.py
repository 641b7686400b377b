"""The port's examples (``repro_torch.examples``, one module per script
of the reference's ``examples/``) run in-process on the CPU at
``REPRO_EXAMPLE_ROUNDS=1``, each through its ``main(argv)``, and print
what the reference's scripts print. Their card default is checked in
``tests/test_torch_package.py``."""
import pytest

torch = pytest.importorskip("torch")

import torch_tiny  # noqa: E402,F401  (one torch thread per worker)
from repro_torch import examples  # noqa: E402,F401

NAMES = ["quickstart", "federated_train", "heterogeneous_fleet",
         "unreliable_fleet", "async_fleet", "constraint_controllers",
         "constraint_sweep", "serve"]


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, monkeypatch, capsys):
    import importlib
    monkeypatch.setenv("REPRO_EXAMPLE_ROUNDS", "1")
    module = importlib.import_module(f"repro_torch.examples.{name}")
    out = module.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.strip()
    if name == "quickstart":
        assert printed.count("step ") == 1 and "--- sample ---" in printed
        assert len(out) == len("HAMLET:\n") + 40
    elif name == "federated_train":
        assert set(out) == {"fedavg", "cafl"}
        assert all(len(r.history) == 1 for r in out.values())
    elif name in ("heterogeneous_fleet", "unreliable_fleet"):
        assert len(out.history) == 1
    elif name == "async_fleet":
        rounds, wall = out
        assert all(len(r.history) == 1 for r in (*rounds.values(),
                                                 *wall.values()))
        assert all(r.history[-1].sim_time > 0 for r in wall.values())
    elif name == "constraint_controllers":
        assert "adaptive" in printed and set(out) == {"paper policy",
                                                      "deadline_aware"}
    elif name == "constraint_sweep":
        assert len(out) == 12 and "commx0.25" in printed
    else:
        assert out.shape == (4, 1, 512) and torch.isfinite(out).all()
