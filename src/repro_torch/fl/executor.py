"""Client executors: how one round's LocalTrain workload runs.

``SequentialExecutor`` loops over the clients through
``ClientRunner.train_client`` on the runner's device. The reference's
``BatchedExecutor`` (vmapped clients) is not ported yet (ROADMAP
queue 7); ``make_executor("batched")`` raises.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.client import ClientResult, ClientRunner
from repro_torch.core.policy import Knobs
from repro_torch.fl.device import ClientInfo

Assignment = Tuple[ClientInfo, Knobs]


class ClientExecutor:
    """Protocol: run one round of LocalTrain for the sampled clients."""

    def run_round(self, params, assignments: Sequence[Assignment]
                  ) -> List[ClientResult]:
        raise NotImplementedError


class SequentialExecutor(ClientExecutor):
    """Clients one after another, each with one host sync at its end."""

    def __init__(self, runner: ClientRunner):
        self.runner = runner

    def run_round(self, params, assignments):
        return [self.runner.train_client(ci.client_id, params, kn)
                for ci, kn in assignments]


EXECUTORS = {"sequential": SequentialExecutor}


def make_executor(name: str, runner: ClientRunner) -> ClientExecutor:
    if name == "batched":
        raise NotImplementedError(
            "the batched executor is not ported yet (ROADMAP queue 7)")
    try:
        return EXECUTORS[name](runner)
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; "
                         f"options: {sorted(EXECUTORS)}") from None
