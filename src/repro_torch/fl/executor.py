"""Client executors: how one round's LocalTrain workload runs.

``SequentialExecutor`` loops over the clients through
``ClientRunner.train_client`` on the runner's device.

``BatchedExecutor`` groups the clients that received the same knobs
(same shapes), draws every microbatch of the group up front in the
reference's (client, step, micro) order, and trains the group as one
stack: each microbatch is one ``torch.func.vmap`` over clients of
``torch.func.grad_and_value`` of the model's loss (the model is a
function of its parameter dict, so no ``functional_call`` is needed),
and each local step one vmapped masked optimizer update. Steps and
microbatches are Python loops. The losses come back to the host once
per group. Each client's delta then takes the sequential path's wire
round trip (``core.client.finalize_delta``: one launch of each wire
kernel per delta), and the results come back in assignment order.

The vmapped loss runs with gradients on, so attention takes the dense
branch (``models.layers.attn_apply_full``) and never the flash kernel.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch import telemetry
from repro_torch.core.client import (ClientResult, ClientRunner,
                                     _masked_wire_mb, apply_masked_update,
                                     finalize_delta)
from repro_torch.core.policy import Knobs
from repro_torch.fl.device import ClientInfo
from repro_torch.models.convert import as_params

Assignment = Tuple[ClientInfo, Knobs]
Tensors = Dict[str, torch.Tensor]


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


class BatchedExecutor(ClientExecutor):
    """Same-knob clients stacked and trained together; matches the
    sequential path up to float reassociation (same batches, same update
    arithmetic)."""

    def __init__(self, runner: ClientRunner):
        self.runner = runner
        model, opt = runner.model, runner.opt

        def loss(w: Tensors, batch) -> torch.Tensor:
            return model.train_loss(w, batch)[0]

        def update(w, opt_state, grads, mask):
            return apply_masked_update(opt, w, opt_state, grads, mask)

        self._grad = vmap(grad_and_value(loss))
        self._init = vmap(opt.init)
        self._update = vmap(update, in_dims=(0, 0, 0, None))

    def _stack_batches(self, cids: Sequence[int], kn: Knobs) -> Tensors:
        """Every microbatch of the group, drawn per client in (step,
        micro) order, as {key: (C, s * grad_accum, b, seq)} on the
        device (one copy per key)."""
        runner = self.runner
        n = kn.s * kn.grad_accum
        per_key: Dict[str, list] = {}
        for cid in cids:
            rows: Dict[str, list] = {}
            for _ in range(n):
                batch = runner.data.batch(cid, kn.b, runner.fl.seq_len)
                for key, arr in batch.items():
                    rows.setdefault(key, []).append(arr)
            for key, arrs in rows.items():
                per_key.setdefault(key, []).append(np.stack(arrs))
        return {key: torch.from_numpy(np.stack(arrs)).to(runner.device)
                for key, arrs in per_key.items()}

    def _train_stack(self, params: Tensors, mask: Tensors, batches: Tensors,
                     grad_accum: int) -> Tuple[Tensors, torch.Tensor]:
        """LocalTrain of C same-knob clients from their stacked
        microbatches ({key: (C, s * grad_accum, b, seq)}) -> (stacked
        weights (C, ...), each client's mean train loss (C,)), both on
        the device."""
        c, n = next(iter(batches.values())).shape[:2]
        w = {k: p.unsqueeze(0).expand(c, *p.shape) for k, p in params.items()}
        opt_state = self._init(w)
        if grad_accum > 1:
            accum = torch.tensor(np.float32(grad_accum),
                                 device=self.runner.device)
        losses = []
        for j0 in range(0, n, grad_accum):
            grads_sum = None
            for j in range(j0, j0 + grad_accum):
                micro = {key: v[:, j] for key, v in batches.items()}
                grads, loss = self._grad(w, micro)
                losses.append(loss)
                grads_sum = grads if grads_sum is None else {
                    k: a + grads[k] for k, a in grads_sum.items()}
            if grad_accum > 1:
                grads_sum = {k: g / accum for k, g in grads_sum.items()}
            w, opt_state = self._update(w, opt_state, grads_sum, mask)
        return w, torch.mean(torch.stack(losses), dim=0)

    def _train_group(self, params: Tensors, mask: Tensors, kn: Knobs,
                     cids: Sequence[int]) -> Tuple[Tensors, List[float]]:
        """LocalTrain of one knob group -> (stacked weights (C, ...), the
        clients' mean train losses)."""
        with telemetry.span("fl.draw"):
            batches = self._stack_batches(cids, kn)
        with telemetry.span("fl.step"):
            w, losses = self._train_stack(params, mask, batches,
                                          kn.grad_accum)
        return w, losses.tolist()          # one host sync per group

    def run_round(self, params, assignments):
        runner = self.runner
        params = as_params(params)
        runner._check_device(params)
        groups: Dict[Knobs, List[int]] = {}
        for idx, (_, kn) in enumerate(assignments):
            groups.setdefault(kn, []).append(idx)

        topk = runner.fl.wire_topk
        results: List[ClientResult] = [None] * len(assignments)  # type: ignore
        for kn, idxs in groups.items():
            cids = [assignments[i][0].client_id for i in idxs]
            mask, active = runner.mask_for(params, kn.k)
            w, losses = self._train_group(params, mask, kn, cids)
            with telemetry.span("fl.wire"):
                for row, i in enumerate(idxs):
                    delta = finalize_delta({k: t[row] for k, t in w.items()},
                                           params, mask, kn.q, topk=topk)
                    results[i] = ClientResult(
                        client_id=cids[row], delta=delta,
                        params_active=active, train_loss=losses[row],
                        wire_mb_actual=_masked_wire_mb(delta, mask, kn.q,
                                                       topk=topk))
        return results


# ---------------------------------------------------------------------------
# trace-analysis entry points (repro_torch.analysis.trace)
# ---------------------------------------------------------------------------


def _batched_round_build():
    from repro_torch.analysis.trace.registry import (TRACE_MODEL,
                                                     charlm_trace_setup)
    c, s, ga, b, seq = 2, 2, 1, 4, TRACE_MODEL["seq_len"]
    runner, params, _ = charlm_trace_setup(b=b)
    ex = BatchedExecutor(runner)
    mask, _ = runner.mask_for(params, 0)
    gen = torch.Generator().manual_seed(3)
    batches = {key: torch.randint(0, TRACE_MODEL["vocab"], (c, s * ga, b, seq),
                                  generator=gen, dtype=torch.int32)
               for key in ("tokens", "targets")}

    def cohort_round(params, mask, batches):
        return ex._train_stack(params, mask, batches, ga)

    return cohort_round, (params, mask, batches)


def trace_entry_points() -> List[object]:
    """Declared traceable surface: one cohort round of the batched
    executor (vmap over clients of each microbatch's gradient and each
    step's masked update; steps and microbatches unroll)."""
    from repro_torch.analysis.trace.registry import EntryPoint, anchor
    return [EntryPoint(
        name="fl.executor_batched_round",
        **anchor(BatchedExecutor._train_stack), build=_batched_round_build,
        note="vmap(C=2) over s=2 steps of ga=1, b=4")]


EXECUTORS = {
    "sequential": SequentialExecutor,
    "batched": BatchedExecutor,
}


def make_executor(name: str, runner: ClientRunner) -> ClientExecutor:
    try:
        return EXECUTORS[name](runner)
    except KeyError:
        raise ValueError(f"unknown executor {name!r}; "
                         f"options: {sorted(EXECUTORS)}") from None
