"""Client-side LocalTrain (Algorithm 1, lines 10-11).

Runs ``s`` optimizer steps, each accumulating gradients over
``grad_accum`` microbatches of size ``b`` (token-budget preservation,
Eq. 8), with the bottom layers frozen per ``k`` (gradient mask) and the
resulting update quantized to level ``q`` for the wire.

``ClientRunner`` holds what every simulated client shares (model,
optimizer, masks per ``k``) on one device. Each microbatch
differentiates the loss with respect to detached copies of the current
weights. The masked AdamW step (``apply_masked_update_``) writes the
optimizer state and the masked gradients in place, as the reference
donates them to its jitted step, and returns new parameters: the
caller's round-global parameters are never written.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs.base import FLConfig
from repro_torch.core import compression, freezing
from repro_torch.core.policy import Knobs
from repro_torch.core.resources import ResourceModel
from repro_torch.data.federated import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.convert import as_params
from repro_torch.models.zoo import Model
from repro_torch.optim import make_optimizer

Tensors = Dict[str, torch.Tensor]


@dataclass
class ClientResult:
    """What one client hands back to the server each round."""
    client_id: int
    delta: Tensors              # masked, wire-compressed update
    params_active: float        # masked parameter count (proxies charge this)
    train_loss: float
    wire_mb_actual: float       # measured bytes incl. quantization scales


@torch.no_grad()
def apply_masked_update(opt, params: Tensors, opt_state, grads: Tensors,
                        mask: Tensors):
    """One optimizer step under a freezing mask: frozen leaves see zero
    gradient and zero movement; the add happens in fp32 then casts back.
    Builds new tensors throughout (the batched executor vmaps it)."""
    grads = freezing.apply_mask(grads, mask)
    updates, opt_state = opt.update(grads, opt_state, params)
    updates = freezing.apply_mask(updates, mask)
    new_params = {k: (p.to(torch.float32) + updates[k].to(torch.float32)
                      ).to(p.dtype) for k, p in params.items()}
    return new_params, opt_state


@torch.no_grad()
def apply_masked_update_(opt, params: Tensors, opt_state, grads: Tensors,
                         mask: Tensors):
    """``apply_masked_update``'s step, bit for bit, in place: the
    gradients are masked in their own buffers and consumed (``grads`` is
    emptied), the optimizer state is overwritten, and the new parameters
    are a copy updated in place (``params`` may be the round-global
    weights every client still reads). -> (new_params, opt_state)."""
    new_params = {k: p.clone() for k, p in params.items()}
    opt.update_(grads, opt_state, new_params, mask)
    return new_params, opt_state


class ClientRunner:
    """Shared state of all simulated clients on one device
    (``device=None`` -> ``"cuda"``)."""

    def __init__(self, model: Model, fl: FLConfig, data: FederatedData,
                 resources: ResourceModel, device: DeviceLike = None):
        self.model = model
        self.fl = fl
        self.data = data
        self.resources = resources
        self.device = resolve_device(device)
        self.opt = make_optimizer(fl.optimizer, fl.lr, fl.weight_decay)
        self._masks: Dict[int, Tensors] = {}      # k -> mask dict
        self._active: Dict[int, float] = {}       # k -> active param count

    def loss_and_grads(self, params: Tensors, batch) -> Tuple[torch.Tensor,
                                                              Tensors]:
        """(loss, grads) of the train loss at ``params``; the loss stays
        on the device."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with torch.enable_grad():
            loss, _ = self.model.train_loss(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def mask_for(self, params: Tensors, k: int):
        if k not in self._masks:
            self._masks[k] = freezing.mask_tree(params, self.model.cfg, k)
            self._active[k] = freezing.count_active(params, self._masks[k])
        return self._masks[k], self._active[k]

    def sample_batch(self, client_id: int, b: int):
        """The client's next microbatch, moved to the device once."""
        batch = self.data.batch(client_id, b, self.fl.seq_len)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _check_device(self, params: Tensors) -> None:
        for name, t in params.items():
            if t.device.type != self.device.type:
                raise ValueError(f"parameter {name} is on {t.device}, the "
                                 f"runner on {self.device}")

    def train_client(self, client_id: int, params: Any, knobs: Knobs
                     ) -> ClientResult:
        """LocalTrain for one client. Losses stay on the device until the
        single host sync at the end."""
        params = as_params(params)
        self._check_device(params)
        mask, active = self.mask_for(params, knobs.k)
        opt_state = self.opt.init(params)
        w = params
        losses = []
        for _ in range(knobs.s):
            # the step's microbatches, drawn in the order they are used
            with telemetry.span("fl.draw"):
                batches = [self.sample_batch(client_id, knobs.b)
                           for _ in range(knobs.grad_accum)]
            with telemetry.span("fl.step"):
                grads_sum = None
                for batch in batches:
                    loss, grads = self.loss_and_grads(w, batch)
                    losses.append(loss)
                    if grads_sum is None:
                        grads_sum = grads
                    else:
                        grads_sum = {k: a + grads[k]
                                     for k, a in grads_sum.items()}
                if knobs.grad_accum > 1:
                    # 0-d f32 divisor (small ints are exact in f32)
                    accum = torch.tensor(np.float32(knobs.grad_accum),
                                         device=self.device)
                    grads_sum = {k: g / accum for k, g in grads_sum.items()}
                w, opt_state = apply_masked_update_(self.opt, w, opt_state,
                                                    grads_sum, mask)

        topk = self.fl.wire_topk
        with telemetry.span("fl.wire"):
            delta = finalize_delta(w, params, mask, knobs.q, topk=topk)
            wire_mb = _masked_wire_mb(delta, mask, knobs.q, topk=topk)
        train_loss = float(torch.mean(torch.stack(losses)))  # one sync/client
        return ClientResult(
            client_id=client_id, delta=delta, params_active=active,
            train_loss=train_loss, wire_mb_actual=wire_mb)

    def local_train(self, client_id: int, params: Any, knobs: Knobs
                    ) -> Tuple[Tensors, Dict[str, float], Dict[str, float]]:
        """(delta, usage, metrics) with usage from the runner's resource
        model."""
        r = self.train_client(client_id, params, knobs)
        usage = self.resources.usage(r.params_active, knobs)
        usage_true = self.resources.usage(r.params_active, knobs,
                                          include_accum=True)
        metrics = {
            "train_loss": r.train_loss,
            "params_active": r.params_active,
            "wire_mb_actual": r.wire_mb_actual,
            "energy_true": usage_true["energy"],
            "temp_true": usage_true["temp"],
        }
        return r.delta, usage, metrics


@torch.no_grad()
def finalize_delta(w: Tensors, params: Tensors, mask: Tensors, q: int,
                   topk=None) -> Tensors:
    """Client update as shipped: fp32 difference, wire-compressed (q knob,
    optional top-k; the server immediately dequantizes), frozen leaves
    exact zeros either way. Each leaf goes through the wire kernels on
    its own (CUDA leaves) or their plain versions (CPU leaves)."""
    delta = {k: a.to(torch.float32) - params[k].to(torch.float32)
             for k, a in w.items()}
    delta = compression.compress_decompress(delta, q, topk=topk)
    return freezing.apply_mask(delta, mask)


#: one accounting unit is 2**-11 byte: the finest grain the wire formats
#: produce (1/2048 byte/param for the per-block scale share), so per-param
#: costs below are exact integers
_UNIT_BYTES = 2.0 ** -11
#: dense per-param unit costs by q (4 B, 1+1/64 B, 1/4+1/64 B — the +1/64
#: is the fp32 block scale amortized over a 256-wide block)
_DENSE_UNITS = {0: 8192, 1: 2080, 2: 544}


def _masked_wire_mb(delta: Tensors, mask: Tensors, q: int, topk=None) -> float:
    """Actual bytes: only trainable leaves ship (exact-integer active
    counts; the per-block formulas mirror compression.wire_bytes)."""
    units = 0
    for name, leaf in delta.items():
        m_arr = mask[name].cpu().numpy()
        if m_arr.ndim:
            # each nonzero mask entry governs leaf.size/mask.size params
            n = int(np.count_nonzero(m_arr)) * (
                int(np.prod(leaf.shape)) // m_arr.size)
        else:
            n = int(np.prod(leaf.shape)) * int(m_arr.item())
        if q == 0 or topk is None or topk >= 256:
            units += n * _DENSE_UNITS[q]
        else:
            bits = 8 if q == 1 else 2
            # per param: topk*bits/256 code bits + 1 bitmask bit
            # + 32/256 scale bits == (topk*bits + 288) units
            units += n * (topk * bits + 288)
    return compression.to_mb(units * _UNIT_BYTES)


# ---------------------------------------------------------------------------
# trace-analysis entry points (repro_torch.analysis.trace)
# ---------------------------------------------------------------------------

#: the two operating points the static memory gate compares: the FedAvg
#: baseline batch (calibration: its traced peak *defines* Table 1's 0.31
#: memory units, as core.resources.calibrate does) and the CAFL-L
#: adapted batch, which is gated against Budgets.memory
TRACE_BASELINE_B = 32
TRACE_ADAPTED_B = 8


def _local_step(runner: ClientRunner, params: Tensors, opt_state,
                batch, mask: Tensors):
    """One full local step (grad + masked update) as one program: the
    unit whose peak the static memory gate prices."""
    loss, grads = runner.loss_and_grads(params, batch)
    new_params, opt_state = apply_masked_update_(runner.opt, params,
                                                 opt_state, grads, mask)
    return loss, new_params, opt_state


def _local_step_build(b: int):
    def build():
        from repro_torch.analysis.trace.registry import charlm_trace_setup
        runner, params, batch = charlm_trace_setup(b=b)
        mask, _ = runner.mask_for(params, 0)
        opt_state = runner.opt.init(params)
        step = functools.partial(_local_step, runner)
        return step, (params, opt_state, batch, mask)
    return build


def _grad_step_build():
    from repro_torch.analysis.trace.registry import charlm_trace_setup
    runner, params, batch = charlm_trace_setup(b=TRACE_ADAPTED_B)
    return runner.loss_and_grads, (params, batch)


def _update_step_build():
    from repro_torch.analysis.trace.registry import charlm_trace_setup
    runner, params, _ = charlm_trace_setup(b=TRACE_ADAPTED_B)
    mask, _ = runner.mask_for(params, 0)
    opt_state = runner.opt.init(params)
    gen = torch.Generator().manual_seed(2)
    grads = {k: 1e-3 * torch.randn(p.shape, generator=gen, dtype=p.dtype)
             for k, p in params.items()}
    return (functools.partial(apply_masked_update_, runner.opt),
            (params, opt_state, grads, mask))


def trace_entry_points() -> List[Any]:
    """Declared traceable surfaces of the client update path."""
    from repro_torch.analysis.trace.registry import EntryPoint, anchor
    local = anchor(_local_step)
    return [
        EntryPoint(
            name="fl.client_grad_step", **anchor(ClientRunner.loss_and_grads),
            build=_grad_step_build,
            note="loss and gradients of the char-LM train loss"),
        EntryPoint(
            name="fl.client_update_step", **anchor(apply_masked_update_),
            build=_update_step_build, donatable=(1, 2),
            note="masked optimizer step; opt-state and grads in place"),
        EntryPoint(
            name="fl.client_local_step", **local,
            build=_local_step_build(TRACE_ADAPTED_B), donatable=(1,),
            gated=True,
            note=f"grad + update at adapted b={TRACE_ADAPTED_B}"),
        EntryPoint(
            name="fl.client_local_step@baseline", **local,
            build=_local_step_build(TRACE_BASELINE_B), donatable=(1,),
            calibration=True,
            note=f"grad + update at baseline b={TRACE_BASELINE_B}"),
    ]
