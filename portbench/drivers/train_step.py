"""The train step: ``launch.steps.make_train_step`` of Phi-3.5-MoE under
a freezing mask, AdamW, closed loop (a step starts when the last ended).

Set-up builds the step, its model and its optimizer state once (the
weights are the benchmark's, from the seed) and drives it through its
first ``setup_steps`` steps, each on rows of its own drawn from the
seed (``moe_train.batch``); the reference follows those steps. They
also warm up every shape the window uses. For the check it keeps each
step's loss, each leaf's first gradient as the optimizer got it (its
first moment after one step, over 1 - b1), each leaf's change after
the set-up steps (against the seed's weights, drawn again), and the
program's expert choices in every layer of every slice (``Routes``,
the forward's calls; a recomputed unit routes again in the backward).
The same step, state and parameters then run the window until
``--seconds`` have passed (a traced run: ``trace_steps`` steps). The
rate is every step's tokens over the time to the end of the last step.

After the window the reference follows the set-up steps in fp32 from
the same weights and inputs, along the program's expert choices, and
the check compares each step's loss, the worst leaf's first-gradient
norm and change norm (``compare.norm_gap``), and the widest routing
margin (``moe_lm.moe``).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench import counts
from portbench.drivers.prefill import Routes, port_config
from portbench.reference import moe_train, weights
from portbench.reference.compare import leaf_norms, norm_gap, rel_gap


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.config["model"]
        self.t = ctx.traffic
        self.seen: Dict = {"loss": [], "routes": []}
        self.routes = None

    def _step(self, params, state, index: int):
        t, ctx = self.t, self.ctx
        rows = t["rows"] // 2 if ctx.fault == "half_batch" else t["rows"]
        b = moe_train.batch(self.m, ctx.seed, index, t["rows"], t["seq"],
                            ctx.device)
        b = {k: v[:rows] for k, v in b.items()}
        return self.step(params, state, b, self.mask)

    def run(self):
        from repro_torch.core.freezing import mask_tree
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import build
        from repro_torch.optim import adamw
        ctx, t, m = self.ctx, self.t, self.m
        cfg = port_config(m)
        model = build(cfg)
        params = weights.make_weights(m, ctx.seed, ctx.device)
        opt = adamw(t["lr"], weight_decay=t["weight_decay"])
        if ctx.fault == "unchanged":         # a step that moves nothing
            opt = opt._replace(update_=lambda g, s, p, mask=None: (p, s))
        state = opt.init(params)
        self.mask = mask_tree(params, cfg, t["mask_k"])
        mb = t["microbatches"] // (2 if ctx.fault == "half_batch" else 1)
        self.step = make_train_step(model, opt, True, mb)
        self.routes = Routes()
        for s in range(t["setup_steps"]):
            self.routes.calls = []
            params, state, loss = self._step(params, state, s)
            self.seen["loss"].append(float(loss))
            self.seen["routes"].append(self._forward_routes(mb))
            if s == 0:
                self.seen["grad"] = {k: v / (1 - moe_train.B1) for k, v in
                                     leaf_norms(state.mu, m).items()}
        self.routes.calls = None
        with torch.no_grad():
            self.seen["change"] = moe_train.change_norms(
                params, m, ctx.seed, ctx.device)
        ctx.open_window()
        n, end = 0, None
        while True:
            params, state, loss = self._step(params, state,
                                             t["setup_steps"] + n)
            n += 1
            if not math.isfinite(float(loss)):
                self.seen["nonfinite"] = True
            end = time.perf_counter()
            if n >= t["trace_steps"] if ctx.trace else ctx.window_over(end):
                break
        ctx.close_window()
        self.params = self.state = None
        del params, state
        tokens = n * t["rows"] * t["seq"]
        layers = m["num_layers"]
        k = max(1, min(t["mask_k"], layers))
        ctx.counters["steps"] = n
        ctx.counts["model_flops"] = n * counts.train_flops(
            m, t["rows"], t["seq"], [i >= layers - k for i in range(layers)],
            head_trainable=True)
        return {"e2e": {"train_tokens_per_s": tokens / (end
                                                        - ctx.window_start)},
                "attempted": n}

    def _forward_routes(self, microbatches: int) -> List[List]:
        """A step's recorded choices -> per slice, the forward's (one a
        layer): a slice routes once a layer forward, and again in the
        backward for each unit it recomputes."""
        calls, layers = self.routes.calls, self.m["num_layers"]
        per = len(calls) // microbatches
        return [[c.cpu() for c in calls[j * per:j * per + layers]]
                for j in range(microbatches)]

    def release(self) -> None:
        if self.routes is not None:
            self.routes.close()
        self.step = self.mask = None

    def check(self):
        ctx = self.ctx
        ref = moe_train.follow(self.m, self.t, ctx.seed, ctx.device,
                               routes=self.seen["routes"])
        values = readings(self.seen, ref, self.m)
        limits = self.t["limits"]
        self.read_only = {k: v for k, v in values.items() if k not in limits}
        failed = int(bool(self.seen.get("nonfinite")))
        return {k: {"value": values[k], "limit": v}
                for k, v in limits.items()}, failed


def readings(prog: Dict, ref: Dict, model: Dict) -> Dict[str, float]:
    """Program (or control) against reference: the widest relative gap
    of a set-up step's loss; the worst leaf's first-gradient norm gap
    and change norm gap (``norm_gap``: leaves whose reference gradient
    is under a thousandth of the median leaf's left out); the widest
    margin by which a choice the program's router took lies below the
    reference's k-th best (``route_gap``); the largest change of a leaf
    the reference leaves unmoved (the frozen ones: exactly 0)."""
    n = len(ref["loss"])
    losses = prog["loss"][:n] + [math.inf] * (n - len(prog["loss"]))
    return {
        "loss_gap": max(rel_gap(p, r) for p, r in zip(losses, ref["loss"])),
        "grad_norm_gap": norm_gap(prog["grad"], ref["grad"], ref["grad"]),
        "change_norm_gap": norm_gap(prog["change"], ref["change"],
                                    ref["grad"]),
        "route_gap": ref["route_gap"],
        "frozen_change": max([prog["change"].get(k, math.inf)
                              for k, v in ref["change"].items() if v == 0]
                             or [0.0]),
    }
