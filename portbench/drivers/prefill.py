"""Prefill: ``launch.steps.make_prefill_step`` to the last logits, one
client, closed loop, batch 1.

Prompt lengths are a fixed set: ``block`` quantiles of the log-uniform
law over [``min_len``, ``max_len``], each block of requests one of them
in an order drawn from the seed, so that every seed serves the same
lengths; token ids are drawn on the card from the seed, uniform over
the vocabulary. Set-up builds the weights from the seed and serves one
request at each end of the length range. The window sends requests one
after another until ``--seconds`` have passed; a request's time to first
token runs from its start to its last-position logits on the host. The
rate is the window's prompt tokens over the time to the end of its last
request; the tail is over every request. A traced run serves
``trace_requests`` requests.

The check reads a sample of the served requests drawn from the seed
over the whole window as it runs (``Sampler``: one at the longest
length, ``check_requests - 1`` of the rest); for those the window keeps
the decode caches the step returns and the program's expert choices in
every layer (``Routes``, a recorder around ``models.moe.route``). After
the window the reference goes over each in fp32, layer by layer,
following the program's choices and judging each by its own router
probabilities (``moe_lm``). It reads, over every checked request: how
far the served token's reference logit lies below the reference's best;
the relative L2 gap of the last logits; the widest routing margin; and
the widest relative gap of any position's keys or values in any layer.
Those with a limit in the traffic file are compared, the rest are
reported beside them.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import counts
from portbench.reference import moe_lm, weights


def lengths(traffic: Dict, seed: int, n: int) -> List[int]:
    """The first ``n`` prompt lengths of a run."""
    blk = traffic["block"]
    lo, hi = math.log(traffic["min_len"]), math.log(traffic["max_len"])
    base = [int(round(math.exp(lo + (hi - lo) * (i + 0.5) / blk)))
            for i in range(blk)]
    rng = np.random.default_rng(seed)
    out: List[int] = []
    while len(out) < n:
        out += [base[i] for i in rng.permutation(blk)]
    return out[:n]


def prompt(mcfg: Dict, seed: int, i: int, length: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(weights._seed_of(seed, "prompt", i))
    return torch.randint(0, mcfg["vocab_size"], (1, length), generator=gen,
                         device=device, dtype=torch.int64).to(torch.int32)


def port_config(mcfg: Dict):
    """The program's Phi-3.5-MoE at the configuration file's sizes."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.configs.phi3_5_moe import CONFIG
    dt = weights.DTYPES[mcfg["dtype"]]
    return CONFIG.replace(
        num_layers=mcfg["num_layers"], d_model=mcfg["d_model"],
        num_heads=mcfg["num_heads"], num_kv_heads=mcfg["num_kv_heads"],
        head_dim=mcfg["head_dim"], d_ff=mcfg["d_ff_expert"],
        vocab_size=mcfg["vocab_size"], rope_theta=mcfg["rope_theta"],
        param_dtype=dt, compute_dtype=dt,
        moe=MoEConfig(num_experts=mcfg["num_experts"], top_k=mcfg["top_k"],
                      d_ff_expert=mcfg["d_ff_expert"],
                      capacity_factor=mcfg["capacity_factor"],
                      group_size=mcfg["group_size"],
                      aux_loss_weight=mcfg["aux_loss_weight"]))


class Routes:
    """A recorder around the program's ``models.moe.route``: while
    ``on``, each call's expert choices (one per layer, in order) are
    kept, as uint8 on the card. The check's judge follows them."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.inner = moe, moe.route
        self.calls = None
        moe.route = self

    def __call__(self, p, x, cfg):
        r = self.inner(p, x, cfg)
        if self.calls is not None:
            self.calls.append(r.expert.to(torch.uint8))
        return r

    def close(self) -> None:
        if self.moe.route is self:
            self.moe.route = self.inner


class Late:
    """A planted fault (``fault="late"``, tests and ``tools.controls``):
    the program's flash attention output is scaled by 0.9 at every query
    position from ``start`` on."""

    def __init__(self, start: int):
        from repro_torch.kernels import ops
        self.ops, self.inner, self.start = ops, ops.flash_attention, start
        ops.flash_attention = self

    def __call__(self, q, *a, **kw):
        out = self.inner(q, *a, **kw)
        out[:, self.start:] *= 0.9
        return out

    def close(self) -> None:
        if self.ops.flash_attention is self:
            self.ops.flash_attention = self.inner


class Sampler:
    """The requests the check reads, drawn from the seed over the whole
    window as it runs (two reservoirs): one of the requests at the
    longest length, and ``check_requests - 1`` of the others. ``offer``
    is asked before each request is served; a request it drops later is
    let go, so that at most ``check_requests`` are held at a time."""

    def __init__(self, traffic: Dict, seed: int):
        self.longest = max(lengths(traffic, seed, traffic["block"]))
        self.size = {True: 1, False: traffic["check_requests"] - 1}
        self.seen = {True: 0, False: 0}
        self.slots: Dict[bool, List] = {True: [], False: []}
        self.rng = np.random.default_rng([seed, 1])

    def offer(self, i: int, length: int):
        """-> the request index it replaces (None if none), or False if
        request ``i`` is not held."""
        kind = length == self.longest
        self.seen[kind] += 1
        held, size = self.slots[kind], self.size[kind]
        if len(held) < size:
            held.append(i)
            return None
        j = int(self.rng.integers(0, self.seen[kind]))
        if j >= size:
            return False
        out, held[j] = held[j], i
        return out


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.m = ctx.config["model"]
        self.t = ctx.traffic
        self.served: List[Dict] = []
        self.keep: Dict[int, object] = {}
        self.routes = self.late = None

    def _serve(self, i: int, length: int, held: bool = False):
        toks = prompt(self.m, self.ctx.seed, i, length, self.ctx.device)
        if held:
            self.routes.calls = []
        t0 = time.perf_counter()
        logits, caches = self.step(self.params, {"tokens": toks})
        if self.ctx.fault == "token":
            logits = logits.clone()
            logits[..., int(logits.argmax())] -= 1e3
        host = logits[0, 0].cpu()
        t1 = time.perf_counter()
        if held:                           # a request the check reads
            kv = caches["units"]["b0"]
            self.keep[i] = (kv["k"][:, 0], kv["v"][:, 0], self.routes.calls)
            self.routes.calls = None
        return host, t0, t1

    def run(self):
        from repro_torch.configs.base import InputShape
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import build
        ctx, t = self.ctx, self.t
        model = build(port_config(self.m))
        self.params = weights.make_weights(self.m, ctx.seed, ctx.device)
        self.step = make_prefill_step(
            model, InputShape("prefill", t["max_len"], 1, "prefill"))
        self.routes = Routes()
        if ctx.fault == "late":
            self.late = Late(t["late_from"])
        for j, length in enumerate((t["min_len"], t["max_len"])):
            self._serve(-1 - j, length, held=j == 0)
        self.keep = {}
        plan = lengths(t, ctx.seed, t["max_requests"])
        pick = Sampler(t, ctx.seed)
        ctx.open_window()
        for i, length in enumerate(plan):
            out = pick.offer(i, length)
            if out is not None and out is not False:
                del self.keep[out]
            logits, t0, t1 = self._serve(i, length, held=out is not False)
            self.served.append({"i": i, "len": length, "ttft": t1 - t0,
                                "end": t1, "logits": logits})
            if (len(self.served) >= t["trace_requests"] if ctx.trace
                    else ctx.window_over(t1)):
                break
        ctx.close_window()
        n = len(self.served)
        toks = sum(r["len"] for r in self.served)
        ttft = [r["ttft"] for r in self.served]
        m = self.m
        ctx.counters["requests"] = n
        ctx.counts["model_flops"] = sum(
            counts.forward_flops(m, 1, r["len"]) for r in self.served)
        ctx.counts["flash_bound_s"] = m["num_layers"] * sum(
            counts.flash_bound_seconds(r["len"], m["num_heads"],
                                       m["num_kv_heads"], m["head_dim"])
            for r in self.served)
        return {"e2e": {
            "prefill_tokens_per_s": toks / (self.served[-1]["end"]
                                            - ctx.window_start),
            "ttft_ms.p90": 1e3 * float(np.quantile(ttft, 0.9))},
            "attempted": n}

    def release(self) -> None:
        for hook in (self.routes, self.late):
            if hook is not None:
                hook.close()
        self.params = self.step = None
        # the checked requests' caches and routing go to the host, the
        # card is freed
        self.keep = {i: (k.cpu(), v.cpu(), [r.cpu() for r in routes])
                     for i, (k, v, routes) in self.keep.items()}

    def check(self):
        reqs = [r for r in self.served if r["i"] in self.keep]
        ref = reference_outputs(
            self.ctx.config, self.ctx.seed,
            [(r["i"], r["len"]) for r in reqs], self.ctx.device,
            against=[self.keep[r["i"]][:2] for r in reqs],
            routes=[self.keep[r["i"]][2] for r in reqs])
        values = readings([r["logits"] for r in reqs], ref)
        limits = self.t["limits"]
        self.read_only = {k: v for k, v in values.items() if k not in limits}
        return {k: {"value": values[k], "limit": v}
                for k, v in limits.items()}, 0


@torch.no_grad()
def reference_outputs(config: Dict, seed: int, reqs, device,
                      mode: str = "fp32", against=None, routes=None,
                      keep: bool = False) -> Dict:
    """The reference over each (index, length) request, the layers'
    weights drawn again one at a time -> {"logits": last-position logits
    of each, "kv_gap": the widest ``position_gaps`` of keys or values
    against ``against`` (per request (k, v), each (L, S, KVH, D)) over
    the requests, layers and positions, "route_gap": the widest
    ``moe_lm.moe`` gap}. ``routes`` (per request, one (T, K) choice
    tensor a layer) is followed in place of the reference's own top-k;
    with ``keep``, also "kv" and "routes": each request's own (k, v)
    and the choices it took."""
    m = config["model"]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        io = weights.io_weights(m, seed, device, torch.float32)
        xs = [moe_lm.embed(io, prompt(m, seed, i, n, device)[0])
              for i, n in reqs]
        kv_gap = route_gap = 0.0
        kept = [([], [], []) for _ in reqs]
        for layer in range(m["num_layers"]):
            w = weights.layer_weights(m, seed, device, layer, torch.float32)
            for r, x in enumerate(xs):
                given = (None if routes is None else
                         routes[r][layer].reshape(-1, m["top_k"])[:len(x)])
                xs[r], (k, v), rt = moe_lm.block(w, x, m, mode, given)
                route_gap = max(route_gap, rt["route_gap"])
                if against is not None:
                    for mine, theirs in ((k, against[r][0]),
                                         (v, against[r][1])):
                        kv_gap = max(kv_gap, float(position_gaps(
                            theirs[layer].to(device, torch.float32),
                            mine).max()))
                if keep:
                    kept[r][0].append(k.cpu())
                    kept[r][1].append(v.cpu())
                    kept[r][2].append(rt["expert"].to(torch.uint8).cpu())
            del w
        out = {"logits": [moe_lm.head_logits(io, x[-1:], mode)[0].cpu()
                          for x in xs], "kv_gap": kv_gap,
               "route_gap": route_gap}
        if keep:
            out["kv"] = [(torch.stack(k), torch.stack(v))
                         for k, v, _ in kept]
            out["routes"] = [rts for _, _, rts in kept]
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def position_gaps(theirs: torch.Tensor, mine: torch.Tensor) -> torch.Tensor:
    """Each position's relative L2 gap of (S, KVH, D) keys or values,
    against the reference's (``mine``) norm there -> (S,)."""
    num = torch.linalg.vector_norm((theirs - mine).flatten(1), dim=1)
    den = torch.linalg.vector_norm(mine.flatten(1), dim=1).clamp(min=1e-30)
    return num / den


def readings(prog: List[torch.Tensor], ref: Dict) -> Dict[str, float]:
    """Over the checked requests, every one held: the widest gap by
    which a served token's reference logit lies below the reference's
    best; the largest relative L2 gap of the last logits; the widest
    routing margin and the widest position gap of the decode caches
    (``reference_outputs``)."""
    pairs = list(zip(prog, ref["logits"]))
    return {
        "served_logit_gap": max(float(r.max() - r[int(p.argmax())])
                                for p, r in pairs),
        "logit_rel_l2": max(float(torch.linalg.vector_norm(
            p.double() - r.double()) / torch.linalg.vector_norm(r.double()))
            for p, r in pairs),
        "route_gap": ref["route_gap"],
        "cache_gap": ref["kv_gap"]}
