"""The federated round: ``FederatedEngine.run`` of CAFL-L over a cohort.

Set-up builds the engine once (the corpus and the weights are the
benchmark's, from the seed; the duals start where the traffic file
says) and runs its first ``setup_rounds`` rounds through the same
``run`` call that the window continues: the reference follows those
rounds. The window is the rounds that end within ``--seconds`` of its
start; the benchmark's callback stops the engine at the first round end
past it, and that round is not counted (a traced run stops after
``trace_rounds``). The rate is every client's training tokens (s x
grad_accum x b x seq) of the counted rounds over their wall time, eval,
wire, aggregation and the dual step included.

Spans (the benchmark's own): ``round`` from the engine's round start to
its end, ``localtrain`` around the executor's ``run_round``. A traced
run also counts the host syncs of each window round
(``SyncGuardCallback``) and the model FLOPs and wire bytes the window
needed (``portbench.counts``).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from portbench import counts
from portbench.reference import fl as ref_fl, weights
from portbench.reference.compare import (leaf_norms, median_gap, norm_gap,
                                        rel_gap)
from portbench.reference.corpus import corpus


class _StopWindow(Exception):
    pass


def _fl_config(fl_base, fl: Dict, seed: int):
    from repro_torch.configs.base import Budgets, DualConfig
    b = fl["budgets"]
    return fl_base.replace(
        num_clients=fl["num_clients"],
        clients_per_round=fl["clients_per_round"], rounds=10 ** 6,
        k_base=fl["k_base"], s_base=fl["s_base"], b_base=fl["b_base"],
        seq_len=fl["seq_len"], lr=fl["lr"], optimizer="adamw",
        weight_decay=fl["weight_decay"], seed=seed, method="cafl",
        eval_batches=fl["eval_batches"],
        eval_batch_size=fl["eval_batch_size"], executor="batched",
        aggregator="sync", time_mode="rounds",
        budgets=Budgets(energy=b["energy"], comm_mb=b["comm"],
                        memory=b["memory"], temp=b["temp"]),
        duals=DualConfig(**fl["duals"]))


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model_cfg = ctx.config["model"]
        self.fl = ctx.config["fl"]
        t = ctx.traffic
        self.setup_rounds = t["setup_rounds"]
        self.trace_rounds = t["trace_rounds"]
        self.seen: List[Dict] = []          # the set-up rounds' outputs
        self.window_rounds: List[Dict] = []
        self.engine = self.at_open = self.last_round = None

    # ------------------------------------------------------------------
    def _model(self):
        """The program's char-LM at the configuration file's sizes."""
        from repro_torch.configs.charlm_shakespeare import CONFIG
        from repro_torch.models import build
        m = self.model_cfg
        return build(CONFIG.replace(**{k: m[k] for k in (
            "num_layers", "d_model", "num_heads", "num_kv_heads",
            "head_dim", "d_ff", "vocab_size", "learned_pos_emb",
            "rope_theta")}))

    def run(self):
        from repro_torch.configs.charlm_shakespeare import FL
        from repro_torch.core.duals import DualState
        from repro_torch.data.shakespeare import CharDataset
        from repro_torch.fl import FederatedEngine
        from repro_torch.fl.callbacks import RoundCallback
        from repro_torch.fl.executor import BatchedExecutor
        ctx, dev = self.ctx, self.ctx.device
        train, val, vocab, chars = corpus()
        stoi = {c: i for i, c in enumerate(chars)}
        ds = CharDataset(train=train, val=val, vocab_size=vocab, stoi=stoi,
                         itos={i: c for c, i in stoi.items()})
        model = self._model()
        flc = _fl_config(FL, self.fl, ctx.seed)
        init = weights.make_weights(self.model_cfg, ctx.seed, dev)
        self.p0 = {k: v.clone() for k, v in init.items()}
        self.prev = self.p0
        driver = self

        class Timed:
            """The batched executor with a span around each round of
            LocalTrain (and, in tests, a planted fault)."""

            def __init__(self, runner):
                self.inner = BatchedExecutor(runner)
                if ctx.fault == "half_batch":
                    data, full = runner.data, runner.data.batch
                    data.batch = lambda c, b, s: {
                        k: v[:b // 2] for k, v in full(c, b, s).items()}

            def run_round(self, params, assignments):
                with ctx.span("localtrain"):
                    outs = self.inner.run_round(params, assignments)
                if ctx.fault == "unchanged":
                    for o in outs:
                        o.delta = {k: torch.zeros_like(v)
                                   for k, v in o.delta.items()}
                driver._account(assignments)
                return outs

        class Window(RoundCallback):
            def on_round_start(self, engine, rnd):
                self.t0 = time.perf_counter()

            def on_round_end(self, engine, rec):
                driver._round_end(engine, rec, self.t0, time.perf_counter())

        callbacks = [Window()]
        self.guard = None
        if ctx.trace and dev.type == "cuda":
            from repro_torch.analysis.runtime import SyncGuardCallback
            self.guard = SyncGuardCallback(from_round=self.setup_rounds + 1)
            callbacks.insert(0, self.guard)
        self.engine = FederatedEngine(
            model, flc, ds, strategy="cafl", executor=Timed,
            init_duals=DualState(lam=dict(ctx.traffic["init_duals"])),
            callbacks=callbacks, device=dev)
        try:
            self.engine.run(init_params=init)
        except _StopWindow:
            pass
        finally:
            if self.guard is not None:
                self.guard.close()
        result = self._result()
        if self.guard is not None:
            ctx.count("host_syncs", sum(sum(s.values()) for r, s in
                                        self.guard.per_round.items()
                                        if r <= self._last_counted))
        return result

    # ------------------------------------------------------------------
    def _account(self, assignments) -> None:
        """Tokens, model FLOPs and wire bytes of one round's LocalTrain."""
        m, seq = self.model_cfg, self.fl["seq_len"]
        tokens = flops = wire = 0
        sizes = [v.numel() for v in self.p0.values()]
        for _, kn in assignments:
            steps = kn.s * kn.grad_accum
            tokens += steps * kn.b * seq
            layers = m["num_layers"]
            trainable = [i >= layers - max(1, min(kn.k, layers))
                         for i in range(layers)]
            flops += steps * counts.train_flops(
                m, kn.b, seq, trainable, head_trainable=kn.k >= layers)
            if kn.q:
                wb = counts.wire_bytes(sizes)
                wire += wb["quantize"] + wb["dequantize"]
        self._pending = {"tokens": tokens, "flops": flops, "wire": wire}

    def _round_end(self, engine, rec, t0, t1) -> None:
        ctx = self.ctx
        r = rec.round
        if r <= self.setup_rounds:
            with torch.no_grad():
                params = engine.params
                self.seen.append({
                    "val_loss": rec.val_loss, "train_loss": rec.train_loss,
                    "knobs": dict(rec.knobs), "duals": dict(rec.duals),
                    "update": leaf_norms({k: params[k] - self.prev[k]
                                          for k in params}, self.model_cfg),
                    "change": leaf_norms({k: params[k] - self.p0[k]
                                          for k in params}, self.model_cfg)})
                self.prev = {k: v.clone() for k, v in params.items()}
            if r == self.setup_rounds:
                self.at_open = self.prev
                self.prev = None
                ctx.open_window()
            return
        ctx.spans.setdefault("round", []).append((t0, t1))
        # what the check reads of a window round: the last counted one
        # is known only once the window has closed, so the last few are
        # kept (the parameters after each: 7.6 MB)
        self.window_rounds.append(dict(
            self._pending, end=t1, round=r, val_loss=rec.val_loss,
            train_loss=rec.train_loss, knobs=dict(rec.knobs),
            duals=dict(rec.duals),
            params={k: v.detach().clone() for k, v in engine.params.items()}))
        for old in self.window_rounds[:-3]:
            old.pop("params", None)
        done = (len(self.window_rounds) >= self.trace_rounds if ctx.trace
                else ctx.window_over(t1))
        if done:
            ctx.close_window()
            raise _StopWindow

    def _result(self):
        ctx = self.ctx
        rounds = self.window_rounds
        # rounds that ended within the window; a window with none counts
        # its first round
        if not ctx.trace:
            inside = [w for w in rounds if w["end"] - ctx.window_start
                      <= ctx.seconds] or rounds[:1]
        else:
            inside = rounds
        self._last_counted = self.setup_rounds + len(inside)
        n = len(inside)
        before = inside[-2]["params"] if n >= 2 else self.at_open
        last = inside[-1]
        self.last_round = {
            "round": last["round"], "start": before,
            "end": last["params"], "val_loss": last["val_loss"],
            "train_loss": last["train_loss"], "knobs": last["knobs"],
            "duals": last["duals"]}
        spans = ctx.spans
        spans["round"] = spans.get("round", [])[:n]
        spans["localtrain"] = spans.get("localtrain", [])[
            self.setup_rounds:self.setup_rounds + n]
        ctx.counters["rounds"] = n
        ctx.counts["model_flops"] = sum(w["flops"] for w in inside)
        ctx.counts["wire_bytes"] = sum(w["wire"] for w in inside)
        seconds = inside[-1]["end"] - ctx.window_start
        tokens = sum(w["tokens"] for w in inside)
        return {"e2e": {"fl_tokens_per_s": tokens / seconds},
                "attempted": n * self.fl["clients_per_round"]}

    def release(self) -> None:
        self.engine = None
        self.p0 = self.at_open = None
        self.window_rounds = []
        lr = self.last_round
        for key in ("start", "end"):
            lr[key] = {k: v.cpu() for k, v in lr[key].items()}

    # ------------------------------------------------------------------
    def check(self):
        """The set-up rounds against the reference's, from the same seed,
        corpus, weights and duals, and the window's last counted round
        against the reference's round from the program's parameters at
        its start (the rounds between are stepped over: cohorts, draws,
        knobs and duals): knobs and duals exactly; each round's val and
        train loss; each leaf's update norm in the first and in the last
        round, and its change after the set-up rounds (the worst leaf;
        leaves the reference's first update leaves at ~0 left out)."""
        ctx = self.ctx
        limits = ctx.traffic["limits"]
        lr, dev = self.last_round, ctx.device
        ref = reference_readings(ctx.config, ctx.traffic, ctx.seed, dev)
        start = {k: v.to(dev, torch.float32) for k, v in lr["start"].items()}
        ref_win = reference_window(ctx.config, ctx.traffic, ctx.seed, dev,
                                   lr["round"], start)
        prog_win = {k: lr[k] for k in ("val_loss", "train_loss", "knobs",
                                       "duals")}
        prog_win["update"] = leaf_norms(
            {k: lr["end"][k].to(dev, torch.float32) - start[k]
             for k in start}, self.model_cfg)
        prog = {"setup": self.seen, "window": prog_win}
        values = readings(prog, {"setup": ref["setup"], "window": ref_win},
                          self.model_cfg)
        self.read_only = {k: v for k, v in values.items() if k not in limits}
        return {k: {"value": values[k], "limit": v}
                for k, v in limits.items()}, 0


@contextlib.contextmanager
def _tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _reduce(r: Dict, before, p0, model: Dict) -> Dict:
    out = {k: r[k] for k in ("val_loss", "train_loss", "knobs", "duals")}
    out["update"] = leaf_norms({k: r["params"][k] - before[k]
                                for k in before}, model)
    if p0 is not None:
        out["change"] = leaf_norms({k: r["params"][k] - p0[k]
                                    for k in p0}, model)
    return out


def reference_readings(config: Dict, traffic: Dict, seed: int, device,
                       tf32: bool = False, half_batch: bool = False
                       ) -> Dict:
    """The reference's set-up rounds -> {"setup": each reduced to what
    ``readings`` reads, "params": the parameters after them}.
    ``tf32`` computes it with TF32 matrix products (the control);
    ``half_batch`` leaves half of each batch out (a fault)."""
    model, fl = config["model"], config["fl"]
    train, val, _, _ = corpus()
    with _tf32(tf32):
        p0 = {k: v.to(torch.float32)
              for k, v in weights.make_weights(model, seed, device).items()}
        rounds = ref_fl.follow(p0, train, val, model, fl, seed,
                               traffic["init_duals"],
                               traffic["setup_rounds"], half_batch)
    out, prev = [], p0
    for r in rounds:
        out.append(_reduce(r, prev, p0, model))
        prev = r["params"]
    return {"setup": out, "params": prev}


def reference_window(config: Dict, traffic: Dict, seed: int, device,
                     index: int, start: Dict, tf32: bool = False,
                     half_batch: bool = False) -> Dict:
    """The reference's round ``index`` (1-based) from the parameters
    ``start`` at its start, the rounds before it stepped over -> the
    round reduced to what ``readings`` reads."""
    model, fl = config["model"], config["fl"]
    train, val, _, _ = corpus()
    with _tf32(tf32):
        (r,) = ref_fl.follow(start, train, val, model, fl, seed,
                             traffic["init_duals"], 1, half_batch,
                             skip=index - 1)
    return _reduce(r, start, None, model)


def readings(prog: Dict, ref: Dict, model: Dict) -> Dict[str, float]:
    """Program (or control) against reference, each {"setup": rounds,
    "window": the last counted round}: knob and dual mismatches; the
    widest relative gap of a round's val loss and of its mean client
    loss; the worst leaf's update norm gap in the first and the last
    round, held against its own norm (``norm_gap``) and against the
    larger of its own and the median leaf's (``median_gap``): a bias of
    192 values moves by a 55th of the median leaf, and at 2 bits a code
    that rounding tips either way swings its own-norm gap; and the worst
    leaf's change after the set-up rounds (``norm_gap``)."""
    ps, rs = prog["setup"] + [prog["window"]], ref["setup"] + [ref["window"]]
    mism = sum(int(p["knobs"] != r["knobs"] or p["duals"] != r["duals"])
               for p, r in zip(ps, rs))
    mism += abs(len(ps) - len(rs))
    first = (prog["setup"][0]["update"], ref["setup"][0]["update"])
    last = (prog["window"]["update"], ref["window"]["update"])
    return {
        "knob_dual_mismatches": float(mism),
        "val_loss_gap": max(rel_gap(p["val_loss"], r["val_loss"])
                            for p, r in zip(ps, rs)),
        "train_loss_gap": max(rel_gap(p["train_loss"], r["train_loss"])
                              for p, r in zip(ps, rs)),
        "update_norm_gap": max(norm_gap(*first, first[1]),
                               norm_gap(*last, last[1])),
        "change_norm_gap": norm_gap(prog["setup"][-1]["change"],
                                    ref["setup"][-1]["change"], first[1]),
        "update_median_gap": max(median_gap(*first, first[1]),
                                 median_gap(*last, last[1])),
    }
