#!/usr/bin/env python3
"""Where the PyTorch port's time goes on one CUDA card, under torch.profiler.

    python3 scripts/profile_port.py [--k 4 --b 31 --q 2 --grad-accum 2]

Prints JSON lines:

- ``device``: the card's name and power limit (nvidia-smi).
- ``kernel_device``: the device time of each wire kernel per client delta
  of the full-width char-LM (one launch over the delta's 16 leaves
  staged into one buffer, as ``finalize_delta`` runs it; bits 2, k 64),
  averaged over 20 deltas, beside ``torch.mul``'s (the dequantizer's
  library call) and the device time of all kernels of ``torch.topk``
  over |x| (a selection-only yardstick for the top-k kernel).
- ``profile``: one client's LocalTrain at the given knobs (5 local
  steps): wall time per microbatch without the profiler, per step part
  (grad, masked AdamW, the wire round trip) with a synchronize around
  each, and the device's busy share and top kernels under the profiler.
- ``masked_fold``: one full-width round's masked-sum fold (6 clients x
  1,900,800 uint64): the device time under the profiler of the uint64
  entry (``masked_sum_u64``, the main path's) and of the limb entry
  (``masked_sum_limbs``) beside ``torch.sum`` over int64's, and
  ``ops.masked_sum_u64``'s host-clock time,
  whole and split into its steps (copy the values' bits to the card,
  kernel, copy the sums back).
- ``flash``: the flash-attention kernel at the main path's shapes
  (``chip_smoke.FLASH_TIMED``: Gemma2's global and local layers,
  Phi-3.5-MoE's, DeepSeek-V3's MLA, RecurrentGemma's local layer and
  SeamlessM4T's encoder layer in prefill, bf16; SeamlessM4T's decode
  cross-attention, Sq 1 over Sk 4,096; the char-LM eval, B = 64, S = 32
  and 128, f32): its device time per launch under the profiler (5
  launches at Sq >= 4,096, 20 otherwise) and, in the same process, the
  median CUDA-event time of one call as ``chip_smoke.py`` takes it, the
  share of the bound (``chip_smoke.flash_bound_ms``) in the device time,
  and at Sq >= 4,096 the SM clock and power draw right after each
  window.
- ``engine_round``: ``--engine-rounds`` CAFL-L rounds of
  ``FederatedEngine`` on the card with each aggregator ("sync", then
  "masked"), each round split at the engine's own callback hooks (with a
  synchronize at each): eval, LocalTrain plus aggregation, accounting;
  the aggregator's ``submit`` / ``flush`` time is taken out of the
  middle part as ``aggregate_s``.
- ``train_split``: one full-width train step (``make_train_step``) of
  Gemma2-9B, Phi-3.5-MoE, RecurrentGemma-2B and SeamlessM4T at
  ``chip_smoke.py``'s train setting (``train_setting``: depth cut to
  fit, 2 x 4,096 tokens in 2 microbatches, AdamW, the mask at k = 1),
  after one warm-up step: host-clock seconds of the step, and under the
  profiler (one more step) its device time, busy share, device ops, the
  shares of GEMMs, copies, reductions and elementwise kernels, and the
  top kernels.
- ``executor_round`` (last): one LocalTrain round of a full cohort (6
  clients) at the given knobs with each executor, ``sequential`` then
  ``batched`` (same-knob clients stacked under ``torch.func.vmap``):
  host-clock seconds per round over 3 rounds after a warm-up one, and
  under the profiler the device's busy share, the kernel launches per
  client microbatch and the top kernels.

The default knobs are those ``chip_smoke.py``'s second round runs at
(q = 2 from the comm dual). ``chip_smoke.py`` checks the port; this
script only measures it. Needs one card and the CUDA toolkit; imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (FLASH_TIMED, SUM_TIMED, TRAIN_K,  # noqa: E402
                        TRAIN_LR, TRAIN_MICROBATCHES, TRAIN_BATCH, check,
                        device_kernels, device_split, emit, flash_bound_ms,
                        flash_inputs, full_width, nvidia_smi_line,
                        smi_clocks, time_ms, train_setting)

#: the train steps ``train_split`` profiles: a dense stack with softcaps,
#: MoE, the recurrent scan, the encoder-decoder
TRAIN_PROFILED = ("gemma2-9b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
                  "seamless-m4t-medium")
#: kernel kinds of ``train_split``'s shares, by a name's first match
#: (the rest: "other")
TRAIN_KINDS = {"gemm": ("gemm", "nvjet", "cutlass", "xmma"),
               "copy": ("Memcpy", "Memset", "copy_kernel"),
               "reduce": ("reduce_kernel", "softmax", "Softmax"),
               "elementwise": ("elementwise", "Functor"),
               "other": ()}


def kernel_device_us(fn, names, reps: int = 20, what: str = "") -> float:
    """Device time per call of ``fn`` of the one kernel whose name holds
    one of ``names`` (a kernel name or a tuple of them)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    _, kernels = device_kernels(fn, reps)
    us = [t for key, (_, t) in kernels.items()
          if any(f"{name}_kernel" in key or name in key for name in names)
          and not ("quantize_blocks" in names and "dequantize" in key)]
    check(len(us) == 1, f"profiler saw no single {names} kernel in "
          f"{reps} calls {what}: {sorted(kernels)}")
    return us[0]


def wire_kernel_device_us(leaves, bits: int = 2, k: int = 64) -> dict:
    from repro_torch.core.compression import stage_blocks
    from repro_torch.kernels import quantize, wire
    buf, _ = stage_blocks(leaves)
    codes, scales = quantize.quantize_blocks(buf, bits)
    out = torch.empty_like(buf)
    return {
        "quantize_blocks": kernel_device_us(
            lambda: quantize.quantize_blocks(buf, bits), "quantize_blocks"),
        "dequantize_blocks": kernel_device_us(
            lambda: quantize.dequantize_blocks(codes, scales, out=out),
            "dequantize_blocks"),
        "dequantize_library_mul": kernel_device_us(
            lambda: torch.mul(codes, scales[:, None], out=out),
            ("mul", "elementwise")),
        "quantize_topk_blocks": kernel_device_us(
            lambda: wire.quantize_topk_blocks(buf, bits, k),
            "quantize_topk_blocks"),
        "topk_selection_library": sum(
            us for _, us in device_kernels(
                lambda: torch.topk(buf.abs(), k, dim=1, sorted=False),
                reps=20)[1].values()),
    }


def flash_times(dev) -> dict:
    """The flash kernel at each timed shape: device us per launch under
    the profiler, and the CUDA-event ms of one call, in one process, with
    the bound's share of the device time (and at S = 8192 the SM clock
    and power draw right after each window)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import KERNELS
    gen = torch.Generator(device=dev).manual_seed(22)
    out = {}
    for (label, b, sq, sk, h, kvh, d, dtype, causal, window,
         softcap) in FLASH_TIMED:
        q, k, v = flash_inputs(gen, b, sq, h, kvh, d, dtype, dev, sk=sk)

        def call():
            return ops.flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap)

        big = sq >= 4096
        row = {"device_us": kernel_device_us(call, KERNELS.values(),
                                             reps=5 if big else 20,
                                             what=label)}
        if big:
            row["device_clocks"] = smi_clocks()
        row["event_ms"] = time_ms(call, reps=10 if big else 30)
        if big:
            row["event_clocks"] = smi_clocks()
        bound_ms, _ = flash_bound_ms(q, k, window,
                                     torch.cuda.get_device_name(0), causal)
        row["bound_ms"] = bound_ms
        row["bound_share_of_device"] = bound_ms * 1e3 / row["device_us"]
        out[label] = row
    return out


def synced() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


def masked_fold(dev) -> dict:
    """One full-width round's fold: both entries' device time and the
    host-clock steps of ``ops.masked_sum_u64``."""
    from repro_torch.kernels import ops, wire
    c, n = SUM_TIMED
    vals = np.random.default_rng(12).integers(0, 2 ** 64, size=(c, n),
                                              dtype=np.uint64)
    stacked = torch.from_numpy(vals.view(np.int64)).to(dev)
    hi, lo = (torch.from_numpy(x).to(dev) for x in ops.split_limbs(vals))
    device_us = kernel_device_us(lambda: wire.masked_sum_u64(stacked),
                                 "masked_sum_u64")
    limbs_device_us = kernel_device_us(lambda: wire.masked_sum_limbs(hi, lo),
                                       "masked_sum_limbs")
    library_device_us = kernel_device_us(lambda: torch.sum(stacked, dim=0),
                                         "reduce_kernel")
    ops.masked_sum_u64(vals, device=dev)                     # warm up
    steps = {}

    def step(name, fn):
        t0 = synced()
        out = fn()
        steps[name] = synced() - t0
        return out

    bits = step("to_card_s",
                lambda: torch.from_numpy(vals.view(np.int64)).to(dev))
    total = step("kernel_s", lambda: wire.masked_sum_u64(bits))
    total = step("to_host_s", lambda: total.cpu().numpy().view(np.uint64))
    again = step("masked_sum_u64_s",
                 lambda: ops.masked_sum_u64(vals, device=dev))
    check(np.array_equal(total, again)
          and np.array_equal(again, np.add.reduce(vals, axis=0)),
          "masked fold steps disagree")
    return {"phase": "masked_fold", "clients": c, "columns": n,
            "kernel_device_us": device_us,
            "limbs_kernel_device_us": limbs_device_us,
            "library_sum_device_us": library_device_us, **steps}


def engine_rounds(dev, rounds: int) -> list:
    """CAFL-L through ``FederatedEngine`` with each aggregator, each
    round split at the engine's callback hooks."""
    from repro_torch.configs import get_config, get_fl_config
    from repro_torch.data import load_corpus
    from repro_torch.fl import FederatedEngine, RoundCallback
    from repro_torch.models import build

    class PhaseTimer(RoundCallback):
        def __init__(self):
            self.rows, self.row, self.t = [], {}, {}

        def on_round_start(self, engine, rnd):
            self.row = {"round": rnd, "aggregate_s": 0.0}
            self.t["start"] = synced()

        def on_round_composed(self, engine, plan):
            self.t["composed"] = synced()
            self.row["eval_s"] = self.t["composed"] - self.t["start"]

        def on_server_update(self, engine, update):
            self.t["updated"] = synced()
            self.row["train_and_aggregate_s"] = (self.t["updated"]
                                                 - self.t["composed"])

        def on_round_end(self, engine, record):
            end = synced()
            self.row["accounting_s"] = end - self.t["updated"]
            self.row["round_s"] = end - self.t["start"]
            self.rows.append(self.row)

    def timed(fn, timer):
        def run(*args):
            t0 = synced()
            out = fn(*args)
            timer.row["aggregate_s"] += synced() - t0
            return out
        return run

    ds = load_corpus()
    cfg = get_config("charlm-shakespeare")
    if cfg.vocab_size < ds.vocab_size:
        cfg = cfg.replace(vocab_size=ds.vocab_size)
    fl = get_fl_config().replace(rounds=rounds)
    out = []
    for aggregator in ("sync", "masked"):
        timer = PhaseTimer()
        engine = FederatedEngine(build(cfg), fl, ds, strategy="cafl",
                                 aggregator=aggregator, callbacks=[timer],
                                 device=dev)
        agg = engine.aggregator
        agg.submit, agg.flush = timed(agg.submit, timer), timed(agg.flush,
                                                                timer)
        result = engine.run()
        for row, rec in zip(timer.rows, result.history):
            row = {"phase": "engine_round", "aggregator": aggregator,
                   "knobs": rec.knobs, **row}
            row["local_train_s"] = (row["train_and_aggregate_s"]
                                    - row["aggregate_s"])
            emit(row)
            out.append(row)
    return out


def profile_client(model, fl, ds, params, kn) -> dict:
    from repro_torch.core import calibrate
    from repro_torch.core.client import (ClientRunner, apply_masked_update,
                                         finalize_delta)
    from repro_torch.core.freezing import count_params
    from repro_torch.data import FederatedData

    data = FederatedData(ds.train, fl.num_clients, seed=fl.seed)
    runner = ClientRunner(model, fl, data,
                          calibrate(count_params(params), fl), device="cuda")
    micro = kn.s * kn.grad_accum

    def sync_time(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    runner.train_client(1, params, kn)                       # warm up
    wall, _ = sync_time(lambda: runner.train_client(1, params, kn))
    mask, _ = runner.mask_for(params, kn.k)
    batch = runner.sample_batch(1, kn.b)
    t_grad, (_, grads) = sync_time(lambda: runner.loss_and_grads(params,
                                                                 batch))
    state = runner.opt.init(params)
    t_adam, _ = sync_time(lambda: apply_masked_update(runner.opt, params,
                                                      state, grads, mask))
    t_wire, _ = sync_time(lambda: finalize_delta(params, params, mask, kn.q))
    prof_wall, kernels = device_kernels(
        lambda: runner.train_client(1, params, kn))
    busy_us = sum(t for _, t in kernels.values())
    check(busy_us > 0, "the profiler saw no device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    return {"phase": "profile", "knobs": kn.as_dict(), "microbatches": micro,
            "client_s": wall, "per_microbatch_ms": wall / micro * 1e3,
            "grad_ms": t_grad * 1e3, "adamw_ms": t_adam * 1e3,
            "finalize_delta_ms": t_wire * 1e3,
            "profiled_client_s": prof_wall, "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / prof_wall,
            "kernel_launches": sum(n for n, _ in kernels.values()),
            "top_kernels": [{"name": name[:80], "launches": n, "us": t}
                            for name, (n, t) in top]}


def executor_rounds(model, fl, ds, params, kn, reps: int = 3) -> list:
    """One cohort's LocalTrain round with each executor: host-clock
    seconds per round, then the profiler's view of one more round."""
    from repro_torch.core import calibrate
    from repro_torch.core.client import ClientRunner
    from repro_torch.core.freezing import count_params
    from repro_torch.data import FederatedData
    from repro_torch.fl import ClientInfo, DeviceProfile, make_executor

    resources = calibrate(count_params(params), fl)
    profile = DeviceProfile("default", fl.budgets, resources=resources)
    micro = fl.clients_per_round * kn.s * kn.grad_accum
    rows = []
    for name in ("sequential", "batched"):
        data = FederatedData(ds.train, fl.num_clients, seed=fl.seed)
        runner = ClientRunner(model, fl, data, resources, device="cuda")
        executor = make_executor(name, runner)
        assignments = [(ClientInfo(c, profile, data.shard_size(c)), kn)
                       for c in range(fl.clients_per_round)]

        def run():
            return executor.run_round(params, assignments)

        run()                                               # warm up
        walls = []
        for _ in range(reps):
            t0 = synced()
            run()
            walls.append(synced() - t0)
        prof_wall, kernels = device_kernels(run)
        busy_us = sum(t for _, t in kernels.values())
        check(busy_us > 0, "the profiler saw no device time")
        launches = sum(n for n, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        row = {"phase": "executor_round", "executor": name,
               "knobs": kn.as_dict(), "clients": fl.clients_per_round,
               "microbatches": micro, "round_s": walls,
               "per_microbatch_ms": min(walls) / micro * 1e3,
               "profiled_round_s": prof_wall,
               "device_busy_s": busy_us / 1e6,
               "device_busy_share": busy_us / 1e6 / prof_wall,
               "kernel_launches": launches,
               "launches_per_microbatch": launches / micro,
               "top_kernels": [{"name": n[:80], "launches": c, "us": t}
                               for n, (c, t) in top]}
        emit(row)
        rows.append(row)
    return rows


def train_split(dev) -> list:
    """``train_split`` rows (see the module docstring)."""
    from repro_torch.core.freezing import mask_tree
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw

    rows = []
    for arch in TRAIN_PROFILED:
        cfg, seq, published = train_setting(arch)
        torch.cuda.empty_cache()
        model = build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dev).params()
        opt = adamw(TRAIN_LR)
        state = opt.init(params)
        mask = mask_tree(params, cfg, TRAIN_K)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 synthetic_batch(cfg, TRAIN_BATCH, seq, seed=7).items()}
        step = make_train_step(model, opt, True, TRAIN_MICROBATCHES)
        params, state, _ = step(params, state, batch, mask)      # warm-up
        t0 = synced()
        params, state, _ = step(params, state, batch, mask)
        step_s = synced() - t0
        split = device_split(lambda: step(params, state, batch, mask),
                             top=1 << 20)[1]
        kernels = split.pop("top_kernels")
        shares = {kind: 0.0 for kind in TRAIN_KINDS}
        for name, us in kernels:
            kind = next((kind for kind, keys in TRAIN_KINDS.items()
                         if any(key in name for key in keys)), "other")
            shares[kind] += us / split["device_us"]
        row = {"phase": "train_split", "config": cfg.name,
               "layers": f"{cfg.num_layers} of {published}",
               "batch": [TRAIN_BATCH, seq], "step_s": step_s,
               "busy_share": split["device_us"] / 1e6 / step_s, **split,
               "shares": shares, "top_kernels": kernels[:8]}
        emit(row)
        rows.append(row)
        del params, state, batch, step
    return rows


def main(argv=None) -> int:
    from repro_torch.core import Knobs
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--b", type=int, default=31)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--engine-rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    emit({"phase": "device", "nvidia_smi": nvidia_smi_line(),
          "name": torch.cuda.get_device_name(0)})
    cfg, fl, ds, model, leaves = full_width(dev)
    params = model.init(torch.Generator().manual_seed(fl.seed), dev).params()
    kn = Knobs(k=args.k, s=args.steps, b=args.b, q=args.q,
               grad_accum=args.grad_accum)
    emit({"phase": "kernel_device", "bits": 2, "k": 64,
          "device_us": wire_kernel_device_us(leaves)})
    emit(profile_client(model, fl, ds, params, kn))
    emit(masked_fold(dev))
    emit({"phase": "flash", "times": flash_times(dev)})
    engine_rounds(dev, args.engine_rounds)
    train_split(dev)
    # last: its sequential round traces ~89k kernels
    executor_rounds(model, fl, ds, params, kn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
