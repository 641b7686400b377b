#!/usr/bin/env python3
"""Times each of the port's hand-written kernels alone on one CUDA card:
every time column of PERF.md §6's kernel table, from one command.

    python3 scripts/profile_port.py

Prints JSON lines:

- ``device``: the card's name and power limit (nvidia-smi).
- ``kernel``, one a kernel and shape. Columns: ``ms``, the median
  CUDA-event time of one call, timed in turns with ``library_ms``'s call
  where one PyTorch call computes the same function; ``host_us``, the
  wrapper's own host cost a call (the host-clock time to issue ~1,000
  calls in a row, the card synchronised before and after the window);
  ``device_us``, the kernel's device time a call under torch.profiler;
  ``plain_ms``, its plain PyTorch version's CUDA-event time; ``bound_ms``
  and ``bound_by``, the least time the card could take (bytes over the
  memory rate or operations over the dtype's rate, the larger; the
  card's data-sheet rates, ``CARD_RATES``). The kernels:
  - the three wire kernels per client delta of the full-width char-LM
    (one launch over the delta's 16 leaves staged into one buffer of
    7,428 blocks, as ``compress_decompress`` runs it; bits 2, k 64). The
    dequantizer writes into a given buffer, as the main path does, and is
    timed in turns with ``torch.mul(..., out=)`` (``library_ms``) and the
    allocating ``torch.mul`` (``library_alloc_ms``); the top-k quantizer
    in turns with ``torch.topk`` over |x| (``selection_library_ms``: it
    selects only, so it is not ``library_ms``);
  - both entries of the masked-sum fold at one full-width round (6
    clients x 1,900,800 uint64): the uint64 one (the main path's) and the
    limb one (the TPU function's contract), in turns with ``torch.sum``
    over int64; host us from 100 calls;
  - the flash kernel at each of the main path's shapes
    (``chip_smoke.FLASH_TIMED``), in turns with SDPA where no softcap
    makes it another function (a window as a boolean mask), and at
    Gemma2's shapes beside SDPA without the softcap (``sdpa_no_softcap_ms``:
    another function); host us from 20 calls at Sq >= 4,096, where the SM
    clock and power draw right after the timed window are also read;
  - the fused AdamW kernel at the expert leaves of one full-width
    Phi-3.5-MoE layer (``adamw_leaf``), beside ``torch._fused_adamw_``
    in fp32 as the library's yardstick only.

It only times: ``chip_smoke.py`` and the ``cuda`` tests check the port on
the card, and ``portbench/`` measures the system. Needs one card and the
CUDA toolkit; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (BLOCK, FLASH_SOURCE, FLASH_TIMED,  # noqa: E402
                        SOURCE, SUM_TIMED, TRAIN_LR, check,
                        check_masked_mean, emit, flash_inputs, full_width,
                        masked_round, nvidia_smi_line, train_setting)

#: per-card data-sheet rates (NVIDIA, dense, no sparsity): device-memory
#: bytes/s, fp32 (non-tensor-core) operations/s and bf16 tensor-core
#: operations/s
CARD_RATES = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),        # SXM
}


def card_rates(name: str):
    """Data-sheet rates of the card ``name``; raises for a card without
    an entry, so no bound is computed from another card's peaks."""
    for key, rates in CARD_RATES.items():
        if all(part in name for part in key.split()):
            return rates
    raise RuntimeError(f"no data-sheet rates for {name!r}: add it to "
                       f"CARD_RATES")


def bound(bytes_: float, ops: float, bw: float, rate: float):
    """The least time the card could take: the larger of ``bytes_`` over
    the memory rate and ``ops`` over the compute rate -> (ms, by)."""
    t_bytes, t_ops = bytes_ / bw * 1e3, ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def smi_clocks() -> dict:
    """The card's SM clock (MHz) and power draw (W) now, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    clock, power = out.stdout.strip().splitlines()[0].split(",")
    return {"clocks_sm_mhz": float(clock), "power_draw_w": float(power)}


def host_us(fn, calls: int = 1000) -> float:
    """The host's cost of one call of ``fn``: the host-clock time to issue
    ``calls`` calls in a row, per call, with the card synchronised before
    and after the window (the closing synchronize is not counted)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / calls * 1e6


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median wall time of ``fn`` on the card, from CUDA events."""
    return time_turns_ms(fn, reps=reps, warmup=warmup)[0]


def time_turns_ms(*fns, reps: int = 100, warmup: int = 3):
    """Median CUDA-event time of each of ``fns``, timed in turns (each
    round in the other order: a b, b a, ...) so that drift in the host's
    state falls on all of them alike: a kernel against its library call."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for i in range(reps):
        order = range(len(fns)) if i % 2 == 0 else reversed(range(len(fns)))
        for j in order:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[j]()
            end.record()
            end.synchronize()
            times[j].append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def device_kernels(fn, reps: int = 1) -> dict:
    """Run ``fn`` ``reps`` times under torch.profiler -> {kernel name:
    (launches, device us)} for the CUDA kernels it ran, averaged per
    repetition. A window in which the tracer delivered no device activity
    at all (seen once on the card, between two windows that traced) is
    taken once more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {e.key: (e.count / reps, e.self_device_time_total / reps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
        if out:
            break
    return out


def kernel_device_us(fn, names, reps: int = 20, what: str = "") -> float:
    """Device time per call of ``fn`` of the one kernel whose name holds
    one of ``names`` (a kernel name or a tuple of them)."""
    names = (names,) if isinstance(names, str) else tuple(names)
    kernels = device_kernels(fn, reps)
    us = [t for key, (_, t) in kernels.items()
          if any(f"{name}_kernel" in key or name in key for name in names)
          and not ("quantize_blocks" in names and "dequantize" in key)]
    check(len(us) == 1, f"profiler saw no single {names} kernel in "
          f"{reps} calls {what}: {sorted(kernels)}")
    return us[0]


def kernel_row(name: str, fn, plain, bound_ms_by, *, device_names=None,
               calls: int = 1000, device_reps: int = 20,
               plain_reps: int = 30, plain_warmup: int = 3,
               **columns) -> dict:
    """A ``kernel`` line: ``columns`` (``ms`` and the library's among
    them), then ``fn``'s host us and device us a call, ``plain``'s
    CUDA-event ms and the bound."""
    bound_ms, bound_by = bound_ms_by
    return {"phase": "kernel", "name": name, "route": "cuda", **columns,
            "host_us": host_us(fn, calls),
            "device_us": kernel_device_us(fn, device_names or name,
                                          reps=device_reps, what=name),
            "plain_ms": time_ms(plain, reps=plain_reps, warmup=plain_warmup),
            "bound_ms": bound_ms, "bound_by": bound_by}


def wire_records(leaves, card_name: str) -> list:
    """The three wire kernels per client delta (the module docstring)."""
    from repro_torch.core.compression import stage_blocks
    from repro_torch.kernels import quantize, ref, wire
    bw, fp32_rate, _ = card_rates(card_name)
    buf, _ = stage_blocks(leaves, BLOCK)
    n, nb = buf.numel(), buf.shape[0]                 # padded values, blocks
    bits, k = 2, 64
    codes, scales = quantize.quantize_blocks(buf, bits)
    out = torch.empty_like(buf)

    def quant():
        return quantize.quantize_blocks(buf, bits)

    def dequant():
        return quantize.dequantize_blocks(codes, scales, out=out)

    def mul():
        return torch.mul(codes, scales[:, None], out=out)

    def topk():
        return wire.quantize_topk_blocks(buf, bits, k)

    def select():
        return torch.topk(buf.abs(), k, dim=1, sorted=False)

    common = {"source": SOURCE, "values": n, "blocks": nb,
              "leaves": len(leaves), "launches_per_delta": 1, "bits": bits,
              "k": k}
    deq_ms, library, library_alloc = time_turns_ms(
        dequant, mul, lambda: torch.mul(codes, scales[:, None]))
    topk_ms, selection = time_turns_ms(topk, select)
    return [
        # read x, write codes + scales; ~6 fp32 ops a value (abs, max,
        # divide, rint, two clamps)
        kernel_row("quantize_blocks", quant,
                   lambda: ref.quantize_blocks_ref(buf, bits),
                   bound(n * 4 + n + nb * 4, 6 * n, bw, fp32_rate),
                   replaces="src/repro/kernels/quantize.py:47",
                   ms=time_ms(quant), library_ms=None, **common),
        # read codes + scales, write f32; one multiply a value
        kernel_row("dequantize_blocks", dequant,
                   lambda: ref.dequantize_blocks_ref(codes, scales),
                   bound(n + nb * 4 + n * 4, n, bw, fp32_rate),
                   replaces="src/repro/kernels/quantize.py:65", ms=deq_ms,
                   library_ms=library, library_alloc_ms=library_alloc,
                   library_device_us=kernel_device_us(
                       mul, ("mul", "elementwise")), **common),
        # read x, write codes + mask + scales; the quantizer's ~6 ops a
        # value and a few to select k of a block (a compare with the k-th
        # magnitude and a tie count: 2). No PyTorch call computes it;
        # torch.topk over |x| selects only, with its own tie order
        kernel_row("quantize_topk_blocks", topk,
                   lambda: ref.quantize_topk_blocks_ref(buf, bits, k),
                   bound(n * 4 + 2 * n + nb * 4, 8 * n, bw, fp32_rate),
                   plain_reps=5, plain_warmup=1,
                   replaces="src/repro/kernels/wire.py:84", ms=topk_ms,
                   library_ms=None, selection_library_ms=selection,
                   selection_library_device_us=sum(
                       us for _, us in device_kernels(select, 20).values()),
                   **common)]


def masked_sum_records(dev, card_name: str) -> list:
    """Both masked-sum entries at one full-width round's fold (the module
    docstring): [the uint64 entry, the limb entry]."""
    from repro_torch.kernels import ops, ref, wire
    bw = card_rates(card_name)[0]
    c, n = SUM_TIMED
    vals = np.random.default_rng(12).integers(0, 2 ** 64, size=(c, n),
                                              dtype=np.uint64)
    hi, lo = (torch.from_numpy(x).to(dev) for x in ops.split_limbs(vals))
    stacked = torch.from_numpy(vals.view(np.int64)).to(dev)

    def u64():
        return wire.masked_sum_u64(stacked)

    def limbs():
        return wire.masked_sum_limbs(hi, lo)

    def library():
        return torch.sum(stacked, dim=0)

    u64_ms, limbs_ms, library_ms = time_turns_ms(u64, limbs, library)
    # read C x n uint64 (as values or as limbs), write n uint64. Host us
    # from 100 calls, which stay inside the launch queue: 1,000 calls of a
    # ~34 us kernel may outrun the card and wait on it
    fold = bound(8 * c * n + 8 * n, 0, bw, 1.0)
    common = {"source": SOURCE, "replaces": "src/repro/kernels/wire.py:130",
              "clients": c, "columns": n, "library_ms": library_ms,
              "library_device_us": kernel_device_us(library,
                                                    "reduce_kernel")}
    return [
        kernel_row("masked_sum_u64", u64,
                   lambda: ref.masked_sum_u64_ref(stacked), fold, calls=100,
                   entry="uint64 bits (the main path)", ms=u64_ms, **common),
        kernel_row("masked_sum_limbs", limbs,
                   lambda: ref.masked_sum_ref(hi, lo), fold, calls=100,
                   entry="(hi, lo) uint32 limbs", ms=limbs_ms, **common)]


def masked_round_host(dev, model) -> dict:
    """The host side of one full-width masked round
    (``chip_smoke.masked_round``) on the host clock, for ``wire_ab.py``
    (no column of the kernel table): each of 6 clients'
    ``submit`` (fixed point + 5 pairwise masks of 1.9M uint64) and the
    ``flush`` (stack, the fold's copies and launch, the mean back on the
    card)."""
    agg, reports, params = masked_round(dev, model)
    submit_s = []
    for report in reports:
        t0 = time.perf_counter()
        agg.submit(report)
        submit_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    update = agg.flush(1)
    torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    return {"phase": "masked_host", "clients": len(reports),
            "columns": sum(t.numel() for t in params.values()),
            "submit_s": submit_s, "flush_s": flush_s,
            "round_host_s": sum(submit_s) + flush_s,
            "mean_max_abs_err": check_masked_mean(update, params)}


def flash_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """Unmasked (q, k) pairs of one (batch, head): the work this input
    needs."""
    q = np.arange(sq)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def sdpa_call(q, k, v, window, causal: bool = True):
    """SDPA on (B,S,H,D) tensors, causal or not (and banded by ``window``
    through a boolean mask), without a softcap, as a function of no
    arguments."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = k.shape[2] != q.shape[2]
    if window is None:
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=gqa)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - window))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=gqa)


def flash_records(dev, card_name: str) -> list:
    """The flash kernel at each of the main path's shapes (the module
    docstring). Its bound: q, k, v read once and the output written once
    over the memory rate, or 4 D operations per unmasked pair over the
    rate of its dtype (bf16 tensor cores, fp32 CUDA cores)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import KERNELS, variant
    bw, fp32_rate, bf16_rate = card_rates(card_name)
    gen = torch.Generator(device=dev).manual_seed(22)
    rows = []
    for (label, b, sq, sk, h, kvh, d, dtype, causal, window,
         softcap) in FLASH_TIMED:
        q, k, v = flash_inputs(gen, b, sq, h, kvh, d, dtype, dev, sk=sk)
        kw = dict(causal=causal, window=window, softcap=softcap)

        def kernel():
            return ops.flash_attention(q, k, v, **kw)

        big = sq >= 4096
        columns = {"source": FLASH_SOURCE,
                   "replaces": "src/repro/kernels/flash_attention.py:90",
                   "variant": variant(q.dtype, d), "shape": label,
                   "batch": b, "seq": sq, "seq_k": sk, "heads": h,
                   "kv_heads": kvh, "head_dim": d, "dtype": dtype, **kw}
        if softcap is None:
            # the same function in one PyTorch call: timed in turns
            columns["ms"], columns["library_ms"] = time_turns_ms(
                kernel, sdpa_call(q, k, v, window, causal),
                reps=10 if big else 100)
        else:
            columns["ms"] = time_ms(kernel, reps=10 if big else 100)
            columns["library_ms"] = None
        if big:
            columns.update(smi_clocks())
            if softcap is not None:
                columns["sdpa_no_softcap_ms"] = time_ms(
                    sdpa_call(q, k, v, window, causal), reps=10)
        bytes_ = q.element_size() * (2 * q.numel() + 2 * k.numel())
        ops_ = 4 * b * h * d * flash_pairs(sq, sk, causal, window)
        rate = bf16_rate if q.dtype == torch.bfloat16 else fp32_rate
        row = kernel_row(
            "flash_attention_bhsd", kernel,
            lambda: ref.flash_attention_ref(q, k, v, **kw),
            bound(bytes_, ops_, bw, rate), device_names=KERNELS.values(),
            calls=20 if big else 1000, device_reps=5 if big else 20,
            plain_reps=3 if big else 30, plain_warmup=1, **columns,
            bytes=bytes_, operations=ops_, ops_per_s=rate)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["bound_share_of_device"] = row["bound_ms"] * 1e3 / row["device_us"]
        rows.append(row)
    return rows


def adamw_leaf(dev, card_name: str) -> dict:
    """The fused AdamW kernel at the expert leaves of one full-width
    Phi-3.5-MoE layer (16 x 3 x 4,096 x 6,400: bf16 weights, fp32
    gradients and moments, a 0-d mask of 1, decay 0.1; one launch a
    leaf, as ``update_`` runs it): the kernel's device time under the
    profiler, the CUDA-event time of the step, the plain piece path's
    (``ref.adamw_update_ref`` on the card), the bound (24 bytes an
    element), the wrapper's host cost (at 4,096 elements) and, as the
    library's yardstick only, ``torch._fused_adamw_`` over the same
    elements in fp32 (28 bytes an element) with its own bound."""
    from repro_torch.kernels import ops, ref
    bw = card_rates(card_name)[0]
    cfg = train_setting("phi3.5-moe-42b-a6.6b")[0]
    d, f, e = cfg.d_model, cfg.moe.d_ff_expert, cfg.moe.num_experts
    shapes = [(e, d, f), (e, d, f), (e, f, d)]
    gen = torch.Generator(device=dev).manual_seed(29)
    hyper = dict(lr=TRAIN_LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                 piece=1 << 26)
    count = torch.ones((), dtype=torch.int32, device=dev)
    bc = ref.adamw_corrections(count, hyper["b1"], hyper["b2"])
    mask = torch.tensor(1.0, device=dev)

    def leaves(n=None):
        out = []
        for shape in shapes if n is None else [(n,)]:
            p = (torch.randn(shape, generator=gen, device=dev) * 0.02
                 ).to(torch.bfloat16)
            g = torch.randn(shape, generator=gen, device=dev) * 1e-3
            out.append((g, p, torch.zeros(shape, device=dev),
                        torch.zeros(shape, device=dev)))
        return out

    def kernel(tree):
        return lambda: [ops.adamw_update_(*t, mask, count,
                                          corrections=lambda: bc, **hyper)
                        for t in tree]

    tree = leaves()
    n = sum(t[1].numel() for t in tree)
    row = {"phase": "kernel", "name": "adamw_update", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/optim_kernels.cu",
           "shapes": shapes, "elements": n,
           "device_us": kernel_device_us(kernel(tree), "adamw_update",
                                         reps=5, what="adamw"),
           "ms": time_ms(kernel(tree), reps=10),
           "plain_ms": time_ms(lambda: [ref.adamw_update_ref(
               *t, mask, count, **hyper) for t in tree], reps=5),
           "bound_ms": n * 24 / bw * 1e3, "bound_by": "bytes"}
    del tree
    row["host_us"] = host_us(kernel(leaves(4096)))
    torch.cuda.empty_cache()
    lib = [[torch.randn(s, generator=gen, device=dev) for s in shapes]
           for _ in range(4)]
    steps = [torch.ones((), device=dev) for _ in shapes]
    row["library_fp32_ms"] = time_ms(lambda: torch._fused_adamw_(
        *lib, [], steps, lr=TRAIN_LR, beta1=0.9, beta2=0.999,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False), reps=10)
    row["library_fp32_bound_ms"] = n * 28 / bw * 1e3
    del lib
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    from repro_torch.device import resolve_device

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": nvidia_smi_line(), "name": name})
    for records in (lambda: wire_records(full_width(dev)[4], name),
                    lambda: masked_sum_records(dev, name),
                    lambda: flash_records(dev, name),
                    lambda: [adamw_leaf(dev, name)]):
        for row in records():
            emit(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
