"""Dry-run: one train, prefill or decode step of each (arch x input
shape) on one H100, traced on fake tensors (nothing is allocated), with
its memory, FLOPs, bytes and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The port's counterpart of ``repro.launch.dryrun``, which lowers and
compiles each step for 256 or 512 TPU chips and reads the HLO. Here the
step runs eagerly under ``FakeTensorMode`` on the CPU's route, with one
exception: attention without a gradient (prefill, the encoder-decoder's
cross-attention at decode) is the flash kernel on the card, so the trace
replaces ``ops.flash_attention`` by an opaque op of the kernel's output
shape, which holds no (Sq, Sk) scores and is counted as the kernel's
products over the pairs its mask admits. Then:

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, the matmul and
  convolution products (``dot_flops``, the roofline's compute term);
  ``flops`` adds one per output element of every other op, as the
  reference's HLO walker does for its non-dot ops;
- bytes: every aten op's tensor inputs read once and outputs written
  once (views move nothing; a broadcast input counts its distinct
  elements), the counterpart of the reference's unfused HLO bytes;
- memory: ``MemTracker``'s peak, split into the arguments (parameters,
  optimizer state, batch or caches) and the temporaries above them.

Results go to ``results/dryrun/<arch>__<shape>__h100.json`` (``$DRYRUN_DIR``
or ``--out`` elsewhere; an existing file is kept unless ``--force``) with
the reference's keys, ``fits_h100_80gb`` in place of ``fits_v5e_16gb``,
and zero collectives; the ``hlo_*`` roofline keys keep the reference's
names and hold the aten counts. ``RESULTS_DIR=results python -m
benchmarks.roofline`` reads them.

Most records take seconds to a minute. xLSTM's sLSTM steps once per
token on the host and each step's ops run under the fake mode (~0.2 s
a token of prefill on one CPU core), so its ``prefill_32k`` record
takes about two hours and its ``train_4k`` about one.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional, Union

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     make_mesh)
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import build
from repro_torch.optim import make_optimizer

RESULTS_DIR = os.environ.get("DRYRUN_DIR", "results/dryrun")
MESH_NAME = "h100"


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: a broadcast
    (stride 0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class _Traffic(TorchDispatchMode):
    """Per aten op: the bytes of its tensor inputs and outputs, and its
    output elements (the elementwise estimate of non-product ops)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.elements = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        self.ops += 1
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_distinct_bytes, ins + outs))
        self.elements += sum(t.numel() for t in outs)
        return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_stand_in(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int]) -> torch.Tensor:
    """The flash kernel in a trace: an opaque op with its output's shape
    (B, Sq, H, Dv) and no workspace, as the kernel holds its tiles on
    chip; the plain twin would hold the (Sq, Sk) scores."""
    raise RuntimeError("the flash stand-in runs on fake tensors only")


@_flash_stand_in.register_fake
def _(q, k, v, causal, window):
    return q.new_empty(tuple(q.shape[:-1]) + (v.shape[-1],))


def _attended_pairs(sq: int, sk: int, causal: bool,
                    window: Optional[int]) -> int:
    """(query, key) pairs the kernel's mask admits: every pair without
    ``causal``; else query i (top-left aligned) sees keys
    max(0, i - window + 1) .. i."""
    if not causal:
        return sq * sk
    seen = np.minimum(np.arange(1, sq + 1), sk)
    if window is not None:
        seen = np.minimum(seen, window)
    return int(seen.sum())


def _flash_flops(q_shape, k_shape, v_shape, causal, window, out_shape=None):
    b, sq, h, dq = q_shape
    return 2 * b * h * _attended_pairs(sq, k_shape[1], causal, window) * (
        dq + v_shape[-1])


def _flash_via_stand_in(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    return _flash_stand_in(q, k, v, causal, window)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode: D = new tokens only."""
    n = build(cfg).param_count()["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def _fake(tree):
    """Meta tensors -> fake CPU tensors of the same shapes and dtypes
    (call under the fake mode)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cpu")
                    if isinstance(t, torch.Tensor) else t, tree)


def _step_and_args(cfg: ModelConfig, shape: InputShape, opt_name: str,
                   microbatches: int):
    """(step, its arguments as fake tensors); call under the fake mode."""
    model = build(cfg)
    params = _fake(model.init(None, "meta").params())
    if shape.kind == "train":
        optimizer = make_optimizer(opt_name, 1e-4)
        step = make_train_step(model, optimizer, microbatches=microbatches)
        return step, (params, optimizer.init(params),
                      _fake(S.input_specs(cfg, shape)))
    if shape.kind == "prefill":
        return (make_prefill_step(model, shape),
                (params, _fake(S.input_specs(cfg, shape))))
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32)
    return make_decode_step(model), (params, _fake(S.cache_specs(
        model, cfg, shape)), tokens)


def analyze(cfg: ModelConfig, shape: InputShape, opt_name: str = "adamw",
            microbatches: int = 1) -> dict:
    """Trace one step on fake tensors -> the record's measured part."""
    with FakeTensorMode():
        step, args = _step_and_args(cfg, shape, opt_name, microbatches)
        arg_tensors = [t for t in tree_leaves(args)
                       if isinstance(t, torch.Tensor)]
        arg_bytes = sum({t.untyped_storage()._cdata: t.untyped_storage()
                         .nbytes() for t in arg_tensors}.values())
        tracker = MemTracker()
        tracker.track_external(*arg_tensors)
        flops = FlopCounterMode(display=False, custom_mapping={
            torch.ops.repro_torch.flash_attention: _flash_flops})
        traffic = _Traffic()
        real_flash, ops.flash_attention = (ops.flash_attention,
                                           _flash_via_stand_in)
        try:
            with tracker, flops, traffic:
                step(*args)
        finally:
            ops.flash_attention = real_flash
    peak = max(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    dot = float(flops.get_total_flops())
    return {"n_chips": 1,
            "memory": {"argument_size_in_bytes": int(arg_bytes),
                       "temp_size_in_bytes": int(max(peak - arg_bytes, 0)),
                       "per_device_total_gb": peak / 1e9,
                       "fits_h100_80gb": bool(peak < HBM_BYTES)},
            "cost": {"flops": dot + traffic.elements, "dot_flops": dot,
                     "bytes": float(traffic.bytes), "aten_ops": traffic.ops},
            "collectives": {"bytes_per_device": {}, "counts": {},
                            "total_bytes_per_device": 0}}


def roofline(rec: dict, cfg: ModelConfig, shape: InputShape) -> dict:
    """The roofline terms at the H100's rates (``launch.mesh``)."""
    dot, total = rec["cost"]["dot_flops"], rec["cost"]["flops"]
    nbytes = rec["cost"]["bytes"]
    mf = model_flops(cfg, shape)
    out = {"hlo_flops_per_device": dot,
           "hlo_flops_with_elementwise": total,
           "hlo_bytes_per_device": nbytes,
           "collective_bytes_per_device": 0,
           "t_compute_s": dot / PEAK_FLOPS_BF16,
           "t_memory_s": nbytes / HBM_BW,
           "t_collective_s": 0.0,
           "model_flops_total": mf,
           "model_flops_per_device": mf,
           "useful_flops_ratio": mf / dot if dot else None}
    terms = {k: out[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    out["dominant"] = max(terms, key=terms.get)
    return out


def run_one(arch: Union[str, ModelConfig], shape: Union[str, InputShape],
            out_dir: str = RESULTS_DIR, force: bool = False,
            opt_name: str = "adamw") -> dict:
    """One record, written to ``<out_dir>/<arch>__<shape>__h100.json``;
    ``arch`` and ``shape`` by name or as objects (a config's ``name``
    and a shape's ``name`` name the file)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{cfg.name}__{shape.name}__{MESH_NAME}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": MESH_NAME,
           "status": "error", "layers": cfg.num_layers,
           "global_batch": shape.global_batch, "seq_len": shape.seq_len}
    t0 = time.perf_counter()
    try:
        rec.update(analyze(cfg, shape, opt_name))
        rec["roofline"] = roofline(rec, cfg, shape)
        rec["status"] = "ok"
        rec["trace_s"] = time.perf_counter() - t0
        print(f"OK  {cfg.name:24s} {shape.name:12s} {MESH_NAME} "
              f"trace {rec['trace_s']:6.1f}s "
              f"mem {rec['memory']['per_device_total_gb']:8.2f}GB "
              f"dom={rec['roofline']['dominant']}", flush=True)
    except Exception as e:   # the matrix run records the failure, goes on
        rec["error"] = traceback.format_exc()
        print(f"ERR {cfg.name:24s} {shape.name:12s} {MESH_NAME}: {e!r}",
              flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Trace one step of each (arch x shape) on fake tensors "
        "and write its H100 roofline record. Seconds to a minute a record, "
        "but xLSTM's prefill_32k takes about two hours and its train_4k "
        "about one (its sLSTM steps once per token).")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi"],
                    help="single / multi: not ported (ROADMAP item 13c)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    make_mesh(args.mesh)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    n_ok = n_err = 0
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, out_dir=args.out, force=args.force,
                          opt_name=args.opt)
            n_ok += rec.get("status") == "ok"
            n_err += rec.get("status") != "ok"
    print(f"done: {n_ok} ok, {n_err} errors")


if __name__ == "__main__":
    main()
