"""Dry-run: one train, prefill or decode step of each (arch x input
shape) on one H100, or on rank 0 of a 256- or 512-card mesh, traced on
fake tensors (nothing is allocated), with its memory, FLOPs, bytes,
collectives and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
        --shape train_4k [--mesh single|multi|both] [--recipe fsdp]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The port's counterpart of ``repro.launch.dryrun``, which lowers and
compiles each step for 256 or 512 TPU chips and reads the HLO. Here the
step runs eagerly under ``FakeTensorMode`` on the CPU's route, with one
exception: attention without a gradient (prefill, the encoder-decoder's
cross-attention at decode) is the flash kernel on the card, so the trace
replaces ``ops.flash_attention`` by an opaque op of the kernel's output
shape, which holds no (Sq, Sk) scores and is counted as the kernel's
products over the pairs its mask admits. On a mesh (``launch.mesh``, a
fake process group) the parameters, optimizer state, batch and caches
are DTensors split by the recipe (``launch.specs``), and what is counted
is rank 0's: its local ops (the counting modes pass DTensor ops on to
the ops DTensor runs on the shards, and skip its sharding propagation's
global-shape inference) and its ``_c10d_functional`` collectives. Then:

- FLOPs: the matmul and convolution products of
  ``torch.utils.flop_counter``'s formulas (``dot_flops``, the roofline's
  compute term); ``flops`` adds one per output element of every other
  op, as the reference's HLO walker does for its non-dot ops;
- bytes: every aten op's tensor inputs read once and outputs written
  once (views move nothing; a broadcast input counts its distinct
  elements), the counterpart of the reference's unfused HLO bytes;
- collectives: per type (the reference's HLO names), each one's result
  bytes and the count, priced at ``launch.mesh.COLLECTIVE_BW``;
- memory: ``MemTracker``'s peak of the rank's storages, split into the
  arguments (parameters, optimizer state, batch or caches) and the
  temporaries above them.

Results go to ``results/dryrun/<arch>__<shape>__<mesh>.json``
(``h100``, ``h100x256`` or ``h100x512``; ``__<recipe>`` added for a
recipe but ``default``; ``$DRYRUN_DIR`` or ``--out`` elsewhere; an
existing file is kept unless ``--force``) with the reference's keys,
``fits_h100_80gb`` in place of ``fits_v5e_16gb``; the ``hlo_*`` roofline
keys keep the reference's names and hold the aten counts.
``RESULTS_DIR=results python -m benchmarks.roofline`` reads them. The
reference's ``--reanalyze`` (from a cached HLO dump) has no counterpart:
there is no HLO to cache.

Most records take seconds to a minute (Gemma2-9B's full-width train_4k
on the 256-card mesh ~1 min, on the 512-card one ~1.5 min). xLSTM's
sLSTM steps once per token on the host and each step's ops run under
the fake mode (~0.2 s a token of prefill on one CPU core, more under
DTensor on a mesh), so its ``prefill_32k`` record takes about two hours
and its ``train_4k`` about one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Union

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import shape_wrapper

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.stand_ins import flash_attention as _flash_stand_in
from repro_torch.kernels.stand_ins import flash_flops as _flash_flops
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (COLLECTIVE_BW, HBM_BW, HBM_BYTES,
                                     PEAK_FLOPS_BF16, mesh_layout, use_mesh)
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


#: ``_c10d_functional`` collectives -> the reference's HLO names
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "broadcast": "collective-permute"}


class _Paused:
    """Set while DTensor's sharding propagation infers an op's global
    output (``ShardingPropagator._propagate_tensor_meta_non_cached`` runs
    the op on fake tensors of the global shapes): those ops are no rank's
    work and no rank's memory, so the counting modes pass them."""
    active = False


@contextlib.contextmanager
def _shape_inference_paused():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, *args, **kwargs):
        prev, _Paused.active = _Paused.active, True
        try:
            return real(self, *args, **kwargs)
        finally:
            _Paused.active = prev

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


class _Traffic(TorchDispatchMode):
    """Per aten op: the bytes of its tensor inputs and outputs, its output
    elements (the elementwise estimate of non-product ops) and its
    products' FLOPs; and per collective (a ``_c10d_functional`` op) its
    result bytes and count. A DTensor op is passed on
    (``NotImplemented``), so that what is counted is the ops DTensor runs
    on this rank's shards; its sharding propagation's shape inference
    (ops on ``meta`` tensors) is not counted."""

    def __init__(self, flop_mapping=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = {**flop_registry, **(flop_mapping or {})}
        self.bytes = 0
        self.elements = 0
        self.ops = 0
        self.dot_flops = 0
        self.coll_bytes = {name: 0 for name in COLLECTIVES.values()}
        self.coll_counts = {name: 0 for name in COLLECTIVES.values()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func.is_view or _Paused.active:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(t.device.type == "meta" for t in ins + outs):
            return out
        name = COLLECTIVES.get(func._overloadpacket.__name__) \
            if func.namespace == "_c10d_functional" else None
        if name is not None:
            self.coll_bytes[name] += sum(t.numel() * t.element_size()
                                         for t in outs)
            self.coll_counts[name] += 1
            return out
        if func.namespace == "_c10d_functional":
            return out                       # wait_tensor
        self.ops += 1
        self.bytes += sum(map(_distinct_bytes, ins + outs))
        self.elements += sum(t.numel() for t in outs)
        count = self.flop_registry.get(func._overloadpacket)
        if count is not None:
            self.dot_flops += count(*args, **(kwargs or {}), out_val=out)
        return out


class _LocalMemTracker(MemTracker):
    """``MemTracker`` of the tensors a rank holds: a DTensor op is passed
    on, so that the local ops DTensor runs are the ones tracked (it would
    count a DTensor at its global size)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _Paused.active:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _flash_via_stand_in(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    if ops._is_dtensor(q):
        return ops.attention_local(_flash_via_stand_in, q, k, v,
                                   causal=causal, window=window,
                                   softcap=softcap, scale=scale)
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
                   microbatches: int, mesh=None, recipe: str = "default"):
    """(step, its arguments as fake tensors); call under the fake mode.
    On a mesh the arguments are DTensors of fake local shards, split by
    the recipe (``launch.specs``): parameters and the optimizer state by
    ``param_shardings``, the batch by ``batch_shardings``, the caches by
    ``cache_shardings``."""
    model = build(cfg)

    def place(tree, shardings):
        if mesh is None:
            return _fake(tree)
        return S.distribute(tree, shardings(tree), mesh)

    params = place(model.init(None, "meta").params(),
                   lambda t: S.param_shardings(mesh, t, cfg, recipe))

    def batch(tree):
        return place(tree, lambda t: S.batch_shardings(mesh, t, shape))

    if shape.kind == "train":
        optimizer = make_optimizer(opt_name, 1e-4)
        step = make_train_step(model, optimizer, microbatches=microbatches)
        return step, (params, optimizer.init(params),
                      batch(S.input_specs(cfg, shape)))
    if shape.kind == "prefill":
        return (make_prefill_step(model, shape),
                (params, batch(S.input_specs(cfg, shape))))
    tokens = batch(S.sds((shape.global_batch, 1), torch.int32))
    caches = place(S.cache_specs(model, cfg, shape),
                   lambda t: S.cache_shardings(mesh, t, cfg, shape))
    return make_decode_step(model), (params, caches, tokens)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def analyze(cfg: ModelConfig, shape: InputShape, opt_name: str = "adamw",
            microbatches: int = 1, mesh=None,
            recipe: str = "default") -> dict:
    """Trace one step on fake tensors -> the record's measured part: of
    the one card, or of rank 0 of ``mesh`` (its local ops, storages and
    collectives)."""
    with FakeTensorMode():
        step, args = _step_and_args(cfg, shape, opt_name, microbatches,
                                    mesh, recipe)
        arg_tensors = [_local(t) for t in tree_leaves(args)
                       if isinstance(t, torch.Tensor)]
        arg_bytes = sum({t.untyped_storage()._cdata: t.untyped_storage()
                         .nbytes() for t in arg_tensors}.values())
        tracker = _LocalMemTracker()
        tracker.track_external(*arg_tensors)
        traffic = _Traffic({torch.ops.repro_torch.flash_attention:
                            shape_wrapper(_flash_flops)})
        real_flash, ops.flash_attention = (ops.flash_attention,
                                           _flash_via_stand_in)
        try:
            with _shape_inference_paused(), tracker, traffic:
                step(*args)
        finally:
            ops.flash_attention = real_flash
    peak = max(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    dot = float(traffic.dot_flops)
    coll = {"bytes_per_device": traffic.coll_bytes,
            "counts": traffic.coll_counts,
            "total_bytes_per_device": sum(traffic.coll_bytes.values())}
    return {"n_chips": 1 if mesh is None else mesh.size(),
            "memory": {"argument_size_in_bytes": int(arg_bytes),
                       "temp_size_in_bytes": int(max(peak - arg_bytes, 0)),
                       "per_device_total_gb": peak / 1e9,
                       "fits_h100_80gb": bool(peak < HBM_BYTES)},
            "cost": {"flops": dot + traffic.elements, "dot_flops": dot,
                     "bytes": float(traffic.bytes), "aten_ops": traffic.ops},
            "collectives": coll}


def roofline(rec: dict, cfg: ModelConfig, shape: InputShape) -> dict:
    """The roofline terms at the H100's rates and the cluster's
    collective rate (``launch.mesh``), per device."""
    dot, total = rec["cost"]["dot_flops"], rec["cost"]["flops"]
    nbytes = rec["cost"]["bytes"]
    coll = rec["collectives"]["total_bytes_per_device"]
    mf = model_flops(cfg, shape)
    n = rec["n_chips"]
    out = {"hlo_flops_per_device": dot,
           "hlo_flops_with_elementwise": total,
           "hlo_bytes_per_device": nbytes,
           "collective_bytes_per_device": coll,
           "t_compute_s": dot / PEAK_FLOPS_BF16,
           "t_memory_s": nbytes / HBM_BW,
           "t_collective_s": coll / COLLECTIVE_BW,
           "model_flops_total": mf,
           "model_flops_per_device": mf / n,
           "useful_flops_ratio": (mf / n) / dot if dot else None}
    terms = {k: out[f"t_{k}_s"] for k in ("compute", "memory", "collective")}
    out["dominant"] = max(terms, key=terms.get)
    return out


def mesh_name(mesh: str = "card") -> str:
    """The record's mesh: ``h100`` for one card, ``h100x<n>`` for a mesh
    of n cards (``h100x256``, ``h100x512``)."""
    if mesh == "card":
        return MESH_NAME
    return f"h100x{math.prod(mesh_layout(mesh)[0])}"


def run_one(arch: Union[str, ModelConfig], shape: Union[str, InputShape],
            out_dir: str = RESULTS_DIR, force: bool = False,
            opt_name: str = "adamw", mesh: str = "card",
            recipe: str = "default") -> dict:
    """One record, written to ``<out_dir>/<arch>__<shape>__<mesh>.json``
    (``__<recipe>`` added for a recipe but ``default``); ``arch`` and
    ``shape`` by name or as objects (a config's ``name`` and a shape's
    ``name`` name the file)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    name = mesh_name(mesh)
    os.makedirs(out_dir, exist_ok=True)
    stem = f"{cfg.name}__{shape.name}__{name}"
    if recipe != "default":
        stem += f"__{recipe}"
    path = os.path.join(out_dir, f"{stem}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": name,
           "status": "error", "layers": cfg.num_layers,
           "global_batch": shape.global_batch, "seq_len": shape.seq_len}
    if mesh != "card":
        rec["recipe"] = recipe
    t0 = time.perf_counter()
    try:
        if mesh == "card":
            rec.update(analyze(cfg, shape, opt_name))
        else:
            with use_mesh(mesh, "cpu", S.SHARD_BATCH_AXES[recipe]) as m:
                rec.update(analyze(cfg, shape, opt_name, mesh=m,
                                   recipe=recipe))
        rec["roofline"] = roofline(rec, cfg, shape)
        rec["status"] = "ok"
        rec["trace_s"] = time.perf_counter() - t0
        print(f"OK  {cfg.name:24s} {shape.name:12s} {name} "
              f"trace {rec['trace_s']:6.1f}s "
              f"mem {rec['memory']['per_device_total_gb']:8.2f}GB "
              f"dom={rec['roofline']['dominant']}", flush=True)
    except Exception as e:   # the matrix run records the failure, goes on
        rec["error"] = traceback.format_exc()
        print(f"ERR {cfg.name:24s} {shape.name:12s} {name}: {e!r}",
              flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Trace one step of each (arch x shape) on fake tensors "
        "and write its H100 roofline record: of one card, or of rank 0 of "
        "a 256- or 512-card mesh. Seconds to a few minutes a record, but "
        "xLSTM's prefill_32k takes about two hours and its train_4k about "
        "one on one card (its sLSTM steps once per token), longer on a "
        "mesh.")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"],
                    help="card: one H100; single: (data 16, model 16), "
                    "256 cards; multi: (pod 2, data 16, model 16), 512; "
                    "both: single and multi ($REPRO_MESH_OVERRIDE "
                    "resizes a mesh)")
    ap.add_argument("--recipe", default="default",
                    choices=list(S.RECIPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="adamw")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_err = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                rec = run_one(arch, shape, out_dir=args.out,
                              force=args.force, opt_name=args.opt,
                              mesh=mesh, recipe=args.recipe)
                n_ok += rec.get("status") == "ok"
                n_err += rec.get("status") != "ok"
    print(f"done: {n_ok} ok, {n_err} errors")


if __name__ == "__main__":
    main()
