"""The sharded side of ``tests/test_torch_mesh_step.py``: eight CPU ranks
over a ``gloo`` group (real collectives), a (data 2, model 4) mesh
(``REPRO_MESH_OVERRIDE=2,4``) and the ``default`` recipe, each running
the reference's three dry-run cells at their SMOKE shapes from the
inputs in ``<dir>/<cell>.npz``:

- ``gemma2-9b`` train (8 x 128): two AdamW steps;
- ``phi3.5-moe-42b-a6.6b`` decode (8 over a 256-slot cache): one step;
- ``xlstm-1.3b`` long_500k (1 over 2,048): one step.

Rank 0 writes each cell's outputs, gathered (``full_tensor``), to
``<dir>/<cell>.out.npz``: the loss, parameters and AdamW's moments of
the train cell, the logits and caches of the decode cells; and the
redistributions at each of ``models.layers.GATHER_SITES`` to
``<dir>/sites.json``.

    python tests/torch_mesh_ranks.py <dir> <port>
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
CELLS = ("gemma2-9b__train_4k", "phi3.5-moe-42b-a6.6b__decode_32k",
         "xlstm-1.3b__long_500k")
LR, WD = 1e-3, 0.01
STEPS = 2


def load(path):
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}


def split(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def fill(tree, flat, prefix=""):
    """``tree`` (a cache of meta tensors) with each leaf replaced by
    ``flat``'s tensor of the same dotted path."""
    if isinstance(tree, dict):
        return {k: fill(v, flat, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [fill(v, flat, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return flat[prefix[:-1]]


def run_flash(d, mesh):
    """The flash wrapper's GQA slicing: q (2, 64, 4, 32) over k/v (2, 64,
    2, 32), the query heads split over ``model`` (one a rank), k/v
    gathered there -> ``<dir>/flash.out.npz``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.kernels import ops
    f = load(os.path.join(d, "flash.npz"))
    qp = (Shard(0), Shard(2))
    q = distribute_tensor(f["q"], mesh, qp)
    k = distribute_tensor(f["k"], mesh, (Shard(0), Replicate()))
    v = distribute_tensor(f["v"], mesh, (Shard(0), Replicate()))
    out = {}
    for name, kw in (("causal", dict(causal=True)),
                     ("window", dict(causal=True, window=8, softcap=5.0))):
        got = ops.flash_attention(q, k, v, **kw)
        assert tuple(got.placements) == qp, got.placements
        out[name] = got.full_tensor().numpy()
    if dist.get_rank() == 0:
        np.savez(os.path.join(d, "flash.out.npz"), **out)


def full(tree):
    return {k: v.full_tensor().numpy() for k, v in tree.items()}


def run_cell(cell, d, mesh):
    from repro_torch.configs import INPUT_SHAPES, get_smoke_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import specs as S
    from repro_torch.launch.steps import make_decode_step, make_train_step
    from repro_torch.models import build
    from repro_torch.models.convert import flatten
    from repro_torch.optim import make_optimizer

    arch, shape_name = cell.split("__")
    cfg = get_smoke_config(arch)
    model = build(cfg)
    kind = INPUT_SHAPES[shape_name].kind
    inputs = load(os.path.join(d, f"{cell}.npz"))
    params = split(inputs, "param.")
    shape = InputShape(shape_name, int(inputs["seq"]), int(inputs["batch"]),
                       kind)
    dp = S.distribute(params, S.param_shardings(mesh, params, cfg), mesh)
    if kind == "train":
        batch = split(inputs, "batch.")
        db = S.distribute(batch, S.batch_shardings(mesh, batch, shape), mesh)
        opt = make_optimizer("adamw", LR, WD)
        state = opt.init(dp)
        step = make_train_step(model, opt)
        for _ in range(STEPS):
            dp, state, loss = step(dp, state, db)
        res = {"loss": loss.full_tensor().numpy()}
        res.update({f"param.{k}": v for k, v in full(dp).items()})
        res.update({f"mu.{k}": v for k, v in full(state.mu).items()})
        res.update({f"nu.{k}": v for k, v in full(state.nu).items()})
    else:
        cache = fill(model.init_cache(shape.global_batch, shape.seq_len,
                                      long=shape_name == "long_500k",
                                      device="meta"),
                     split(inputs, "cache."))
        cache = S.distribute(cache, S.cache_shardings(mesh, cache, cfg,
                                                      shape), mesh)
        tok = inputs["tokens"]
        tok = S.distribute(tok, S.batch_shardings(mesh, tok, shape), mesh)
        logits, cache = make_decode_step(model)(dp, cache, tok)
        res = {"logits": logits.full_tensor().numpy()}
        res.update({f"cache.{k}": v for k, v in full(flatten(cache)).items()})
    if dist.get_rank() == 0:
        np.savez(os.path.join(d, f"{cell}.out.npz"), **res)


def rank_main(rank, d, port):
    torch.set_num_threads(1)
    os.environ["REPRO_MESH_OVERRIDE"] = "2,4"
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import layers as L
    try:
        for cell in CELLS:
            with use_mesh("single", "cpu") as mesh:
                run_cell(cell, d, mesh)
        with use_mesh("single", "cpu") as mesh:
            run_flash(d, mesh)
        if rank == 0:
            with open(os.path.join(d, "sites.json"), "w") as f:
                json.dump(dict(L.REDISTRIBUTED), f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(sys.argv[1], int(sys.argv[2])), nprocs=WORLD)
