"""A mesh's step under real collectives on the CPU: eight ranks over a
``gloo`` group, a (data 2, model 4) mesh and the ``default`` recipe
(``tests/torch_mesh_ranks.py``, one spawn for every cell), against the
same port step unsharded and against the reference's step, from the
same JAX-initialised weights (``models/convert.py``) and numpy-seeded
inputs. The cells are the reference's own dry-run cells
(``tests/test_system.py``) at its SMOKE shapes:

- ``gemma2-9b`` train (8 x 128): two AdamW steps (loss, parameters,
  moments);
- ``phi3.5-moe-42b-a6.6b`` decode (8 over a 256-slot cache, 100 tokens
  in): the expert-parallel dispatch (logits, caches);
- ``xlstm-1.3b`` long_500k (batch 1): one step over recurrent states
  split over ``model`` (logits, states).

Tolerances. Against the unsharded port step: 1e-5 of each tensor's
largest magnitude (at least 1), the loss 1e-5 relative (f32; the
collectives change the order of some sums). Parameters after two
AdamW steps are held as ``tests/test_torch_train_step.py`` holds them
(0.2 LR, and all but 1e-4 of their elements within 0.01 LR): a gradient
of the order of AdamW's eps turns a gap in its last digits into a few
percent of one step. Against the reference: the bounds of
``tests/test_torch_train_step.py`` (train) and ``tests/test_torch_zoo.py``
(decode: 1e-5 absolute, recurrent states 1e-5 of max(1, their largest
magnitude)). The flash wrapper's GQA slicing (one query head a rank, the
KV heads gathered, each rank slicing the one it reads) is bit-equal to
the unsharded twin.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params  # noqa: E402

from repro.configs import get_smoke_config as j_get_smoke  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.optim import make_optimizer as j_make_optimizer  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_train_step)
from repro_torch.models import build, layers, params_from_numpy  # noqa: E402
from repro_torch.models.convert import flatten  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

import torch_mesh_ranks as R  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
#: cell -> (batch, seq): the reference's SMOKE shapes
SHAPES = {"gemma2-9b__train_4k": (8, 128),
          "phi3.5-moe-42b-a6.6b__decode_32k": (8, 256),
          "xlstm-1.3b__long_500k": (1, 2048)}
FILLED = 100          # tokens already in a decode cache
RTOL = 1e-5
TRAIN_TOL = dict(mom=1e-4, param=0.2, share=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(cell):
    """-> (flat numpy inputs written for the ranks, JAX params tree)."""
    arch, shape_name = cell.split("__")
    b, s = SHAPES[cell]
    npp = jax_params(j_get_smoke(arch), seed=1)
    out = {"batch": np.array(b), "seq": np.array(s)}
    out.update({f"param.{k}": np.asarray(v)
                for k, v in flat_paths(npp).items()})
    cfg = get_smoke_config(arch)
    if shape_name == "train_4k":
        out.update({f"batch.{k}": v
                    for k, v in synthetic_batch(cfg, b, s, seed=3).items()})
        return out, npp
    rng = np.random.default_rng(5)
    cache = build(cfg).init_cache(b, s, long=shape_name == "long_500k",
                                  device="meta")
    for name, t in flatten(cache).items():
        if t.dtype == torch.int32:
            out[f"cache.{name}"] = np.full(tuple(t.shape), FILLED, np.int32)
        else:
            out[f"cache.{name}"] = (0.5 * rng.standard_normal(
                tuple(t.shape))).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    return out, npp


def _unsharded(cell, inputs):
    """The same port step on plain CPU tensors -> flat numpy outputs."""
    arch, shape_name = cell.split("__")
    cfg = get_smoke_config(arch)
    model = build(cfg)
    t = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    params = {k[6:]: v for k, v in t.items() if k.startswith("param.")}
    if shape_name == "train_4k":
        opt = make_optimizer("adamw", R.LR, R.WD)
        state = opt.init(params)
        batch = {k[6:]: v for k, v in t.items() if k.startswith("batch.")}
        step = make_train_step(model, opt)
        for _ in range(R.STEPS):
            params, state, loss = step(params, state, batch)
        out = {"loss": loss.numpy()}
        for what, tree in (("param", params), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"{what}.{k}": v.numpy() for k, v in tree.items()})
        return out
    cache = R.fill(model.init_cache(int(t["batch"]), int(t["seq"]),
                                    long=shape_name == "long_500k",
                                    device="meta"),
                   {k[6:]: v.clone() for k, v in t.items()
                    if k.startswith("cache.")})
    logits, cache = make_decode_step(model)(params, cache, t["tokens"])
    out = {"logits": logits.numpy()}
    out.update({f"cache.{k}": v.numpy() for k, v in flatten(cache).items()})
    return out


def _reference(cell, inputs, npp):
    """The reference's step from the same weights -> flat numpy."""
    arch, shape_name = cell.split("__")
    jcfg = j_get_smoke(arch)
    model = jbuild(jcfg)
    jp = jax.tree.map(jnp.asarray, npp)
    if shape_name == "train_4k":
        opt = j_make_optimizer("adamw", R.LR, R.WD)
        state = opt.init(jp)
        batch = {k[6:]: jnp.asarray(v) for k, v in inputs.items()
                 if k.startswith("batch.")}
        step = jax.jit(j_make_train_step(model, opt))
        for _ in range(R.STEPS):
            jp, state, loss = step(jp, state, batch)
        out = {"loss": np.asarray(loss)}
        for what, tree in (("param", jp), ("mu", state.mu),
                           ("nu", state.nu)):
            out.update({f"{what}.{k}": np.asarray(v)
                        for k, v in flat_paths(tree).items()})
        return out
    b, s = SHAPES[cell]
    kw = {"long": shape_name == "long_500k"}
    if jcfg.encdec:
        kw["src_len"] = 4096
    tree = jax.eval_shape(lambda: model.init_cache(b, s, **kw))
    names = list(flat_paths(tree))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    cache = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inputs[f"cache.{n}"]) for n in names])
    logits, cache = jax.jit(model.decode_step)(jp, cache,
                                               jnp.asarray(inputs["tokens"]))
    out = {"logits": np.asarray(logits)}
    out.update({f"cache.{k}": np.asarray(v)
                for k, v in flat_paths(cache).items()})
    return out


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Writes every cell's inputs, runs the eight ranks once -> {cell:
    (sharded, unsharded, reference)}, the flash outputs and the gather
    sites that fired."""
    d = tmp_path_factory.mktemp("mesh")
    inputs = {}
    for cell in R.CELLS:
        inputs[cell] = _inputs(cell)
        np.savez(d / f"{cell}.npz", **inputs[cell][0])
    rng = np.random.default_rng(7)
    flash = {n: rng.standard_normal(shape).astype(np.float32)
             for n, shape in (("q", (2, 64, 4, 32)), ("k", (2, 64, 2, 32)),
                              ("v", (2, 64, 2, 32)))}
    np.savez(d / "flash.npz", **flash)
    env = dict(os.environ, PYTHONPATH=f"{SRC}:{HERE}")
    out = subprocess.run([sys.executable, os.path.join(HERE,
                                                       "torch_mesh_ranks.py"),
                          str(d), str(_free_port())],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-5000:]
    res = {}
    for cell in R.CELLS:
        with np.load(d / f"{cell}.out.npz") as f:
            sharded = {k: f[k] for k in f.files}
        res[cell] = (sharded, _unsharded(cell, inputs[cell][0]),
                     _reference(cell, *inputs[cell]))
    with np.load(d / "flash.out.npz") as f:
        res["flash"] = (flash, {k: f[k] for k in f.files})
    with open(d / "sites.json") as f:
        res["sites"] = json.load(f)
    return res


def _held(got, want, cell, against):
    """Every output of ``want`` in ``got``, within this file's bounds."""
    assert set(got) == set(want), set(got) ^ set(want)
    apart = total = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
        if name == "loss":
            assert float(g) == pytest.approx(float(w), rel=RTOL)
        elif name.startswith("param."):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=TRAIN_TOL["param"] * R.LR,
                                       err_msg=name)
            apart += int(np.sum(np.abs(g - w) > 0.01 * R.LR))
            total += w.size
        elif name.startswith(("mu.", "nu.")) and against == "reference":
            np.testing.assert_allclose(
                g, w, rtol=0, err_msg=name,
                atol=TRAIN_TOL["mom"] * max(float(np.abs(w).max()), 1e-30))
        elif against == "reference" and name.startswith("cache.") and \
                not name.rsplit(".", 1)[-1] in "Cnhcm":
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale,
                                       err_msg=f"{cell} {name}")
    assert apart <= TRAIN_TOL["share"] * max(total, 1), (apart, total)


@pytest.mark.parametrize("cell", R.CELLS)
def test_sharded_step_equals_the_unsharded_step(mesh_run, cell):
    sharded, unsharded, _ = mesh_run[cell]
    _held(sharded, unsharded, cell, "unsharded")


@pytest.mark.parametrize("cell", R.CELLS)
def test_sharded_step_equals_the_reference(mesh_run, cell):
    sharded, _, reference = mesh_run[cell]
    _held(sharded, reference, cell, "reference")


def test_flash_gqa_slicing_is_bit_equal(mesh_run):
    flash, got = mesh_run["flash"]
    q, k, v = (torch.from_numpy(flash[n]) for n in "qkv")
    for name, kw in (("causal", dict(causal=True)),
                     ("window", dict(causal=True, window=8, softcap=5.0))):
        want = ref.flash_attention_ref(q, k, v, **kw).numpy()
        np.testing.assert_array_equal(got[name], want, err_msg=name)


def test_gather_sites_are_named(mesh_run):
    """Every explicit redistribution happened at a listed site, and each
    cell's fired: the products' layout (``dense``), SMOKE Gemma2's 2 KV
    heads on a 4-way model axis (``heads``), decode queries grouped over
    KV heads their cache does not split (``gqa_groups``), Phi-3.5-MoE's
    expert-parallel FFN (``experts``), xLSTM's per-head scan
    (``mlstm``)."""
    sites = mesh_run["sites"]
    print(json.dumps(sites))
    assert set(sites) <= set(layers.GATHER_SITES), sites
    for site in ("dense", "heads", "gqa_groups", "experts", "mlstm"):
        assert sites.get(site, 0) > 0, (site, sites)
