"""The production meshes and the sharding recipe of the port
(``repro_torch.launch.mesh``, ``launch.specs``) against the reference's
(``repro.launch.mesh``, ``repro.launch.specs``), and
``models.layers.shard_batch``.

- Recipe parity, exact: for every arch (the char-LM and the ten zoo
  configs) x recipe (default, tp_serve, fsdp) x mesh (single 16 x 16,
  multi 2 x 16 x 16), each parameter's placements, read back as a spec
  (``spec_of``), equal the reference's ``param_shardings``; for every
  arch x input shape x mesh, the batch's and the decode caches' too. The
  reference runs on a stand-in mesh with ``NamedSharding`` faked to hand
  back its spec, as ``tests/test_system.py`` does; the port on a real
  ``DeviceMesh`` over a fake process group. A spec is compared as, per
  tensor dim, the tuple of its mesh axes (``"data"`` and ``("data",)``
  shard alike), trailing replicated dims dropped.
- A dim split over several axes is split major to minor, as JAX splits
  it: the rank at (data d, model m) of a (2, 4) mesh holds block
  4 d + m.
- The meshes' shapes and axes, ``REPRO_MESH_OVERRIDE``, the link rates,
  and the group gone after ``use_mesh``.
- ``shard_batch``: the identity without a mesh (and on a plain tensor),
  and the reference's axis prefix under one.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_tiny  # noqa: E402,F401  (one torch thread per worker)

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                 get_config)
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import build, layers  # noqa: E402

ARCHS = ["charlm-shakespeare", *ARCH_IDS]


class FakeMesh:
    """The reference's mesh as its recipe reads it."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.devices = None


J_MESHES = {name: FakeMesh(axes, shape)
            for name, (shape, axes) in M.MESHES.items()}


@pytest.fixture
def fake_named_sharding(monkeypatch):
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


@pytest.fixture(params=["single", "multi"])
def meshes(request, monkeypatch):
    """(name, the reference's stand-in, the port's DeviceMesh)."""
    monkeypatch.delenv("REPRO_MESH_OVERRIDE", raising=False)
    with M.use_mesh(request.param, "cpu") as mesh:
        yield request.param, J_MESHES[request.param], mesh


def norm(spec):
    """A spec -> per tensor dim, the tuple of its axes; trailing
    replicated dims dropped."""
    out = [() if a is None else a if isinstance(a, tuple) else (a,)
           for a in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def j_flat(tree):
    """The reference's spec tree -> {dotted path: spec}."""
    return {path[1:].replace("/", "."): spec
            for path, spec in JS._tree_paths(tree)}


def flat(tree):
    return {path[1:].replace("/", "."): leaf
            for path, leaf in S._tree_paths(tree)}


@functools.lru_cache(maxsize=None)
def j_param_shapes(arch):
    return jax.eval_shape(jbuild(j_get_config(arch)).init,
                          jax.random.PRNGKey(0))


@pytest.mark.parametrize("recipe", list(S.RECIPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_recipe_matches_the_reference(fake_named_sharding, meshes,
                                            arch, recipe):
    _, jmesh, mesh = meshes
    want = j_flat(JS.param_shardings(jmesh, j_param_shapes(arch),
                                     j_get_config(arch), recipe))
    cfg = get_config(arch)
    params = build(cfg).init(None, "meta").params()
    got = S.param_shardings(mesh, params, cfg, recipe)
    assert list(got) == list(params) and set(got) == set(want)
    for name, placements in got.items():
        assert len(placements) == mesh.ndim
        assert norm(S.spec_of(placements, mesh)) == norm(want[name]), name


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_recipe_match_the_reference(fake_named_sharding,
                                                    meshes, arch, shape):
    _, jmesh, mesh = meshes
    cfg, jcfg = get_config(arch), j_get_config(arch)
    s, js = INPUT_SHAPES[shape], J_SHAPES[shape]
    want = JS.batch_shardings(jmesh, JS.input_specs(jcfg, js), js)
    got = S.batch_shardings(mesh, S.input_specs(cfg, s), s)
    assert set(got) == set(want)
    for name in want:
        assert norm(S.spec_of(got[name], mesh)) == norm(want[name]), name
    tok = JS.batch_shardings(jmesh, JS.sds((js.global_batch, 1), "int32"),
                             js)
    assert norm(S.spec_of(S.batch_shardings(
        mesh, S.sds((s.global_batch, 1), torch.int32), s), mesh)) \
        == norm(tok)
    if s.kind != "decode":
        return
    want = j_flat(JS.cache_shardings(jmesh, JS.cache_specs(jbuild(jcfg), jcfg,
                                                           js), jcfg, js))
    got = flat(S.cache_shardings(mesh, S.cache_specs(build(cfg), cfg, s),
                                 cfg, s))
    assert set(got) == set(want)
    for name in want:
        assert norm(S.spec_of(got[name], mesh)) == norm(want[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_recipe_splits_only_divisible_dims(meshes, arch):
    """Every parameter's split divides its dim (the recipe replicates a
    dim that does not), under every recipe."""
    _, _, mesh = meshes
    cfg = get_config(arch)
    params = build(cfg).init(None, "meta").params()
    for recipe in S.RECIPES:
        for name, placements in S.param_shardings(mesh, params, cfg,
                                                  recipe).items():
            for d, size in enumerate(params[name].shape):
                n = 1
                for i, pl in enumerate(placements):
                    if pl.is_shard(d):
                        n *= mesh.shape[i]
                assert size % n == 0, (recipe, name, d)


def test_axes_split_major_to_minor(monkeypatch):
    """("data", "model") on one dim: rank (d, m) of a (2, 4) mesh holds
    block 4 d + m, JAX's order; the reverse order is refused."""
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "2,4")
    with M.use_mesh("single", "cpu") as mesh:
        pl = S.placements_of((("data", "model"), None), mesh)
        assert S.spec_of(pl, mesh) == (("data", "model"),)
        for d in range(2):
            for m in range(4):
                shape, offset = _compute_local_shape_and_global_offset(
                    (64, 3), (2, 4), [d, m], pl)
                assert tuple(shape) == (8, 3)
                assert tuple(offset) == ((4 * d + m) * 8, 0)
        with pytest.raises(ValueError):
            S.placements_of((("model", "data"),), mesh)


def test_gather_sites_are_listed():
    """The explicit redistributions before ops DTensor cannot shard as
    they arrive, each by name (GSPMD inserts these silently); their
    bytes are collectives like any other."""
    assert set(layers.GATHER_SITES) == {
        "dense", "heads", "gqa_groups", "experts", "mlstm", "along_dim",
        "attention"}
    import types

    from torch.distributed.tensor import Replicate, Shard
    x = types.SimpleNamespace(placements=(Shard(0),))
    assert layers.redistribute_at("everything", x, (Shard(0),)) is x
    with pytest.raises(AssertionError):     # no unnamed gathers
        layers.redistribute_at("everything", x, (Replicate(),))


def test_shard_batch_identity_without_a_mesh():
    x = torch.randn(4, 3, 2)
    assert layers.shard_batch(x) is x
    assert layers.active_mesh() == (None, None)


@pytest.mark.parametrize("override,batch,axes,want", [
    ("2,4", 8, ("pod", "data"), ("data",)),
    ("2,4", 1, ("pod", "data"), None),
    ("2,4", 8, ("pod", "data", "model"), ("data", "model")),
    ("2,4", 2, ("pod", "data", "model"), ("data",)),
    ("2,2,2", 4, ("pod", "data"), ("pod", "data")),
    ("2,2,2", 2, ("pod", "data"), ("pod",)),
    ("2,2,2", 3, ("pod", "data"), None),
])
def test_shard_batch_takes_the_reference_prefix(monkeypatch, override, batch,
                                                axes, want):
    from torch.distributed.tensor import DTensor, Replicate
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", override)
    name = "multi" if override.count(",") == 2 else "single"
    with M.use_mesh(name, "cpu", batch=axes) as mesh:
        x = DTensor.from_local(torch.zeros(batch, 3), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
        assert layers.shard_batch(x.to_local()) is not None
        y = layers.shard_batch(x)
        if want is None:
            assert y is x
        else:
            assert S.spec_of(y.placements, mesh) == (
                want if len(want) > 1 else want[0],)


def test_meshes(monkeypatch):
    import torch.distributed as dist
    monkeypatch.delenv("REPRO_MESH_OVERRIDE", raising=False)
    assert M.make_mesh() == M.make_mesh("card") == 1
    assert (M.PEAK_FLOPS_BF16, M.HBM_BW) == (989e12, 3.35e12)
    assert (M.NVLINK_BW, M.IB_BW, M.COLLECTIVE_BW) == (450e9, 50e9, 50e9)
    for name, shape, axes in (("single", (16, 16), ("data", "model")),
                              ("multi", (2, 16, 16),
                               ("pod", "data", "model"))):
        with M.use_mesh(name, "cpu") as mesh:
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == axes
            assert dist.get_world_size() == mesh.size()
            assert M.batch_axes(mesh) == (axes[:-1] if name == "multi"
                                          else ("data",))
            assert M.axis_size(mesh, "model") == 16
            assert M.axis_size(mesh, "pod") == (2 if name == "multi" else 1)
            assert layers.active_mesh()[0] is mesh
        assert not dist.is_initialized()
        assert layers.active_mesh() == (None, None)
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "2,2,2")
    assert M.mesh_layout("single") == ((2, 2, 2), ("pod", "data", "model"))
    monkeypatch.setenv("REPRO_MESH_OVERRIDE", "2,4")
    assert M.mesh_layout("multi") == ((2, 4), ("data", "model"))
    with pytest.raises(ValueError):
        M.make_mesh("pod")
