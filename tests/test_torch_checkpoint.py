"""Checkpoints: the port's files and the reference's are the same format,
and each package reads the other's with the same bits.

The port writes its parameter dict from the nested JAX layout
(``/io/embed``, ``/stack/units/...``), with its own MessagePack encoder;
where ``msgpack`` is installed its bytes equal ``msgpack.packb`` of the
same entries, and the two packages' files for the same weights are byte
for byte identical. All comparisons are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch_tiny import flat_paths, jax_params, tiny_setup  # noqa: E402

from repro import checkpointing as jckpt  # noqa: E402
from repro_torch import checkpointing as tckpt  # noqa: E402
from repro_torch.checkpointing.checkpoint import packb, unpackb  # noqa: E402
from repro_torch.models import params_from_numpy, params_to_numpy  # noqa: E402


@pytest.fixture(scope="module")
def params():
    _, jcfg, _, _, _ = tiny_setup()
    return jax_params(jcfg)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_port_file_loads_in_the_reference(params, tmp_path):
    tp = params_from_numpy(params, "cpu")
    path = str(tmp_path / "port.ckpt")
    tckpt.save(path, tp.params())
    back = jckpt.load(path, jax.tree.map(jnp.asarray, params))
    want = flat_paths(params)
    got = flat_paths(back)
    assert list(got) == list(want)
    for k in want:
        _same_bits(got[k], want[k])


def test_reference_file_loads_in_the_port(params, tmp_path):
    path = str(tmp_path / "ref.ckpt")
    jckpt.save(path, jax.tree.map(jnp.asarray, params))
    like = params_from_numpy(
        jax.tree.map(np.zeros_like, params), "cpu").params()
    back = tckpt.load(path, like)
    want = flat_paths(params)
    assert list(back) == list(like)
    for k, t in back.items():
        assert t.dtype == like[k].dtype
        _same_bits(t.numpy(), want[k])


def test_files_are_byte_identical(params, tmp_path):
    jpath, tpath = str(tmp_path / "j.ckpt"), str(tmp_path / "t.ckpt")
    jckpt.save(jpath, jax.tree.map(jnp.asarray, params))
    tckpt.save(tpath, params_from_numpy(params, "cpu"))
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()


def test_encoder_matches_msgpack(params):
    msgpack = pytest.importorskip("msgpack")
    rng = np.random.default_rng(0)
    entries = {f"/k{i}": {"dtype": "float32",
                          "shape": [int(rng.integers(0, 2 ** 33)), 300,
                                    70_000, 0, 127, 128],
                          "data": rng.bytes(int(rng.integers(0, 70_000)))}
               for i in range(20)}
    entries["/" + "x" * 300] = {"dtype": "int8", "shape": [], "data": b""}
    many = {f"/m{i}": {"dtype": "f", "shape": list(range(20)), "data": b"1"}
            for i in range(70_000)}
    for obj in (entries, many, {}):
        data = packb(obj)
        assert data == msgpack.packb(obj)
        assert unpackb(data) == msgpack.unpackb(data) == obj


def test_round_trips(params, tmp_path):
    """Save and load in the port: a ParamTree, a parameter dict and a
    nested tree of arrays all come back with the same bits."""
    tp = params_from_numpy(params, "cpu")
    path = str(tmp_path / "rt.ckpt")
    tckpt.save(path, tp)
    back = tckpt.load(path, tp)
    for k, t in tp.params().items():
        assert torch.equal(back[k], t), k
    nested = tckpt.load(path, params_to_numpy(tp))
    for k, a in flat_paths(nested).items():
        _same_bits(a, flat_paths(params)[k])


def test_unsupported_values_are_refused(tmp_path):
    with pytest.raises(TypeError):
        packb({"x": -1})
    with pytest.raises(ValueError, match="0xc0"):
        unpackb(b"\xc0")
    with pytest.raises(KeyError, match="missing"):
        path = str(tmp_path / "a.ckpt")
        tckpt.save(path, {"a": np.zeros(2, np.float32)})
        tckpt.load(path, {"b": np.zeros(2, np.float32)})
