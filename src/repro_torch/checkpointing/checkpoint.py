"""Path-keyed checkpoints, in the reference's file format.

A tree is flattened to ``"/a/b/c"``-keyed entries, each
``{"dtype": str, "shape": [ints], "data": raw bytes}``, and the map is
written in MessagePack, so the two packages read each other's files. The
port's parameter dict (dotted paths) is written from its nested JAX
layout (``convert.unflatten``), which gives the reference's
``/stack/units/...`` keys.

The encoder and decoder are the port's own, for the subset of
MessagePack the format uses (maps, str, bin, non-negative ints and
arrays of them), and emit what ``msgpack.packb`` emits for the same
entries: the shortest form of each item.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.convert import ParamTree, as_params, flatten, unflatten


# ---------------------------------------------------------------------------
# MessagePack subset
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: Tuple[int, ...], widths: Tuple[str, ...]) -> None:
    """Header of a str / bin / array / map of length ``n``: the fix form
    when one exists and fits, else the narrowest sized form."""
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt in zip(codes, widths):
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit MessagePack")


def _pack(out: bytearray, obj: Any) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"unsupported in checkpoints: {obj!r}")
    if isinstance(obj, int):
        if obj < 0:
            raise TypeError(f"negative ints are not used: {obj}")
        if obj < 0x80:
            out.append(obj)
        else:
            for code, fmt in ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"),
                              (0xCF, ">Q")):
                if obj < 1 << (8 * struct.calcsize(fmt)):
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} does not fit MessagePack")
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB),
                  (">B", ">H", ">I"))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6),
                  (">B", ">H", ">I"))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0xDC, 0xDD), (">H", ">I"))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, Mapping):
        _pack_len(out, len(obj), 0x80, 15, (0xDE, 0xDF), (">H", ">I"))
        for key, value in obj.items():
            _pack(out, key)
            _pack(out, value)
    else:
        raise TypeError(f"unsupported in checkpoints: {type(obj)}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _unpack(buf: bytes, at: int) -> Tuple[Any, int]:
    code = buf[at]
    at += 1

    def sized(fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, at)[0], at + size

    if code < 0x80:
        return code, at
    if 0x80 <= code <= 0x8F or code in (0xDE, 0xDF):
        n, at = ((code & 0x0F, at) if code <= 0x8F
                 else sized(">H" if code == 0xDE else ">I"))
        out: Dict[Any, Any] = {}
        for _ in range(n):
            key, at = _unpack(buf, at)
            out[key], at = _unpack(buf, at)
        return out, at
    if 0x90 <= code <= 0x9F or code in (0xDC, 0xDD):
        n, at = ((code & 0x0F, at) if code <= 0x9F
                 else sized(">H" if code == 0xDC else ">I"))
        items = []
        for _ in range(n):
            item, at = _unpack(buf, at)
            items.append(item)
        return items, at
    if 0xA0 <= code <= 0xBF or code in (0xD9, 0xDA, 0xDB):
        n, at = ((code & 0x1F, at) if code <= 0xBF
                 else sized({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[code]))
        return buf[at:at + n].decode("utf-8"), at + n
    if code in (0xC4, 0xC5, 0xC6):
        n, at = sized({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[code])
        return bytes(buf[at:at + n]), at + n
    if code in (0xCC, 0xCD, 0xCE, 0xCF):
        return sized({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[code])
    raise ValueError(f"unsupported MessagePack type byte 0x{code:02x}")


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} trailing bytes after the map")
    return obj


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _nested(tree: Any) -> Any:
    """The port's parameter dict or ``ParamTree`` -> the nested JAX
    layout; any other tree as it is."""
    if isinstance(tree, ParamTree):
        return unflatten(tree.params())
    if isinstance(tree, Mapping) and any("." in k for k in tree):
        return unflatten(tree)
    return tree


def _paths(tree, prefix="") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree: Any) -> None:
    """Write ``tree`` (the port's parameter dict, a ``ParamTree``, or a
    nested dict / list of tensors or arrays) to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    entries = {}
    for key, leaf in _paths(_nested(tree)):
        arr = np.ascontiguousarray(_numpy(leaf))
        entries[key] = {"dtype": str(arr.dtype), "shape": list(arr.shape),
                        "data": arr.tobytes()}
    with open(path, "wb") as f:
        f.write(packb(entries))


def load(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: a parameter dict or
    ``ParamTree`` gives a parameter dict of tensors on ``like``'s
    devices; a nested tree gives the same nesting, tensors where ``like``
    holds tensors and NumPy arrays elsewhere, each in ``like``'s dtype."""
    with open(path, "rb") as f:
        entries = unpackb(f.read())
    flat_like = isinstance(like, ParamTree) or (
        isinstance(like, Mapping) and any("." in k for k in like))
    template = _nested(as_params(like) if isinstance(like, ParamTree)
                       else like)
    keys = [k for k, _ in _paths(template)]
    missing = [k for k in keys if k not in entries]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]} ...")

    def rebuild(tree, prefix=""):
        if isinstance(tree, Mapping):
            return {k: rebuild(tree[k], f"{prefix}/{k}") for k in tree}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, f"{prefix}/{i}") for i, v in enumerate(tree)]
            return type(tree)(vals)
        ent = entries[prefix]
        arr = np.frombuffer(ent["data"], dtype=ent["dtype"]).reshape(
            ent["shape"])
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(arr.copy()).to(tree.device, tree.dtype)
        return np.asarray(arr, dtype=np.asarray(tree).dtype)

    out = rebuild(template)
    return flatten(out) if flat_like else out
