"""The meshes of the dry-run and of a sharded step, and the device and
link rates of its roofline.

The reference lays its steps over v5e pods (``repro.launch.mesh``):
(data 16, model 16) on one pod, (pod 2, data 16, model 16) on two. The
port keeps those axes on H100 clusters: ``"single"`` is 256 cards as
(data 16, model 16) and ``"multi"`` 512 as (pod 2, data 16, model 16),
each a ``torch.distributed`` ``DeviceMesh``; ``"card"`` is one card and
no mesh. Outside a launcher that started one process per card there is
no process group, so ``make_mesh`` builds the mesh over torch's ``fake``
backend at rank 0: a DTensor step then runs rank 0's share of the work,
and its collectives are issued (and counted) but move nothing.
``REPRO_MESH_OVERRIDE`` ("2,4", "2,2,2") resizes the mesh as the
reference's does, its axes taken from the right of (pod, data, model).

``use_mesh`` is the counterpart of ``activate_mesh``: it makes the group
(when none exists) and the mesh, installs the mesh and its batch axes
for ``models.layers.shard_batch`` (``layers.install_mesh``: the state
lives in the model layer, which imports nothing of ``launch``), and
destroys the group it made on exit. Nothing here touches
``torch.distributed`` at import.

The rates are NVIDIA datasheet figures (H100 SXM, dense, at its 700 W
limit; NVLink 4 and InfiniBand NDR per GPU), never measurements. A
16-wide axis crosses 8-card nodes, so the roofline prices collective
bytes at the InfiniBand rate: one rate, as the reference's ``ICI_BW``.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

# NVIDIA H100 SXM datasheet rates (per card)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # B
# cluster links, datasheet (per GPU, per direction)
NVLINK_BW = 450e9                 # B/s, NVLink 4 inside an 8-card node
IB_BW = 50e9                      # B/s, InfiniBand NDR 400 Gb/s
COLLECTIVE_BW = IB_BW             # the roofline's collective rate

AXES = ("pod", "data", "model")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

def mesh_layout(name: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the named production mesh, or of
    ``REPRO_MESH_OVERRIDE`` when it is set."""
    if name not in MESHES:
        raise ValueError(f"unknown mesh {name!r}")
    override = os.environ.get("REPRO_MESH_OVERRIDE")
    if override:
        shape = tuple(int(x) for x in override.split(","))
        return shape, AXES[-len(shape):]
    return MESHES[name]


def make_mesh(name: str = "card", device: str = "cuda"):
    """``"card"``: 1 (one device, no mesh). ``"single"`` / ``"multi"``:
    a ``DeviceMesh`` of the layout ``mesh_layout`` gives, on ``device``
    (``"cpu"`` for the tests and the dry-run), over the default process
    group; without one, a ``fake`` group of the mesh's size is made at
    rank 0 (``use_mesh`` destroys it again)."""
    if name == "card":
        return 1
    shape, axes = mesh_layout(name)
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    world = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"mesh {shape} needs {world} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def use_mesh(name: str, device: str = "cuda",
             batch: Optional[Tuple[str, ...]] = None) -> Iterator:
    """Make the named mesh (and its fake group when there is no group),
    install it for ``shard_batch`` with ``batch`` as its batch axes
    (default the reference's ``REPRO_BATCH_AXES``: (pod, data)), yield
    it, and on exit uninstall it and destroy the group it made."""
    import torch.distributed as dist

    from repro_torch.models.layers import install_mesh
    owned = not dist.is_initialized()
    mesh = make_mesh(name, device)
    install_mesh(mesh, batch or ("pod", "data"))
    try:
        yield mesh
    finally:
        install_mesh(None, None)
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def batch_axes(mesh) -> tuple:
    """Mesh axes a global-batch dimension shards over."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    if name not in names:
        return 1
    return mesh.shape[names.index(name)]
