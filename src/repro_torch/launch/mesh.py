"""Production mesh construction: a ``DeviceMesh`` over the process group.

Counterpart of ``repro.launch.mesh``.  Defined as functions (not
module-level constants) so that importing this module touches no process
group: the mesh is built over whatever default group the caller set up
first (NCCL on the card, gloo or threads in the tests, torch's fake group
for the dry-run, whose 256 or 512 ranks exist only as a world size).
``init_device_mesh`` reads the world size from that group, so a mesh of
``shape`` needs a group of ``prod(shape)`` ranks.
"""
from __future__ import annotations

import math

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(multi_pod: bool = False) -> tuple:
    """(shape, axes) of the production mesh: 16x16 single pod (256 chips)
    or 2x16x16 multi-pod (512 chips)."""
    return PRODUCTION[bool(multi_pod)]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16x16 (``("data", "model")``) or 2x16x16 (``("pod", "data",
    "model")``) mesh over the default process group."""
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape, axes, *, device_type: str = "cuda"):
    """An arbitrary mesh (tests use small ones, e.g. (2, 4) over 8 ranks);
    the default group must hold ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh of {shape} needs a process group of "
                           f"{math.prod(shape)} ranks; none is set up")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"a mesh of {shape} needs {math.prod(shape)} "
                           f"ranks; the process group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of a stand-in that carries names and sizes only."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}, for a ``DeviceMesh`` or a stand-in whose
    ``shape`` is that mapping already."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


def data_axes(mesh) -> tuple:
    """Axes treated as pure data parallelism (everything except 'model')."""
    return tuple(a for a in axis_names(mesh) if a != "model")


def axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)
