"""Collective helpers over a mesh dimension + cost models for napkin math.

Counterpart of ``repro.distributed.collectives``.  The byte counts and
``collective_seconds`` are the reference's; the link rate default is the
dry-run's per-GPU network rate (``launch/dryrun.py::LINK_BW``: one 400
Gb/s NDR InfiniBand port per GPU, the bound of a 16-wide axis that spans
two 8-GPU nodes).  The two collectives run over one dimension of a
``DeviceMesh`` through ``torch.distributed._functional_collectives``
(tiled along dim 0, as the reference's ``tiled=True``).
"""
from __future__ import annotations

LINK_BW = 50e9          # bytes/s per GPU: one 400 Gb/s NDR port


def ring_allreduce_bytes(nbytes: int, n: int) -> float:
    """Bytes moved per device by a ring all-reduce of an n-way group."""
    return 2.0 * nbytes * (n - 1) / n


def allgather_bytes(shard_bytes: int, n: int) -> float:
    """Bytes received per device by an all-gather of n shards."""
    return shard_bytes * (n - 1)


def collective_seconds(nbytes_per_device: float,
                       link_bw: float = LINK_BW) -> float:
    return nbytes_per_device / link_bw


def psum_scatter(x, mesh, axis_name: str):
    """Reduce-scatter (sum) across the mesh axis ``axis_name``, dim 0 split
    into the axis's shards (the ZeRO gradient sync primitive)."""
    import torch.distributed._functional_collectives as funcol
    return funcol.reduce_scatter_tensor(x, "sum", 0, _group(mesh, axis_name))


def all_gather(x, mesh, axis_name: str):
    """All-gather across the mesh axis ``axis_name``, the shards
    concatenated along dim 0."""
    import torch.distributed._functional_collectives as funcol
    return funcol.all_gather_tensor(x, 0, _group(mesh, axis_name))


def _group(mesh, axis_name: str):
    """The group of one mesh dimension, as the functional collectives take
    it: (mesh, dim index)."""
    return (mesh, mesh.mesh_dim_names.index(axis_name))
