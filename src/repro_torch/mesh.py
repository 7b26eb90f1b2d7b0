"""Device meshes over ``torch.distributed``: the port's ``make_mesh``.

The reference is single-controller: one process calls ``shard_map`` over
every device of a ``jax.sharding.Mesh``. PyTorch is multi-controller: one
process a rank calls the same entry point with the same whole arguments,
takes its contiguous slice of the sharded axis (:func:`local_shard`), runs
the local path on its own device, and combines the slices with the
collective the reference uses (:func:`all_gather` for ``all_gather``,
:func:`all_reduce` ``"sum"`` for ``psum`` and ``"max"`` for ``pmax``), so
every rank returns the replicated result.

A mesh is PyTorch's own :class:`torch.distributed.device_mesh.DeviceMesh`
with named axes; the other modules reach it only through the helpers here
(:func:`axis_size`, :func:`axis_rank`, :func:`axis_group`,
:func:`mesh_size`). Of the reference's ``repro/compat.py`` only
``make_mesh`` has a twin: its other shims adapt jax versions.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

from .device import resolve_device


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str],
              device="cuda"):
    """A ``DeviceMesh`` of shape ``axis_shapes`` with named axes, over the
    ranks of the default process group, on ``device``'s type (``"cuda"``
    by default; a CUDA mesh without a card raises).

    Without a default process group, a one-rank mesh starts a world of one
    from a ``HashStore`` (NCCL for a CUDA mesh, gloo for a CPU one); a
    larger mesh needs the caller's ``dist.init_process_group`` first. The
    mesh must span the whole world. On a CUDA mesh each rank's current
    device becomes ``cuda:(rank % device_count)``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    if len(shape) != len(names) or not shape or min(shape) < 1:
        raise ValueError(f"mesh axes {names!r} do not fit the shape {shape}")
    dev_type = resolve_device(device).type
    size = math.prod(shape)
    if not dist.is_initialized():
        if size != 1:
            raise ValueError(
                f"a mesh of {size} ranks needs a process group: call "
                "torch.distributed.init_process_group first")
        dist.init_process_group("nccl" if dev_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if size != world:
        raise ValueError(f"a mesh of shape {shape} has {size} ranks, the "
                         f"process group {world}")
    if dev_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev_type, shape, mesh_dim_names=names)


def world_mesh(axis_name: str, device="cuda"):
    """A one-axis mesh over the whole world (one rank without a process
    group): the mesh the entry points build when they are given none."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world,), (axis_name,), device=device)


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"the mesh has no axis {axis!r} (axes {names!r})")
    return names.index(axis)


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis``."""
    return mesh.size(_dim(mesh, axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    _dim(mesh, axis)
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    _dim(mesh, axis)
    return mesh.get_group(axis)


def mesh_size(mesh) -> int:
    """Ranks in the whole mesh (the reference's device count of a mesh)."""
    return math.prod(mesh.shape)


def local_shard(x: torch.Tensor, mesh, axis: str, dim: int = 0,
                what: str = "length") -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``, which ``axis``
    shards; the length must divide evenly, as under ``shard_map``."""
    W = axis_size(mesh, axis)
    n = x.shape[dim]
    if n % W:
        raise ValueError(f"{what} {n} is not divisible by the mesh's "
                         f"{axis} size ({W})")
    per = n // W
    return x.narrow(dim, axis_rank(mesh, axis) * per, per)


def all_gather(x: torch.Tensor, mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` along ``axis``, concatenated along ``dim`` in rank
    order (the reference's ``all_gather(..., tiled=True)``; stack with
    ``x[None]``). Booleans travel as ``uint8`` and ``uint32`` as
    ``int32``, bit for bit, since gloo takes neither."""
    wire = x.contiguous()
    if x.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    elif x.dtype == torch.uint32:
        wire = wire.view(torch.int32)
    parts = [torch.empty_like(wire) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, wire, group=axis_group(mesh, axis))
    out = torch.cat(parts, dim=dim)
    if x.dtype == torch.bool:
        return out.to(torch.bool)
    return out.view(x.dtype)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh, axis: str,
               op: str = "sum") -> torch.Tensor:
    """``x`` combined over ``axis`` (``"sum"``: ``psum``, ``"max"``:
    ``pmax``), a new tensor on every rank."""
    out = x.clone().contiguous()
    dist.all_reduce(out, op=_OPS[op], group=axis_group(mesh, axis))
    return out
