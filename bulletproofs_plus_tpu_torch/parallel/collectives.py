"""How the port's ranks find their mesh, their card and each other's values.

A mesh here is a 1-D `DeviceMesh` over every rank of the default process
group; each rank runs on the mesh's device type at its current device
(`torch.cuda.current_device()` for "cuda").  `world_mesh` brings up a world
of one (an in-process store) where no process group exists, so a single
process is a degenerate but real mesh, as a single host is in the JAX
package.

Ranks exchange values through one collective, an all-reduce: `gather_rows`
gives every rank each rank's tensor by summing a zero (world, ...) int64
tensor in which each rank fills its own row.  The sum is exact, and it is
one code path for NCCL and for gloo on CUDA tensors, whose all-gather not
every torch build has.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..errors import InvalidArgument
from ..ops.edwards import resolve_device


def world_mesh(device_type=None, axis_name: str = "dp"):
    """A 1-D mesh named `axis_name` over every rank of the default process
    group, on `device_type` ("cuda" unless given).  Without a process group
    this process becomes a world of one: NCCL for "cuda", gloo otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or "cuda"
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def rank_and_size(mesh, axis_name=None) -> tuple:
    group = mesh.get_group(axis_name)
    return dist.get_rank(group), dist.get_world_size(group)


def mesh_device(mesh, device="cuda") -> torch.device:
    """The device this rank runs `mesh`'s work on; a `device` that names
    another raises."""
    own = resolve_device(mesh.device_type)
    if torch.device(device).type != own.type or resolve_device(device) != own:
        raise InvalidArgument(f"device {device!r} is not this rank's device of the mesh, {own}")
    return own


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `x` (integers, same shape on each) stacked in rank order:
    (world,) + x.shape int64, the same on every rank."""
    rows = torch.zeros((dist.get_world_size(group),) + tuple(x.shape), dtype=torch.int64, device=x.device)
    rows[dist.get_rank(group)] = x
    dist.all_reduce(rows, group=group)
    return rows
