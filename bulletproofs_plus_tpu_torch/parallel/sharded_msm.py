"""Multi-card MSM: lanes sharded over a mesh of ranks.

Counterpart of bulletproofs_plus_tpu/parallel/sharded_msm.py, whose
`shard_map` becomes SPMD over torch.distributed:

  * every rank is handed all N lanes (as a JAX global array is) and takes
    its contiguous run of N / world;
  * each rank runs the ladder (`ed.scalar_mul`) and the halving sum
    (`tree_reduce`) on its run: no communication;
  * the ranks gather their one partial point each (4 x 16 limbs) and fold
    the gathered points, so every rank returns the same point.

Points cannot be summed limb-wise, so the collective gathers the partials
(`collectives.gather_rows`) and the addition stays in the fold.
"""

from __future__ import annotations

import torch

from ..ops import edwards as ed
from ..ops.edwards import PointArray
from ..ops.limbs import NLIMBS
from ..ops.msm import tree_reduce
from .collectives import gather_rows, rank_and_size, world_mesh


def make_mesh(device_type=None, axis_name: str = "mp"):
    """A 1-D mesh over every rank, on `device_type` ("cuda" unless given)."""
    return world_mesh(device_type, axis_name)


def _fold_gathered(partials: PointArray) -> PointArray:
    """Sum a (D,) batch of points with a halving fold (an odd D is padded
    with identities to a power of two)."""
    n = partials.x.shape[0]
    m = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if m != n:
        partials = ed.cat([partials, ed.identity((m - n,), device=partials.x.device)])
    return tree_reduce(partials)


def sharded_msm_fn(mesh, axis_name: str = "mp"):
    """The sharded MSM over `mesh`'s axis `axis_name`.

    Returns fn(scalars (N, 16), points PointArray (N,)) -> PointArray (),
    the same point on every rank, with N divisible by the mesh's size and
    each rank's N / world lanes a width `tree_reduce` takes (`pad_for_mesh`
    makes both hold)."""
    group = mesh.get_group(axis_name)

    def fn(scalars: torch.Tensor, points: PointArray) -> PointArray:
        rank, world = rank_and_size(mesh, axis_name)
        n = scalars.shape[0]
        if n % world:
            raise ValueError(f"{n} lanes do not split over {world} ranks")
        own = slice(rank * n // world, (rank + 1) * n // world)
        partial = tree_reduce(ed.scalar_mul(scalars[own], PointArray(*(c[own] for c in points))))
        rows = gather_rows(torch.stack(list(partial)), group)  # (world, 4, 16): every rank's point
        return _fold_gathered(PointArray(*rows.unbind(1)))

    return fn


def pad_for_mesh(scalars: torch.Tensor, points: PointArray, n_shards: int):
    """Pad lanes with (zero scalar, identity point) so each of the n_shards
    gets a `tree_reduce`-compatible run."""
    from ..ops.msm import _reduce_width

    n = scalars.shape[0]
    per = -(-n // n_shards)
    target = _reduce_width(per) * n_shards
    if target == n:
        return scalars, points
    pad = target - n
    scalars = torch.cat([scalars, scalars.new_zeros((pad, NLIMBS))])
    return scalars, ed.cat([points, ed.identity((pad,), device=scalars.device)])
