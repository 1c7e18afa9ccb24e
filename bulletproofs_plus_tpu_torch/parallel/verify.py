"""Multi-card batch verification: data-parallel over the proof batch.

Counterpart of bulletproofs_plus_tpu/parallel/verify.py.  The final check

    sum_b [ static(b) + dynamic(b) ] == identity

distributes over the batch, so each rank takes a contiguous shard of the
proofs, runs the scalar pass and the decompression on it (`group_contrib`),
and two collectives combine the ranks:

  * an all-reduce of the static accumulators (gi, hi, G and H scalars),
    canonical limbs below 2^16 whose int64 sums stay exact for up to 2^47
    ranks, reduced mod l once after it, as `_batch_sum` reduces a batch;
  * a gather of one partial point a rank (with the shard's decompression
    flags), folded on every rank.

Each rank's partial is its dynamic MSM (K7, K2, K3 on a card).  The static
gi/hi/G/H lanes are counted once: rank 0 folds them into its own MSM, as
`combine_groups_point` does for the unsharded batch, and the other ranks
give none.  Every rank so ends with the same verdict and the same flags.
"""

from __future__ import annotations

import torch

from ..models.verifier_kernels import combine_groups_point, group_contrib
from ..ops import field as F
from ..ops import ristretto as rist
from ..ops.edwards import PointArray
from ..ops.limbs import NLIMBS
from ..ops.msm import msm_kernel, pad_msm_inputs
from .collectives import gather_rows, rank_and_size, world_mesh
from .sharded_msm import _fold_gathered
from .multihost import host_shard


def make_dp_mesh(device_type=None):
    """A 1-D "dp" mesh over every rank, on `device_type` ("cuda" unless given)."""
    return world_mesh(device_type, "dp")


def build_sharded_verifier(mesh, *, m: int, bit_length: int, max_mn: int, extension_degree: int | None = None):
    """A dp-sharded `verify_group_full` over `mesh`.  `extension_degree`,
    where given, must be d1's: the returned function checks it.

    Returns fn(y, z, round_es, e, weight, r1, s1, d1, min_values,
    comp_limbs, static_points, g_base_pts, h_base_pt) -> (ok, valid): the
    packed arrays are this rank's shard (`shard_packed`), the generators
    whole; `ok` and `valid` (every rank's flags, in batch order) are the
    same on every rank."""
    group = mesh.get_group()

    def verify(y, z, round_es, e, weight, r1, s1, d1, min_values, comp_limbs,
               static_points, g_base_pts, h_base_pt):
        gi, hi, gb, hb, dyn_s, points, valid = group_contrib(
            y, z, round_es, e, weight, r1, s1, d1, min_values, comp_limbs,
            m=m, bit_length=bit_length, max_mn=max_mn, extension_degree=extension_degree,
        )
        rank, world = rank_and_size(mesh)
        sums = torch.cat([gi, hi, gb, hb[None]])
        torch.distributed.all_reduce(sums, group=group)
        sums = F.barrett_reduce(F.carry_prop(sums, 32, bits=16 + world.bit_length()))
        gi, hi, gb, hb = sums.split([max_mn, max_mn, gb.shape[0], 1])
        if rank == 0:
            partial = combine_groups_point((gi,), (hi,), (gb,), (hb[0],), (dyn_s,), (points,),
                                           static_points, g_base_pts, h_base_pt)
        else:
            partial = msm_kernel(*pad_msm_inputs(dyn_s, points))
        rows = gather_rows(torch.cat([torch.stack(list(partial)).reshape(-1), valid.long()]), group)
        total = _fold_gathered(PointArray(*rows[:, : 4 * NLIMBS].reshape(world, 4, NLIMBS).unbind(1)))
        return rist.is_identity(total), rows[:, 4 * NLIMBS :].reshape(-1) != 0

    return verify


# Eager torch compiles nothing, so there is no program to cache per shape and
# mesh: the JAX package's cached `sharded_verifier` is `build_sharded_verifier`.
sharded_verifier = build_sharded_verifier


def shard_packed(packed, mesh):
    """This rank's contiguous shard of each array or list in `packed`, split
    on its leading (batch) axis as the JAX package shards over 'dp'."""
    rows = host_shard(len(packed[0]), mesh)
    return tuple(a[rows] for a in packed)
