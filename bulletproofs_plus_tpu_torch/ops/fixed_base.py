"""The verifier's mixed static + dynamic MSM.

Counterpart of `mixed_msm` in bulletproofs_plus_tpu/ops/fixed_base.py, on
the path that package takes on its kernel path: the static generator lanes
simply join the dynamic MSM (one kernel chain beats two, and the MSM kernel
builds its digit tables on chip anyway).  The precomputed fixed-base tables
and their kernels (K5/K6) belong to the prover and are not ported yet.
"""

from __future__ import annotations

import torch

from . import edwards as ed
from .edwards import PointArray
from .msm import msm_kernel


def mixed_msm(
    static_scalars: torch.Tensor,
    static_points: PointArray,
    dynamic_scalars: torch.Tensor,
    dynamic_points: PointArray,
) -> PointArray:
    """sum static_scalars * static_points + sum dynamic_scalars * dynamic_points,
    the analog of `vartime_mixed_multiscalar_mul` (range_proof.rs:1050).
    Dynamic lanes come first, as in the JAX package."""
    scalars = torch.cat([dynamic_scalars, static_scalars])
    return msm_kernel(scalars, ed.cat([dynamic_points, static_points]))
