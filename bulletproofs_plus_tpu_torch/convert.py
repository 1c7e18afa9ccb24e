"""Carry state across from the JAX package: its device arrays, as numpy
(..., 16) uint32 radix-2^16 limbs, become the port's int64 limb tensors.

The state that crosses is the generator vectors, the packed proof arrays
and the fixed-base digit tables (there are no weights).  For points and
scalars the layouts already agree and only the dtype changes; the tables
are made affine and repacked into the 32-bit words the port's kernels read.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.edwards import PointArray
from .ops.limbs import NLIMBS


def scalars_from_jax_numpy(x, device="cuda") -> torch.Tensor:
    """(..., 16) uint32 limbs (each < 2^16) -> (..., 16) int64 tensor on `device`."""
    arr = np.asarray(x)
    if arr.shape[-1:] != (NLIMBS,):
        raise ValueError(f"expected (..., {NLIMBS}) limbs, got {arr.shape}")
    if arr.size and int(arr.max()) >> 16:
        raise ValueError("limbs must be below 2^16")
    return torch.as_tensor(arr.astype(np.int64), device=device)


def points_from_jax_numpy(x, y, z, t, device="cuda") -> PointArray:
    """Four (..., 16) uint32 coordinate arrays (a JAX PointArray as numpy)
    -> the port's PointArray on `device`."""
    return PointArray(*(scalars_from_jax_numpy(c, device) for c in (x, y, z, t)))


def tables_from_jax_numpy(x, y, z, t, device="cuda") -> torch.Tensor:
    """The JAX package's `build_tables` coordinates, four (64, 16, S, 16)
    uint32 arrays as numpy (extended coordinates) -> the port's table
    (ops/fixed_base.pack_tables): each entry made affine and precomputed for
    the mixed addition, int32 (64, 16, S, 24) words on `device`."""
    from .ops.fixed_base import N_DIGITS, N_WINDOWS, NielsArray, pack_tables, to_niels

    shape = np.asarray(x).shape
    if len(shape) != 4 or shape[:2] != (N_WINDOWS, N_DIGITS):
        raise ValueError(f"expected ({N_WINDOWS}, {N_DIGITS}, S, {NLIMBS}) table coordinates, got {shape}")
    if any(np.asarray(c).shape != shape for c in (y, z, t)):
        raise ValueError("table coordinates differ in shape")
    extended = PointArray(*(c.transpose(0, 1) for c in points_from_jax_numpy(x, y, z, t, device)))  # (16, 64, S)
    return pack_tables(NielsArray(*(c.transpose(0, 1) for c in to_niels(extended))))
