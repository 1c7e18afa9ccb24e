"""Carry state across from the JAX package: its device arrays, as numpy
(..., 16) uint32 radix-2^16 limbs, become the port's int64 limb tensors.

The state that crosses is the generator vectors and the packed proof arrays
(there are no weights); the layouts already agree, only the dtype changes.
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
