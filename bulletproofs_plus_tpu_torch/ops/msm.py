"""Multiscalar multiplication: host Pippenger oracle and the device MSM.

Counterpart of bulletproofs_plus_tpu/ops/msm.py.
  * host: variable-time Pippenger over Python ints (`host_msm`) — the
    correctness oracle.
  * device: `msm_kernel`, the 4-bit windowed MSM whose three stages are the
    hand-written kernels K1-K3 on CUDA tensors (ops/cuda_msm.py) and their
    plain torch versions on CPU tensors.  Lanes padded with (zero scalar,
    identity point) contribute nothing.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import edwards as ed
from . import host_ristretto as hr
from .edwards import PointArray
from .limbs import NLIMBS

# ---------------------------------------------------------------------------
# Host Pippenger (variable-time, python ints)
# ---------------------------------------------------------------------------


def _pippenger_window(n: int) -> int:
    if n < 4:
        return 1
    if n < 32:
        return 3
    if n < 256:
        return 5
    if n < 1024:
        return 7
    if n < 8192:
        return 10
    return 13


def host_msm(scalars: Sequence[int], points: Sequence[hr.Point]) -> hr.Point:
    """sum_i scalars[i] * points[i] via bucketed Pippenger."""
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    n = len(scalars)
    if n == 0:
        return hr.IDENTITY
    scalars = [s % hr.L for s in scalars]
    w = _pippenger_window(n)
    nbuckets = (1 << w) - 1
    nwindows = (252 + w) // w  # l < 2^253

    acc = hr.IDENTITY
    for window in reversed(range(nwindows)):
        if window != nwindows - 1:
            for _ in range(w):
                acc = hr.point_double(acc)
        buckets: List[hr.Point] = [hr.IDENTITY] * nbuckets
        shift = window * w
        for s, p in zip(scalars, points):
            digit = (s >> shift) & nbuckets
            if digit:
                buckets[digit - 1] = hr.point_add(buckets[digit - 1], p)
        # sum_b (b+1) * buckets[b] via suffix running sums
        running = hr.IDENTITY
        window_sum = hr.IDENTITY
        for b in reversed(range(nbuckets)):
            running = hr.point_add(running, buckets[b])
            window_sum = hr.point_add(window_sum, running)
        acc = hr.point_add(acc, window_sum)
    return acc


# ---------------------------------------------------------------------------
# Device MSM
# ---------------------------------------------------------------------------


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _reduce_width(n: int) -> int:
    """The JAX package's padded lane count: a power of two up to 512, else a
    multiple of 512.  Kept so both packages run the MSM at the same width."""
    if n <= 512:
        return _next_pow2(n)
    return -(-n // 512) * 512


def pad_msm_inputs(scalars: torch.Tensor, points: PointArray):
    """Pad lanes to `_reduce_width` with zero scalars and identity points."""
    n = scalars.shape[0]
    m = _reduce_width(n)
    if m == n:
        return scalars, points
    scalars = torch.cat([scalars, scalars.new_zeros((m - n, NLIMBS))])
    return scalars, ed.cat([points, ed.identity((m - n,), device=scalars.device)])


def digits4(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (64, ...) int64 4-bit digits, window-major, LSB first."""
    shifts = torch.arange(0, 16, 4, device=scalars.device)
    nib = (scalars[..., :, None] >> shifts) & 0xF  # (..., 16 limbs, 4 nibbles)
    return nib.reshape(scalars.shape[:-1] + (64,)).movedim(-1, 0)


def msm_kernel(scalars: torch.Tensor, points: PointArray) -> PointArray:
    """sum_i scalars[i] * points[i] for (n, 16) canonical scalar limbs.

    4-bit windowed MSM: per-lane tables T[d] = d*P, per-window sums of the
    selected entries, then Horner over the 64 window sums — K1, K2 and K3
    (ops/cuda_msm.py), launched as kernels on CUDA tensors."""
    from .cuda_msm import coords_t, dyn_acc, horner, lane_fold

    return PointArray(*horner(lane_fold(dyn_acc(scalars.t().contiguous(), coords_t(points)))))
