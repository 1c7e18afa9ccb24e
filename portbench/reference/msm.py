"""The reference's MSM: variable-time Pippenger over Python ints (a frozen
copy of `host_msm` in bulletproofs_plus_tpu_torch/ops/msm.py)."""

from __future__ import annotations

from typing import Sequence

from . import ristretto as hr


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
