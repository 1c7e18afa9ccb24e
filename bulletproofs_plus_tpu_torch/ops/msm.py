"""Multiscalar multiplication: host Pippenger oracle and the device MSM.

Counterpart of bulletproofs_plus_tpu/ops/msm.py.
  * host: variable-time Pippenger over Python ints (`host_msm`) — the
    correctness oracle.
  * device: `msm_kernel`, the 4-bit windowed MSM whose three stages are the
    hand-written kernels K7 (signed digits; or K1, unsigned), K2 and K3 on
    CUDA tensors (ops/cuda_msm.py) and their plain torch versions on CPU
    tensors.  Lanes padded with (zero scalar, identity point) contribute
    nothing.  `tree_reduce` is the plain halving sum over a lane axis.
  * dispatch: `msm(scalars, points, backend=None, device="cuda")` over host
    scalar and point lists, "host" (`host_msm`, the default) or "device"
    (`device_msm` on `device`); `set_default_backend` changes the default.
    A failure on the device raises: nothing falls back to the host.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
import torch

from . import edwards as ed
from . import host_ristretto as hr
from .edwards import PointArray
from .limbs import NLIMBS, pack_ints

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


def pad_msm_inputs(scalars: torch.Tensor, points: PointArray, target: int | None = None):
    """Pad lanes to `target` (default: `_reduce_width`) with zero scalars and
    identity points."""
    n = scalars.shape[0]
    m = _reduce_width(n) if target is None else target
    if m == n:
        return scalars, points
    scalars = torch.cat([scalars, scalars.new_zeros((m - n, NLIMBS))])
    return scalars, ed.cat([points, ed.identity((m - n,), device=scalars.device)])


def digits4_nd(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 16) limbs -> (64, ...) int64 4-bit digits, window-major, LSB first."""
    shifts = torch.arange(0, 16, 4, device=scalars.device)
    nib = (scalars[..., :, None] >> shifts) & 0xF  # (..., 16 limbs, 4 nibbles)
    return nib.reshape(scalars.shape[:-1] + (64,)).movedim(-1, 0)


def digits4(scalars: torch.Tensor) -> torch.Tensor:
    """(N, 16) limbs -> (64, N) 4-bit digits, window-major (LSB first)."""
    return digits4_nd(scalars)


def signed_digits4(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 16) canonical limbs -> (64, ...) int64 signed digits in [-8, 7]
    with sum_j d_j 16^j == s, window-major, LSB first.

    The constant-add recoding: nibble j of t = s + 0x88..8 is d_j + 8.
    Valid for s < 2^253 (every canonical scalar), where t stays below 2^256."""
    from . import field as F

    t = F.carry_prop(scalars + 0x8888, NLIMBS, bits=17)
    return digits4(t) - 8


def tree_reduce(points: PointArray) -> PointArray:
    """Sum points over their last lane axis: (..., n, 16) -> (..., 16).

    The lane count is a power of two up to 512 or a multiple of 512 (see
    `_reduce_width`): rows of 512 lanes are added in sequence, then the
    remaining lanes halve log2 times."""
    n = points.x.shape[-2]
    width = min(n, 512)
    if width & (width - 1) or n % width:
        raise ValueError("tree_reduce needs a power of two up to 512, or a multiple of 512, lanes")
    rows = PointArray(*(c.reshape(c.shape[:-2] + (n // width, width, NLIMBS)) for c in points))
    acc = PointArray(*(c[..., 0, :, :] for c in rows))
    for r in range(1, n // width):
        acc = ed.add(acc, PointArray(*(c[..., r, :, :] for c in rows)))
    while width > 1:
        width //= 2
        acc = ed.add(
            PointArray(*(c[..., :width, :] for c in acc)), PointArray(*(c[..., width : 2 * width, :] for c in acc))
        )
    return PointArray(*(c[..., 0, :] for c in acc))


def msm_kernel(scalars: torch.Tensor, points: PointArray, signed: bool | None = None, identity: bool = False):
    """sum_i scalars[i] * points[i] for (n, 16) canonical scalar limbs.

    4-bit windowed MSM: per-lane tables of the digits' multiples of P,
    per-window sums of the selected entries, then Horner over the 64 window
    sums — K7 (signed digits in [-8, 7], T[d] = d*P for d up to 8) or K1
    (digits 0..15, 16 entries), then K2 and K3 (ops/cuda_msm.py), launched as
    kernels on CUDA tensors.  signed=None reads BPPT_MSM_SIGNED at call time:
    K7 unless it is "0", which selects K1.  Signed digits are the default
    because K7 + K2 measured faster than K1 + K2 on an H100 at both verify
    widths (PERF.md); the JAX package defaults to unsigned digits.
    identity=True returns (point, () bool: the sum is the identity), the
    verdict from K3's own launch (its tail, I1's test)."""
    from .cuda_msm import coords_t, dyn_acc, dyn_acc_signed, horner, lane_fold

    if signed is None:
        signed = os.environ.get("BPPT_MSM_SIGNED", "1") != "0"
    acc = dyn_acc_signed if signed else dyn_acc
    wsum = lane_fold(acc(scalars.t().contiguous(), coords_t(points)))
    if identity:
        point, flag = horner(wsum, identity=True)
        return PointArray(*point), flag
    return PointArray(*horner(wsum))


def device_msm(scalars: Sequence[int], points: Sequence[hr.Point], device="cuda") -> hr.Point:
    """Host-convenience wrapper: python ints and host points -> `msm_kernel`
    on `device` (K1 or K7, K2, K3 on a card; their plain versions on "cpu")
    -> host point.  Scalars are taken mod l; lanes are padded as the JAX
    package pads them."""
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    if len(scalars) == 0:
        return hr.IDENTITY
    s = torch.as_tensor(pack_ints([s % hr.L for s in scalars]).astype(np.int64), device=device)
    s, p = pad_msm_inputs(s, ed.from_host(list(points), device=device))
    return ed.to_host(msm_kernel(s, p))


_BACKENDS = {"host", "device"}
_default_backend = "host"


def _check_backend(name: str) -> None:
    if name not in _BACKENDS:
        raise ValueError(f"unknown msm backend {name!r}")


def set_default_backend(name: str) -> None:
    _check_backend(name)
    global _default_backend
    _default_backend = name


def msm(scalars: Sequence[int], points: Sequence[hr.Point], backend: str | None = None, device="cuda") -> hr.Point:
    """Dispatching MSM over host scalar/point lists: `backend` "host"
    (`host_msm`) or "device" (`device_msm` on `device`); by default
    `set_default_backend`'s, "host" unless changed."""
    name = backend or _default_backend
    _check_backend(name)
    return device_msm(scalars, points, device) if name == "device" else host_msm(scalars, points)
