"""Limb-major point arithmetic: the plain torch twin of csrc/field25519.cuh.

Counterpart of bulletproofs_plus_tpu/ops/pfield.py, the layer the TPU
kernels were written in.  On the GPU that layer is CUDA device code
(csrc/field25519.cuh: field mul/sqr/add/sub/neg, multiply by 2 and by 2d,
`ge_add`, `ge_dbl`); this module is its twin on torch tensors, in the same
limb-major layout the kernels see: a `PointS` holds four (16, ...) int64
limb tensors.  The kernels' plain versions (ops/cuda_msm.py) are written in
it.  The field arithmetic itself is ops/field.py's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import edwards as ed


class PointS(NamedTuple):
    """Limb-major Edwards points: 4 coords, each (16, ...) int64."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


def from_coords(coords: torch.Tensor) -> PointS:
    """(4, 16, ...) tensor -> PointS (views)."""
    return PointS(*coords.unbind(0))


def to_coords(p: PointS) -> torch.Tensor:
    """PointS -> contiguous (4, 16, ...) tensor."""
    return torch.stack(list(p)).contiguous()


def identity(trail, device="cuda") -> PointS:
    return _from_minor(ed.identity(tuple(trail), device=device))


def _to_minor(p: PointS) -> ed.PointArray:
    return ed.PointArray(*(c.movedim(0, -1) for c in p))


def _from_minor(p: ed.PointArray) -> PointS:
    return PointS(*(c.movedim(-1, 0) for c in p))


def padd(p: PointS, q: PointS) -> PointS:
    """Complete addition (add-2008-hwcd-3, a = -1): csrc ge_add."""
    return _from_minor(ed.add(_to_minor(p), _to_minor(q)))


def pdbl(p: PointS) -> PointS:
    """Doubling (dbl-2008-hwcd, a = -1): csrc ge_dbl."""
    return _from_minor(ed.double(_to_minor(p)))


def lane_halve_sum(p: PointS, axis: int, width: int) -> PointS:
    """Sum over trailing axis `axis` (counted on the (16, ...) coords; a power
    of two `width`) by log2(width) halving additions; keeps the axis, width 1."""
    if width & (width - 1):
        raise ValueError("width must be a power of two")
    w = width
    while w > 1:
        w //= 2
        p = padd(PointS(*(c.narrow(axis, 0, w) for c in p)), PointS(*(c.narrow(axis, w, w) for c in p)))
    return p
