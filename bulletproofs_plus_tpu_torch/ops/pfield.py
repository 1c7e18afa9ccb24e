"""Limb-major point arithmetic: the plain torch twin of csrc/field25519.cuh.

Counterpart of bulletproofs_plus_tpu/ops/pfield.py, the layer the TPU
kernels were written in.  On the GPU that layer is CUDA device code
(csrc/field25519.cuh: field mul/sqr/add/sub/neg, multiply by 2 and by 2d,
`ge_add`, `ge_dbl`); this module is its twin on torch tensors, in the same
limb-major layout the kernels see: a `PointS` holds four (16, ...) int64
limb tensors.  The kernels' plain versions (ops/cuda_msm.py,
ops/cuda_fixed.py) are written in it.  The field arithmetic itself is
ops/field.py's; the header's carry logic has its own word-exact model in
ops/field_model.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import edwards as ed
from . import field as F


class PointS(NamedTuple):
    """Limb-major Edwards points: 4 coords, each (16, ...) int64."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


class NielsS(NamedTuple):
    """Limb-major affine points precomputed for the mixed addition:
    y + x, y - x and 2d * x * y, each (16, ...) int64.  (1, 1, 0) is the
    identity."""

    yp: torch.Tensor
    ym: torch.Tensor
    t2d: torch.Tensor


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


def madd(p: PointS, q: NielsS) -> PointS:
    """Complete mixed addition (madd-2008-hwcd-3, a = -1, 7M): csrc ge_madd."""
    x, y, z, t = (c.movedim(0, -1) for c in p)
    yp, ym, t2d = (c.movedim(0, -1) for c in q)
    prods = F.mul25519(torch.stack([F.sub25519(y, x), F.add25519(y, x), t]), torch.stack([ym, yp, t2d]))
    a, b, c = prods[0], prods[1], prods[2]
    d = F.mul_small25519(z, 2)
    ef = F.sub25519(torch.stack([b, d]), torch.stack([a, c]))
    gh = F.add25519(torch.stack([d, b]), torch.stack([c, a]))
    e, f, g, h = ef[0], ef[1], gh[0], gh[1]
    out = F.mul25519(torch.stack([e, g, f, e]), torch.stack([f, h, g, h]))
    return PointS(*(out[i].movedim(-1, 0) for i in range(4)))


def from_niels(q: NielsS) -> PointS:
    """identity + q with the constants folded (1M): csrc ge_from_niels,
    (2(yp - ym) : 2(yp + ym) : 4 : (yp - ym)(yp + ym))."""
    yp, ym = q.yp.movedim(0, -1), q.ym.movedim(0, -1)
    e, h = F.sub25519(yp, ym), F.add25519(yp, ym)
    four = F.limbs_const(4, yp).expand(yp.shape)
    out = (F.mul_small25519(e, 2), F.mul_small25519(h, 2), four, F.mul25519(e, h))
    return PointS(*(c.movedim(-1, 0) for c in out))


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
