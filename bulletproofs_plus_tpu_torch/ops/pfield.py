"""Limb-major point arithmetic: the plain torch twin of csrc/field25519.cuh.

Counterpart of bulletproofs_plus_tpu/ops/pfield.py, the layer the TPU
kernels were written in.  On the GPU that layer is CUDA device code
(csrc/field25519.cuh: field mul/sqr/add/sub/neg, multiply by 2 and by 2d,
`ge_add`, `ge_dbl`, `ge_add4`, `ge_dbl4`); this module is its twin on torch tensors, in the same
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


# ---------------------------------------------------------------------------
# The four-lane schedule of csrc ge_dbl4 and ge_add4.  There a group of four
# lanes shares a point, lane c holding coordinate c of (X, Y, Z, T), and each
# phase is one field operation that the four lanes run on different operands.
# Here the lanes are the leading axis of a (4, ..., 16) stack, a phase is one
# stacked field call, and an exchange is an index operation on that axis.
# Same formulas as `pdbl` and `padd`, and the same limbs.
# ---------------------------------------------------------------------------

_SWAP_PAIRS = [1, 0, 3, 2]  # lane c reads lane c ^ 1
_SWAP_FAR = [2, 3, 0, 1]  # lane c reads lane c ^ 2


def _lanes(p: PointS) -> torch.Tensor:
    """PointS -> (4, ..., 16): lane c holds coordinate c."""
    return torch.stack([c.movedim(0, -1) for c in p])


def _unlanes(v: torch.Tensor) -> PointS:
    return PointS(*(v[c].movedim(-1, 0) for c in range(4)))


def pdbl4(p: PointS) -> PointS:
    """`pdbl` in the lane schedule of csrc ge_dbl4: limb for limb the same."""
    v = _lanes(p)
    # exchange 1: X from lane 0 and Y from lane 1; only lane 3 uses them, for X + Y
    px, py = v[0], v[1]
    # phase 1: lane 0 A = X^2, lane 1 B = Y^2, lane 2 Z^2, lane 3 (X + Y)^2
    sq = F.sqr25519(torch.stack([v[0], v[1], v[2], F.add25519(px, py)]))
    # exchange 2: every lane takes all four squares and forms E, F, G, H as `pdbl` does
    a, b, zz, xy2 = sq[0], sq[1], sq[2], sq[3]
    c = F.add25519(zz, zz)
    ab = F.add25519(a, b)
    e = F.sub25519(xy2, ab)
    g = F.sub25519(b, a)
    f = F.sub25519(g, c)
    h = F.neg25519(ab)
    # phase 2: lane 0 X3 = E F, lane 1 Y3 = G H, lane 2 Z3 = G F, lane 3 T3 = E H
    return _unlanes(F.mul25519(torch.stack([e, g, g, e]), torch.stack([f, h, f, h])))


def padd4(p: PointS, q: PointS) -> PointS:
    """`padd` in the lane schedule of csrc ge_add4: limb for limb the same."""
    vp, vq = _lanes(p), _lanes(q)
    # exchange 1: lane 0 takes Y1 from lane 1, lane 1 takes X2 from lane 0 (lanes 2 and 3 mirror them and
    # ignore it), so that lane 0 holds X1 and Y1, lane 1 X2 and Y2
    got = torch.stack([vq[0], vp[1], vq[2], vp[3]])[_SWAP_PAIRS]
    xx = torch.stack([vp[0], got[1], vp[2], got[3]])
    yy = torch.stack([got[0], vq[1], got[2], vq[3]])
    # sub, add: lane 0 Y1 - X1 and Y1 + X1, lane 1 Y2 - X2 and Y2 + X2
    diff, total = F.sub25519(yy, xx), F.add25519(yy, xx)
    # exchange 2: lane 0 takes Y2 - X2 from lane 1, lane 1 takes Y1 + X1 from lane 0
    other = torch.stack([total[0], diff[1], total[2], diff[3]])[_SWAP_PAIRS]
    # phase 1: lane 0 A = (Y1 - X1)(Y2 - X2), lane 1 B = (Y1 + X1)(Y2 + X2), lane 2 Z1 Z2, lane 3 T1 T2
    m = F.mul25519(torch.stack([diff[0], other[1], vp[2], vp[3]]), torch.stack([other[0], total[1], vq[2], vq[3]]))
    # phase 2: lane 2 D = 2 Z1 Z2, lane 3 C = 2d T1 T2; lanes 0 and 1 multiply by 1, which changes no limb
    m2 = F.mul25519(m, torch.stack([F.limbs_const(k, m[0]).expand(m[0].shape) for k in (1, 1, 2, ed.D2)]))
    # exchange 3: lanes 0 and 1 swap A and B, lanes 2 and 3 D and C; B and D are the minuends
    partner = m2[_SWAP_PAIRS]
    hi = torch.stack([partner[0], m2[1], m2[2], partner[3]])
    lo = torch.stack([m2[0], partner[1], partner[2], m2[3]])
    # sub, add: lanes 0 and 1 E = B - A and H = B + A, lanes 2 and 3 F = D - C and G = D + C
    d, s = F.sub25519(hi, lo), F.add25519(hi, lo)
    # exchange 4: lane 1 takes F from lane 3, lane 3 takes H from lane 1
    far = torch.stack([s[0], s[1], d[2], d[3]])[_SWAP_FAR]
    # phase 3: lane 0 T3 = E H, lane 1 X3 = E F, lane 2 Z3 = F G, lane 3 Y3 = G H
    r = F.mul25519(torch.stack([d[0], d[1], d[2], s[3]]), torch.stack([s[0], far[1], s[2], far[3]]))
    # exchange 5: back to (X, Y, Z, T): lane 0 from lane 1, lane 1 from lane 3, lane 3 from lane 0
    return _unlanes(r[[1, 3, 2, 0]])


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
