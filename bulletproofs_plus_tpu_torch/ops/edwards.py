"""Batched extended-twisted-Edwards points over GF(2^255-19), plain torch.

Counterpart of bulletproofs_plus_tpu/ops/edwards.py.  Points live in extended
coordinates (X : Y : Z : T) on edwards25519 (a = -1); the addition law is
complete, so one uniform formula covers identity, doubling and generic cases.

A ``PointArray`` is a named tuple of four (..., 16) int64 limb tensors whose
leading axes are batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import field as F
from . import host_ristretto as hr
from .limbs import NLIMBS, int_from_limbs, limbs_from_int


class PointArray(NamedTuple):
    """A batch of Edwards points in extended coordinates."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor


_D2 = 2 * hr.D % hr.P


def identity(batch_shape=(), device="cuda") -> PointArray:
    zero = torch.zeros(tuple(batch_shape) + (NLIMBS,), dtype=torch.int64, device=device)
    one = zero.clone()
    one[..., 0] = 1
    return PointArray(zero, one, one.clone(), zero.clone())


def add(p: PointArray, q: PointArray) -> PointArray:
    """Complete addition, add-2008-hwcd-3 for a = -1 (8M + 1 const-mul).

    The multiplies run as three stacked calls and the add/subs as two: each
    plain torch op is one launch, so fewer, wider ops cost less."""
    ys = torch.stack([p.y, q.y])
    xs = torch.stack([p.x, q.x])
    diffs = F.sub25519(ys, xs)
    sums = F.add25519(ys, xs)
    prods = F.mul25519(
        torch.stack([diffs[0], sums[0], p.t, p.z]),
        torch.stack([diffs[1], sums[1], q.t, q.z]),
    )
    a, b, pt_qt, pz_qz = prods[0], prods[1], prods[2], prods[3]
    c = F.mul25519(pt_qt, F.limbs_const(_D2, pt_qt))
    d = F.mul_small25519(pz_qz, 2)
    ef = F.sub25519(torch.stack([b, d]), torch.stack([a, c]))
    gh = F.add25519(torch.stack([d, b]), torch.stack([c, a]))
    e, f, g, h = ef[0], ef[1], gh[0], gh[1]
    out = F.mul25519(torch.stack([e, g, f, e]), torch.stack([f, h, g, h]))
    return PointArray(out[0], out[1], out[2], out[3])


def double(p: PointArray) -> PointArray:
    """dbl-2008-hwcd, a = -1 (4M + 4S), squares and output multiplies stacked."""
    sq = F.sqr25519(torch.stack([p.x, p.y, p.z, F.add25519(p.x, p.y)]))
    a, b, zz, xy2 = sq[0], sq[1], sq[2], sq[3]
    c = F.mul_small25519(zz, 2)
    ab = F.add25519(a, b)
    eg = F.sub25519(torch.stack([xy2, b]), torch.stack([ab, a]))
    e, g = eg[0], eg[1]
    f = F.sub25519(g, c)
    h = F.neg25519(ab)
    out = F.mul25519(torch.stack([e, g, f, e]), torch.stack([f, h, g, h]))
    return PointArray(out[0], out[1], out[2], out[3])


def select(mask: torch.Tensor, p: PointArray, q: PointArray) -> PointArray:
    """where(mask, p, q); mask shaped like the batch."""
    return PointArray(*(F.select(mask, pc, qc) for pc, qc in zip(p, q)))


def cat(parts, dim: int = 0) -> PointArray:
    """Concatenate PointArrays along a batch axis."""
    return PointArray(*(torch.cat([getattr(p, f) for p in parts], dim=dim) for f in PointArray._fields))


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def from_host(points, device="cuda") -> PointArray:
    """List of host_ristretto points (or one point) -> PointArray on `device`."""
    single = isinstance(points, tuple) and len(points) == 4 and isinstance(points[0], int)
    pts = [points] if single else list(points)
    arrs = [np.stack([limbs_from_int(p[i] % hr.P) for p in pts]).astype(np.int64) for i in range(4)]
    if single:
        arrs = [a[0] for a in arrs]
    return PointArray(*(torch.as_tensor(a, device=device) for a in arrs))


def to_host(p: PointArray):
    """PointArray -> list of host points (or one point if unbatched)."""
    single = p.x.dim() == 1
    arr = [c.detach().cpu().numpy().reshape(-1, NLIMBS) for c in p]
    pts = [tuple(int_from_limbs(arr[c][i]) % hr.P for c in range(4)) for i in range(arr[0].shape[0])]
    return pts[0] if single else pts
