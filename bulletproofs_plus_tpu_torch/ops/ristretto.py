"""Batched ristretto255 decoding and equality (RFC 9496), plain torch.

Counterpart of bulletproofs_plus_tpu/ops/ristretto.py (`compress` belongs to
the prover and is not ported yet).  Decompression handles a whole batch in
one pass; its sqrt-ratio exponent is the pow-chain kernel K4 on CUDA
tensors (field.pow_p58).  Canonicality failures (non-canonical field
element, negative sign, non-square) come back as a boolean mask, like
`CompressedRistretto::decompress` returning `Option`.
"""

from __future__ import annotations

import torch

from . import field as F
from . import host_ristretto as hr
from .edwards import PointArray, identity, select


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """Batched SQRT_RATIO_M1(u, v) -> (was_square mask, r)."""
    sqrt_m1 = F.limbs_const(hr.SQRT_M1, u)
    v3 = F.mul25519(F.sqr25519(v), v)
    v7 = F.mul25519(F.sqr25519(v3), v)
    r = F.mul25519(F.mul25519(u, v3), F.pow25519(F.mul25519(u, v7), (hr.P - 5) // 8))
    check = F.mul25519(v, F.sqr25519(r))
    neg_u = F.neg25519(u)
    correct = F.eq25519(check, u)
    flipped = F.eq25519(check, neg_u)
    flipped_i = F.eq25519(check, F.mul25519(neg_u, sqrt_m1.expand(u.shape)))
    r = F.select(flipped | flipped_i, F.mul25519(r, sqrt_m1.expand(r.shape)), r)
    return correct | flipped, F.abs25519(r)


def decompress(s: torch.Tensor):
    """Batched ristretto decode of (..., 16) limbs of s.

    Returns (PointArray, valid mask); invalid lanes hold the identity.
    Canonicality: s must be < p and even."""
    shape = s.shape[:-1]
    one = F.limbs_const(1, s).expand(s.shape)
    canonical = ~F.geq(s, F.limbs_const(hr.P, s))
    nonneg = (s[..., 0] & 1) == 0

    ss = F.sqr25519(s)
    u1 = F.sub25519(one, ss)
    u2 = F.add25519(one, ss)
    u2_sqr = F.sqr25519(u2)
    d = F.limbs_const(hr.D, s).expand(s.shape)
    v = F.sub25519(F.neg25519(F.mul25519(F.mul25519(d, u1), u1)), u2_sqr)
    was_square, invsqrt = sqrt_ratio_m1(one, F.mul25519(v, u2_sqr))
    den_x = F.mul25519(invsqrt, u2)
    den_y = F.mul25519(F.mul25519(invsqrt, den_x), v)
    x = F.abs25519(F.mul25519(F.mul_small25519(s, 2), den_x))
    y = F.mul25519(u1, den_y)
    t = F.mul25519(x, y)

    ok = canonical & nonneg & was_square & ~F.is_negative25519(t) & ~F.is_zero25519(y)
    pt = PointArray(x, y, one, t)
    return select(ok, pt, identity(shape, device=s.device)), ok


def point_equal(p: PointArray, q: PointArray) -> torch.Tensor:
    """Batched ristretto equality (torsion-insensitive)."""
    c1 = F.eq25519(F.mul25519(p.x, q.y), F.mul25519(p.y, q.x))
    c2 = F.eq25519(F.mul25519(p.y, q.y), F.mul25519(p.x, q.x))
    return c1 | c2


def is_identity(p: PointArray) -> torch.Tensor:
    return point_equal(p, identity(p.x.shape[:-1], device=p.x.device))
