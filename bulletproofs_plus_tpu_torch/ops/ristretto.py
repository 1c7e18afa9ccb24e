"""Batched ristretto255 encoding, decoding and equality (RFC 9496).

Counterpart of bulletproofs_plus_tpu/ops/ristretto.py.  `compress`,
`double_and_compress`, `decompress` and `is_identity` handle a whole batch:
on CUDA tensors each is one launch of its hand-written kernel (C1's two
forms, D1, I1 in csrc/ristretto.cu, by way of ops/cuda_ristretto.py), on CPU
tensors its plain torch twin (`*_plain`), and any other device raises.
`sqrt_ratio_m1` dispatches the same way to K4's fused entry (csrc/pow.cu
`sqrt_ratio_m1_kernel`); the plain twins use its plain version.
Canonicality failures (non-canonical field element, negative sign,
non-square) come back as a boolean mask, like
`CompressedRistretto::decompress` returning `Option`.
"""

from __future__ import annotations

import torch

from . import field as F
from . import host_ristretto as hr
from .cuda_pow import pow_p58_plain, sqrt_ratio_m1_cuda
from .cuda_ristretto import compress_cuda, decompress_cuda, double_compress_cuda, is_identity_cuda
from .edwards import PointArray, identity, select


def sqrt_ratio_m1_plain(u: torch.Tensor, v: torch.Tensor):
    """Batched SQRT_RATIO_M1(u, v) -> (was_square mask, r), plain torch (any
    device): the version the kernel is held against."""
    sqrt_m1 = F.limbs_const(hr.SQRT_M1, u)
    v3 = F.mul25519(F.sqr25519(v), v)
    v7 = F.mul25519(F.sqr25519(v3), v)
    r = F.mul25519(F.mul25519(u, v3), pow_p58_plain(F.mul25519(u, v7)))
    check = F.mul25519(v, F.sqr25519(r))
    neg_u = F.neg25519(u)
    correct = F.eq25519(check, u)
    flipped = F.eq25519(check, neg_u)
    flipped_i = F.eq25519(check, F.mul25519(neg_u, sqrt_m1.expand(u.shape)))
    r = F.select(flipped | flipped_i, F.mul25519(r, sqrt_m1.expand(r.shape)), r)
    return correct | flipped, F.abs25519(r)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor):
    """Batched SQRT_RATIO_M1(u, v) -> (was_square mask, r): one kernel launch
    on CUDA tensors, the plain version on CPU tensors."""
    if v.device.type == "cpu":
        return sqrt_ratio_m1_plain(u, v)
    return sqrt_ratio_m1_cuda(u, v)


def compress(p: PointArray) -> torch.Tensor:
    """Batched ristretto encode -> (..., 16) canonical limbs of s: C1 on
    CUDA tensors, the plain version on CPU tensors."""
    if p.x.device.type == "cpu":
        return compress_plain(p)
    return compress_cuda(p)


def compress_plain(p: PointArray) -> torch.Tensor:
    """Batched ristretto encode -> (..., 16) canonical limbs of s, plain
    torch (any device): C1's twin."""
    one = F.limbs_const(1, p.x).expand(p.x.shape)
    sqrt_m1 = F.limbs_const(hr.SQRT_M1, p.x).expand(p.x.shape)
    u1 = F.mul25519(F.add25519(p.z, p.y), F.sub25519(p.z, p.y))
    u2 = F.mul25519(p.x, p.y)
    _, invsqrt = sqrt_ratio_m1_plain(one, F.mul25519(u1, F.sqr25519(u2)))
    den1 = F.mul25519(invsqrt, u1)
    den2 = F.mul25519(invsqrt, u2)
    z_inv = F.mul25519(F.mul25519(den1, den2), p.t)
    ix0 = F.mul25519(p.x, sqrt_m1)
    iy0 = F.mul25519(p.y, sqrt_m1)
    enchanted = F.mul25519(den1, F.limbs_const(hr.INVSQRT_A_MINUS_D, p.x).expand(p.x.shape))
    rotate = F.is_negative25519(F.mul25519(p.t, z_inv))
    x = F.select(rotate, iy0, p.x)
    y = F.select(rotate, ix0, p.y)
    den_inv = F.select(rotate, enchanted, den2)
    y = F.select(F.is_negative25519(F.mul25519(x, z_inv)), F.neg25519(y), y)
    s = F.abs25519(F.mul25519(den_inv, F.sub25519(p.z, y)))
    return F.canon25519(s)


def double_and_compress(q: PointArray) -> torch.Tensor:
    """Batched ristretto encode of 2Q -> (..., 16) canonical limbs: C1's
    double-and-encode on CUDA tensors, the plain version on CPU tensors.  The
    batched prover encodes this way the points it computes over halved
    generators, whose doubles are the points of the proof."""
    if q.x.device.type == "cpu":
        return double_and_compress_plain(q)
    return double_compress_cuda(q)


def double_and_compress_plain(q: PointArray) -> torch.Tensor:
    """Batched ristretto encode of 2Q, plain torch (any device): the formula
    of C1's double-and-encode (curve25519-dalek's
    `double_and_compress_batch`) with each lane's efgh inverted on its own,
    1 in its place where e = 2XY is 0 (Q in E[4], whose double encodes as 0)."""
    like = q.x
    one = F.limbs_const(1, like).expand(like.shape)
    sqrt_m1 = F.limbs_const(hr.SQRT_M1, like).expand(like.shape)
    dtt = F.mul25519(F.sqr25519(q.t), F.limbs_const(hr.D, like).expand(like.shape))
    zz = F.sqr25519(q.z)
    e = F.mul25519(q.x, F.add25519(q.y, q.y))
    f = F.add25519(zz, dtt)
    g = F.add25519(F.sqr25519(q.y), F.sqr25519(q.x))
    h = F.sub25519(zz, dtt)
    eg, fh = F.mul25519(e, g), F.mul25519(f, h)
    torsion = F.is_zero25519(e)
    inv = F.inv25519(F.select(torsion, one, F.mul25519(eg, fh)))
    zinv, tinv = F.mul25519(eg, inv), F.mul25519(fh, inv)
    rotate = F.is_negative25519(F.mul25519(eg, zinv))
    e1 = F.select(rotate, g, e)
    g1 = F.select(rotate, F.neg25519(e), g)
    h1 = F.select(rotate, F.mul25519(f, sqrt_m1), h)
    magic = F.select(rotate, sqrt_m1, F.limbs_const(hr.INVSQRT_A_MINUS_D, like).expand(like.shape))
    g1 = F.select(F.is_negative25519(F.mul25519(F.mul25519(h1, e1), zinv)), F.neg25519(g1), g1)
    s = F.abs25519(F.mul25519(F.sub25519(h1, g1), F.mul25519(magic, F.mul25519(g1, tinv))))
    return F.select(torsion, torch.zeros_like(s), F.canon25519(s))


def decompress(s: torch.Tensor):
    """Batched ristretto decode of (..., 16) limbs of s -> (PointArray, valid
    mask): D1 on CUDA tensors, the plain version on CPU tensors.  The two
    give the same mask and the same points mod p (D1's coordinates are
    canonical)."""
    if s.device.type == "cpu":
        return decompress_plain(s)
    return decompress_cuda(s)


def decompress_plain(s: torch.Tensor):
    """Batched ristretto decode of (..., 16) limbs of s, plain torch (any
    device): D1's twin.

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
    was_square, invsqrt = sqrt_ratio_m1_plain(one, F.mul25519(v, u2_sqr))
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
    """Whether each point is the ristretto identity: I1 on CUDA tensors, the
    plain version on CPU tensors."""
    if p.x.device.type == "cpu":
        return is_identity_plain(p)
    return is_identity_cuda(p)


def is_identity_plain(p: PointArray) -> torch.Tensor:
    """`point_equal` with the identity, plain torch (any device): I1's twin."""
    return point_equal(p, identity(p.x.shape[:-1], device=p.x.device))
