"""Host-side (pure Python, arbitrary-precision int) ristretto255 implementation.

This module is the *ground truth* oracle for the device kernels in
``bulletproofs_plus_tpu_torch.ops`` and the host-side setup path (deterministic
generator derivation, hash-to-group) where one-time cost is irrelevant.

It implements the ristretto255 group per RFC 9496 over the twisted Edwards
curve edwards25519 (a = -1), matching the behaviour the reference library
gets from `curve25519-dalek` (see reference src/ristretto.rs:26-76 and
reference src/traits.rs:7-43 for the operations required: compress,
decompress-with-canonicality, from_uniform_bytes, identity, add, scalar mul).

Everything here is variable-time Python — never use it on secret data in
production paths; the device kernels are fixed-shape (effectively constant time).
That includes the fixed-base tables (`fixed_base_table`, `fixed_mul_add`):
which entries a scalar adds, and how many, follow its digits, as the
double-and-add's additions follow its bits.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..utils import trace

# ---------------------------------------------------------------------------
# Field and curve constants (edwards25519 / ristretto255, RFC 7748 / RFC 9496)
# ---------------------------------------------------------------------------

P = 2**255 - 19
# Order of the prime-order (ristretto255) group == order of the ed25519 base
# point subgroup.  This is the scalar field modulus `l`.
L = 2**252 + 27742317777372353535851937790883648493

# Twisted Edwards d = -121665/121666 mod p
D = 37095705934669439343138083508754565189542113879843219016388785533085940283555
assert D == (-121665 * pow(121666, P - 2, P)) % P

# sqrt(-1) mod p, the specific square root used by ristretto255 / dalek
SQRT_M1 = 19681161376707505956807079304988542015446066515923890162744021073123829784752
assert (SQRT_M1 * SQRT_M1) % P == P - 1

# Derived constants for the Elligator map and encoding (RFC 9496 §4.1); all
# derivable from D so there is no extra memorised-constant risk.
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P


def _is_negative(x: int) -> bool:
    """RFC 9496 'negative' == canonical encoding is odd."""
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if _is_negative(x) else x


def sqrt_ratio_m1(u: int, v: int) -> Tuple[bool, int]:
    """Return (was_square, r) with r = sqrt(u/v) or sqrt(i*u/v), RFC 9496 §4.2."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P

    correct_sign_sqrt = check == u
    flipped_sign_sqrt = check == (P - u) % P
    flipped_sign_sqrt_i = check == (P - u) * SQRT_M1 % P

    r_prime = SQRT_M1 * r % P
    if flipped_sign_sqrt or flipped_sign_sqrt_i:
        r = r_prime
    r = _abs(r)
    return (correct_sign_sqrt or flipped_sign_sqrt, r)


# sqrt(a*d - 1) with a = -1, and 1/sqrt(a - d); both defined per RFC 9496 §4.1.
# NOTE the sign convention: RFC 9496 (and curve25519-dalek) pin
# SQRT_AD_MINUS_ONE to the *negative* (odd) square root — sqrt_ratio_m1
# returns the nonnegative one, so negate it.  Getting this wrong leaves every
# round-trip test green while making the Elligator map (and hence every
# derived generator and proof) incompatible with the reference; it is pinned
# by the RFC Appendix A one-way-map vectors in tests/test_host_ristretto.py.
_ok, _sqrt_ad_m1_abs = sqrt_ratio_m1((-D - 1) % P, 1)
assert _ok
SQRT_AD_MINUS_ONE = P - _sqrt_ad_m1_abs
assert (
    SQRT_AD_MINUS_ONE
    == 25063068953384623474111414158702152701244531502492656460079210482610430750235
)  # RFC 9496 §4.1 published value
_ok, INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)
assert _ok
assert (
    INVSQRT_A_MINUS_D
    == 54469307008909316920995813868745141605393597292927456921205312896311721017578
)  # RFC 9496 §4.1 published value


# ---------------------------------------------------------------------------
# Extended twisted Edwards points (X : Y : Z : T), x = X/Z, y = Y/Z, T = XY/Z
# ---------------------------------------------------------------------------

Point = Tuple[int, int, int, int]

IDENTITY: Point = (0, 1, 1, 0)

# ed25519 basepoint (y = 4/5, x even); ristretto255 uses the same basepoint.
BASE_Y = 4 * pow(5, P - 2, P) % P
BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
assert (-BASE_X * BASE_X + BASE_Y * BASE_Y) % P == (1 + D * BASE_X * BASE_X % P * BASE_Y % P * BASE_Y) % P
BASEPOINT: Point = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)


def point_add(p1: Point, p2: Point) -> Point:
    """Complete extended-coordinates addition (add-2008-hwcd-3, a=-1)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * 2 * D % P * t2 % P
    dd = z1 * 2 * z2 % P
    e = (b - a) % P
    f = (dd - c) % P
    g = (dd + c) % P
    h = (b + a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_double(p1: Point) -> Point:
    """dbl-2008-hwcd with a = -1."""
    x1, y1, z1, _ = p1
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    d_ = (-a) % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = (d_ + b) % P
    f = (g - c) % P
    h = (d_ - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def point_neg(p1: Point) -> Point:
    x, y, z, t = p1
    return ((P - x) % P, y, z, (P - t) % P)


def point_mul(k: int, p1: Point) -> Point:
    """Variable-time double-and-add scalar multiplication (host oracle only)."""
    k %= L
    acc = IDENTITY
    while k:
        if k & 1:
            acc = point_add(acc, p1)
        p1 = point_double(p1)
        k >>= 1
    return acc


# A fixed-base table: row w holds j * 2^(8w) * P for j = 1..255 at index j (None
# at 0), each in the cached affine form (y + x, y - x, 2d * x * y); 32 rows
# cover every byte of a scalar reduced mod L.
FIXED_WINDOWS = 32
_D2 = 2 * D % P


def fixed_base_table(p1: Point) -> tuple:
    """The table of `p1` for `fixed_mul_add`: each row's multiples by
    successive additions, every entry brought to Z = 1 by one batch
    inversion (Montgomery's trick) over the whole table."""
    per_row = 255
    points = []
    base = p1
    for _ in range(FIXED_WINDOWS):
        acc = base
        points.append(acc)
        for _ in range(per_row - 1):
            acc = point_add(acc, base)
            points.append(acc)
        base = point_add(acc, base)  # 2^8 times the row's base: the next row's
    prefix = []
    run = 1
    for pt in points:
        prefix.append(run)
        run = run * pt[2] % P
    inv = pow(run, P - 2, P)
    cached = [None] * len(points)
    for i in range(len(points) - 1, -1, -1):
        x, y, z, _ = points[i]
        z_inv = inv * prefix[i] % P
        inv = inv * z % P
        x = x * z_inv % P
        y = y * z_inv % P
        cached[i] = ((y + x) % P, (y - x) % P, _D2 * x % P * y % P)
    return tuple((None,) + tuple(cached[w * per_row : (w + 1) * per_row]) for w in range(FIXED_WINDOWS))


def fixed_mul_add(acc: Point, k: int, table: tuple) -> Point:
    """acc + k * P for the P of `table`: k reduced mod L, one mixed addition
    (madd-2008-hwcd-3, a = -1: 7 products) a nonzero byte, no doubling."""
    x1, y1, z1, t1 = acc
    for row, digit in zip(table, (k % L).to_bytes(32, "little")):
        if digit:
            y_plus_x, y_minus_x, t2d = row[digit]
            a = (y1 - x1) * y_minus_x % P
            b = (y1 + x1) * y_plus_x % P
            c = t1 * t2d % P
            dd = 2 * z1
            e, f, g, h = b - a, dd - c, dd + c, b + a
            x1, y1, z1, t1 = e * f % P, g * h % P, f * g % P, e * h % P
    return (x1, y1, z1, t1)


def point_equal(p1: Point, p2: Point) -> bool:
    """Ristretto equality: X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2 (RFC 9496 §4.3.3)."""
    x1, y1, _, _ = p1
    x2, y2, _, _ = p2
    return (x1 * y2 - y1 * x2) % P == 0 or (y1 * y2 - x1 * x2) % P == 0


def is_identity(p1: Point) -> bool:
    return point_equal(p1, IDENTITY)


# ---------------------------------------------------------------------------
# Ristretto encoding / decoding (RFC 9496 §4.3.1, 4.3.2)
# ---------------------------------------------------------------------------


def compress(p1: Point) -> bytes:
    x, y, z, t = p1
    u1 = (z + y) * (z - y) % P
    u2 = x * y % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t % P
    ix0 = x * SQRT_M1 % P
    iy0 = y * SQRT_M1 % P
    enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
    rotate = _is_negative(t * z_inv % P)
    if rotate:
        x, y = iy0, ix0
        den_inv = enchanted_denominator
    else:
        den_inv = den2
    if _is_negative(x * z_inv % P):
        y = (P - y) % P
    s = _abs(den_inv * ((z - y) % P) % P)
    return s.to_bytes(32, "little")


@trace.timed("ristretto.decompress")
def decompress(data: bytes) -> Optional[Point]:
    """Decode 32 bytes to a point; None if non-canonical / invalid."""
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P:  # non-canonical field encoding
        return None
    if s & 1:  # negative
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P * u1) - u2_sqr) % P
    was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * v % P
    x = _abs(2 * s * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if (not was_square) or _is_negative(t) or y == 0:
        return None
    return (x, y, 1, t)


def elligator_map(r0: int) -> Point:
    """The ristretto255 MAP function (RFC 9496 §4.3.4)."""
    r0 %= P
    r = SQRT_M1 * r0 % P * r0 % P
    n_s = (r + 1) * ONE_MINUS_D_SQ % P
    c = (P - 1) % P
    d_den = (c - D * r) % P * ((r + D) % P) % P
    ns_d_is_sq, s = sqrt_ratio_m1(n_s, d_den)
    s_prime = (P - _abs(s * r0 % P)) % P
    if not ns_d_is_sq:
        s = s_prime
        c = r
    n_t = (c * ((r - 1) % P) % P * D_MINUS_ONE_SQ - d_den) % P
    w0 = 2 * s * d_den % P
    w1 = n_t * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(data: bytes) -> Point:
    """Hash-to-group: two Elligator maps added (RFC 9496 §4.3.4).

    Matches `RistrettoPoint::from_uniform_bytes` used by the reference's
    generator chains (reference src/generators/generators_chain.rs:44-49)
    and SHA3-512 hash-to-point (curve_point_protocol.rs:31-35).
    """
    if len(data) != 64:
        raise ValueError("from_uniform_bytes needs 64 bytes")
    # dalek's FieldElement::from_bytes masks the top bit (takes low 255 bits)
    r0 = int.from_bytes(data[:32], "little") & ((1 << 255) - 1)
    r1 = int.from_bytes(data[32:], "little") & ((1 << 255) - 1)
    return point_add(elligator_map(r0), elligator_map(r1))


# ---------------------------------------------------------------------------
# Scalar field helpers (mod L)
# ---------------------------------------------------------------------------


def scalar_from_bytes_mod_order_wide(data: bytes) -> int:
    if len(data) != 64:
        raise ValueError("wide reduction needs 64 bytes")
    return int.from_bytes(data, "little") % L


def scalar_from_canonical_bytes(data: bytes) -> Optional[int]:
    if len(data) != 32:
        return None
    v = int.from_bytes(data, "little")
    if v >= L:
        return None
    return v


def scalar_to_bytes(v: int) -> bytes:
    return (v % L).to_bytes(32, "little")
