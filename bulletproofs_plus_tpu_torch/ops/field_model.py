"""Word-exact model of csrc/field25519.cuh in plain Python.

The CUDA field code cannot run without a card, and its carry logic is where
it can go wrong.  This module repeats that file step by step on eight
32-bit words, every PTX carry-flag instruction a method of `Carry` with the
flag as its state, every loop in the order of the CUDA loop.  Where the CUDA
code relies on a bound (a carry that cannot occur, a word that cannot
overflow), the model asserts it.  The kernels' own functions follow in the
same way: K4's chain and SQRT_RATIO_M1 (csrc/sqrt_ratio.cuh), D1, C1 and I1
(csrc/ristretto.cu), and C1's double-and-encode with its inversion mod p by
divsteps (`fe_inv`, csrc/divsteps.cuh, on ops/scalar_model.py's divsteps
steps), and the four-lane product of K4's chain lane by lane
(`fe_mul4_lanes`).  tests/test_torch_field.py holds the model against Python integers,
tests/test_torch_ristretto.py its D1, C1 (both forms), I1 and `fe_inv`
against the JAX package and Python integers; nothing else uses it.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
P = 2**255 - 19


class Carry:
    """The PTX carry flag CC.CF and the PTX operations that read or set it."""

    def __init__(self):
        self.cf = 0

    def _set(self, wide: int) -> int:
        self.cf = (wide >> 32) & 1
        assert wide >> 33 == 0
        return wide & M32

    def add_cc(self, a, b):
        return self._set(a + b)

    def addc_cc(self, a, b):
        return self._set(a + b + self.cf)

    def addc(self, a, b):
        wide = a + b + self.cf
        assert wide <= M32, "addc dropped a carry"
        return wide

    def _borrow(self, diff: int) -> int:
        self.cf = 1 if diff < 0 else 0
        return diff & M32

    def sub_cc(self, a, b):
        return self._borrow(a - b)

    def subc_cc(self, a, b):
        return self._borrow(a - b - self.cf)

    def subc(self, a, b):
        return (a - b - self.cf) & M32

    def mad_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c)

    def madc_lo_cc(self, a, b, c):
        return self._set(((a * b) & M32) + c + self.cf)

    def madc_hi_cc(self, a, b, c):
        return self._set(((a * b) >> 32) + c + self.cf)

    def mad_hi_cc(self, a, b, c):
        return self._set(((a * b) >> 32) + c)

    def madc_lo(self, a, b, c):  # the carry out is dropped, as PTX drops it
        return (((a * b) & M32) + c + self.cf) & M32

    def madc_hi(self, a, b, c):  # the carry out is dropped, as PTX drops it
        return (((a * b) >> 32) + c + self.cf) & M32


def to_words(value: int) -> list:
    if not 0 <= value < 2**256:
        raise ValueError("a field element is a value below 2^256")
    return [(value >> (32 * k)) & M32 for k in range(8)]


def from_words(words) -> int:
    assert len(words) == 8 and all(0 <= w <= M32 for w in words)
    return sum(w << (32 * k) for k, w in enumerate(words))


def fe_fold_top(cc: Carry, r: list, c: int) -> None:
    assert c < 1 << 26
    r[0] = cc.add_cc(r[0], 38 * c)
    for k in range(1, 8):
        r[k] = cc.addc_cc(r[k], 0)
    last = r[0] + 38 * cc.addc(0, 0)
    assert last <= M32, "the last 38 carried"
    r[0] = last


def fe_add(a: list, b: list) -> list:
    cc = Carry()
    r = [0] * 8
    r[0] = cc.add_cc(a[0], b[0])
    for k in range(1, 8):
        r[k] = cc.addc_cc(a[k], b[k])
    fe_fold_top(cc, r, cc.addc(0, 0))
    return r


def fe_sub(a: list, b: list) -> list:
    cc = Carry()
    r = [0] * 8
    r[0] = cc.sub_cc(a[0], b[0])
    for k in range(1, 8):
        r[k] = cc.subc_cc(a[k], b[k])
    r[0] = cc.sub_cc(r[0], 38 & cc.subc(0, 0))
    for k in range(1, 8):
        r[k] = cc.subc_cc(r[k], 0)
    last = r[0] - (38 & cc.subc(0, 0))
    assert last >= 0, "the last 38 borrowed"
    r[0] = last
    return r


def fe_neg(a: list) -> list:
    return fe_sub([0] * 8, a)


def _mad_pair(cc: Carry, acc: list, p: int, x: int, y: int, first: bool) -> None:
    acc[p] = cc.mad_lo_cc(x, y, acc[p]) if first else cc.madc_lo_cc(x, y, acc[p])
    acc[p + 1] = cc.madc_hi_cc(x, y, acc[p + 1])


def _mad_chain_end(cc: Carry, acc: list, p: int) -> None:
    if p < 16:
        acc[p] = cc.addc(acc[p], 0)
    else:
        assert cc.cf == 0, "a carry left the accumulator"


def fe_reduce_wide(cc: Carry, e: list, o: list) -> list:
    assert o[15] == 0
    t = [0] * 16
    t[0] = e[0]
    t[1] = cc.add_cc(e[1], o[0])
    for k in range(2, 16):
        t[k] = cc.addc_cc(e[k], o[k - 1])
    assert cc.cf == 0, "the product reached 2^512"
    return _fold_wide(cc, t)


def wide_mul(a: list, b: list):
    """The two accumulators of fe_mul before the reduction: (e, o)."""
    cc = Carry()
    e, o = [0] * 16, [0] * 16
    for i in range(8):
        j0 = i & 1
        j1 = 1 - j0
        for j in range(j0, 8, 2):
            _mad_pair(cc, e, i + j, a[j], b[i], j == j0)
        _mad_chain_end(cc, e, i + j0 + 8)
        for j in range(j1, 8, 2):
            _mad_pair(cc, o, i + j - 1, a[j], b[i], j == j1)
        _mad_chain_end(cc, o, i + j1 + 7)
    return e, o


def fe_mul(a: list, b: list) -> list:
    e, o = wide_mul(a, b)
    return fe_reduce_wide(Carry(), e, o)


def wide_sqr(a: list):
    """The two accumulators of fe_sqr before the reduction: (e, o)."""
    cc = Carry()
    d = [0] * 9
    d[0] = (a[0] << 1) & M32
    for k in range(1, 8):
        d[k] = ((a[k] << 1) & M32) | (a[k - 1] >> 31)
    d[8] = a[7] >> 31
    e, o = [0] * 16, [0] * 16
    for i in range(8):
        m = [a[i] if j == i else ((a[j] << 1) & M32) if (j == i + 1 and j < 8) else d[j] for j in range(9)]
        last = 7 if i == 7 else 8
        j0, j1 = i, i + 1
        for j in range(j0, last + 1, 2):
            _mad_pair(cc, e, i + j, a[i], m[j], j == j0)
        _mad_chain_end(cc, e, i + j0 + 2 * ((last - j0) // 2) + 2)
        for j in range(j1, last + 1, 2):
            _mad_pair(cc, o, i + j - 1, a[i], m[j], j == j1)
        if j1 <= last:
            _mad_chain_end(cc, o, i + j1 + 2 * ((last - j1) // 2) + 1)
    return e, o


def fe_sqr(a: list) -> list:
    e, o = wide_sqr(a)
    return fe_reduce_wide(Carry(), e, o)


def wide_value(e: list, o: list) -> int:
    """The integer the two accumulators hold."""
    return sum(w << (32 * k) for k, w in enumerate(e)) + sum(w << (32 * (k + 1)) for k, w in enumerate(o))


def fe_canon(a: list) -> list:
    cc = Carry()
    r = list(a)
    q = r[7] >> 31
    r[7] &= 0x7FFFFFFF
    r[0] = cc.add_cc(r[0], 19 * q)
    for k in range(1, 7):
        r[k] = cc.addc_cc(r[k], 0)
    r[7] = cc.addc(r[7], 0)
    t = [0] * 8
    t[0] = cc.add_cc(r[0], 19)
    for k in range(1, 7):
        t[k] = cc.addc_cc(r[k], 0)
    t[7] = cc.addc(r[7], 0)
    ge_p = (t[7] >> 31) != 0
    t[7] &= 0x7FFFFFFF
    return t if ge_p else r


def fe_eq(a: list, b: list) -> bool:
    ca, cb = fe_canon(a), fe_canon(b)
    diff = 0
    for k in range(8):
        diff |= ca[k] ^ cb[k]
    return diff == 0


def fe_is_negative(a: list) -> bool:
    return (fe_canon(a)[0] & 1) != 0


def fe_select(c: bool, a: list, b: list) -> list:
    return list(a) if c else list(b)


def fe_abs(a: list) -> list:
    c = fe_canon(a)
    return fe_select((c[0] & 1) != 0, fe_canon(fe_neg(c)), c)


def _fold_wide(cc: Carry, t: list) -> list:
    """field25519.cuh fe_fold_wide: 16 words (a value below 2^512) -> 8."""
    s = [t[k + 8] * 38 + t[k] for k in range(8)]
    r = [0] * 8
    r[0] = s[0] & M32
    r[1] = cc.add_cc(s[1] & M32, s[0] >> 32)
    for k in range(2, 8):
        r[k] = cc.addc_cc(s[k] & M32, s[k - 1] >> 32)
    fe_fold_top(cc, r, cc.addc(s[7] >> 32, 0))
    return r


def fe_mul4_lanes(a: list, b: list):
    """csrc/sqrt_ratio.cuh `FourLanes::mul` (D1's and C1's four-lane product;
    its squaring is mul(a, a)), lane by lane: each lane t's share, a times
    words 2t and 2t + 1 of b as ten words `p` to be weighed by 2^(64 t); the
    first shuffle round's sums in lanes 0 and 2, p_t + 2^64 p_(t+1) as
    twelve words; the second's in lane 0, the whole 512-bit product `w` as
    sixteen; and the folded eight words every lane receives from lane 0.
    -> (shares, (s_0, s_2), w, r)."""
    shares = []
    for t in range(4):
        cc = Carry()
        e, o = [0] * 16, [0] * 16
        for i, y in enumerate((b[2 * t], b[2 * t + 1])):  # fe_mul_row(e, o, a, y, i)
            j0 = i & 1
            j1 = 1 - j0
            for j in range(j0, 8, 2):
                _mad_pair(cc, e, i + j, a[j], y, j == j0)
            _mad_chain_end(cc, e, i + j0 + 8)
            for j in range(j1, 8, 2):
                _mad_pair(cc, o, i + j - 1, a[j], y, j == j1)
            _mad_chain_end(cc, o, i + j1 + 7)
        p = [0] * 10
        p[0] = e[0]
        p[1] = cc.add_cc(e[1], o[0])
        for k in range(2, 10):
            p[k] = cc.addc_cc(e[k], o[k - 1])
        shares.append(p)
    pairs = []
    for t in (0, 2):  # s = p + W^2 * (the next lane's p)
        cc = Carry()
        p, got = shares[t], shares[t + 1]
        s = p[:2] + [cc.add_cc(p[2], got[0])] + [cc.addc_cc(p[k], got[k - 2]) for k in range(3, 10)]
        s += [cc.addc_cc(0, got[8]), cc.addc(0, got[9])]
        pairs.append(s)
    cc = Carry()
    s, got = pairs
    w = s[:4] + [cc.add_cc(s[4], got[0])] + [cc.addc_cc(s[k], got[k - 4]) for k in range(5, 12)]
    w += [cc.addc_cc(0, got[k - 4]) for k in range(12, 15)] + [cc.addc(0, got[11])]
    return shares, tuple(pairs), w, _fold_wide(Carry(), w)


def fe_sqr_n(x: list, n: int) -> list:
    for _ in range(n):
        x = fe_sqr(x)
    return x


def fe_pow_p58(v: list) -> list:
    """csrc/sqrt_ratio.cuh fe_pow_p58: v^(2^252 - 3)."""
    z2 = fe_sqr(v)
    z9 = fe_mul(v, fe_sqr_n(z2, 2))
    z11 = fe_mul(z2, z9)
    z_5_0 = fe_mul(z9, fe_sqr(z11))
    z_10_0 = fe_mul(fe_sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = fe_mul(fe_sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = fe_mul(fe_sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = fe_mul(fe_sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = fe_mul(fe_sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = fe_mul(fe_sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = fe_mul(fe_sqr_n(z_200_0, 50), z_50_0)
    return fe_mul(fe_sqr_n(z_250_0, 2), v)


SQRT_M1 = pow(2, (P - 1) // 4, P)


def sqrt_ratio_m1(u: list, v: list):
    """csrc/sqrt_ratio.cuh fe_sqrt_ratio_m1 for one element: (was_square, r)."""
    sqrt_m1 = to_words(SQRT_M1)
    v3 = fe_mul(fe_sqr(v), v)
    v7 = fe_mul(fe_sqr(v3), v)
    r = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)))
    check = fe_mul(v, fe_sqr(r))
    neg_u = fe_neg(u)
    correct = fe_eq(check, u)
    flipped = fe_eq(check, neg_u)
    flipped_i = fe_eq(check, fe_mul(neg_u, sqrt_m1))
    r = fe_select(flipped or flipped_i, fe_mul(r, sqrt_m1), r)
    return correct or flipped, fe_abs(r)


# ---------------------------------------------------------------------------
# csrc/ristretto.cu: D1, C1 and I1 for one element, in the kernels' order
# ---------------------------------------------------------------------------

D = (-121665 * pow(121666, P - 2, P)) % P
INVSQRT_A_MINUS_D = 0x786C8905CFAFFCA216C27B91FE01D8409D2F16175A4172BE99C8FDAA805D40EA


def fe_is_zero(a: list) -> bool:
    any_word = 0
    for w in fe_canon(a):
        any_word |= w
    return any_word == 0


def fe_below_p(s: list) -> bool:
    """ristretto.cu fe_below_p: s + 19 on the raw words, no carry out of
    word 7 and bit 255 clear."""
    cc = Carry()
    top = cc.add_cc(s[0], 19)
    for k in range(1, 8):
        top = cc.addc_cc(s[k], 0)
    carry = cc.addc(0, 0)
    return carry == 0 and (top >> 31) == 0


def decompress_words(s: list):
    """ristretto.cu ristretto_decode: (ok, [x, y, z, t]), the coordinates
    canonical with z = 1, the identity where ok is false."""
    one = to_words(1)
    canonical = fe_below_p(s)
    nonneg = (s[0] & 1) == 0
    ss = fe_sqr(s)
    u1 = fe_sub(one, ss)
    u2 = fe_add(one, ss)
    u2_sqr = fe_sqr(u2)
    v = fe_sub(fe_neg(fe_mul(fe_mul(to_words(D), u1), u1)), u2_sqr)
    was_square, invsqrt = sqrt_ratio_m1(one, fe_mul(v, u2_sqr))
    den_x = fe_mul(invsqrt, u2)
    den_y = fe_mul(fe_mul(invsqrt, den_x), v)
    x = fe_abs(fe_mul(fe_add(s, s), den_x))
    y = fe_mul(u1, den_y)
    t = fe_mul(x, y)
    ok = canonical and nonneg and was_square and not fe_is_negative(t) and not fe_is_zero(y)
    zero = [0] * 8
    return ok, [fe_select(ok, x, zero), fe_select(ok, fe_canon(y), one), one, fe_select(ok, fe_canon(t), zero)]


def compress_words(x: list, y: list, z: list, t: list) -> list:
    """ristretto.cu ristretto_encode: the canonical s."""
    sqrt_m1 = to_words(SQRT_M1)
    u1 = fe_mul(fe_add(z, y), fe_sub(z, y))
    u2 = fe_mul(x, y)
    _, invsqrt = sqrt_ratio_m1(to_words(1), fe_mul(u1, fe_sqr(u2)))
    den1 = fe_mul(invsqrt, u1)
    den2 = fe_mul(invsqrt, u2)
    z_inv = fe_mul(fe_mul(den1, den2), t)
    ix0 = fe_mul(x, sqrt_m1)
    iy0 = fe_mul(y, sqrt_m1)
    enchanted = fe_mul(den1, to_words(INVSQRT_A_MINUS_D))
    rotate = fe_is_negative(fe_mul(t, z_inv))
    x2 = fe_select(rotate, iy0, x)
    y2 = fe_select(rotate, ix0, y)
    den_inv = fe_select(rotate, enchanted, den2)
    y2 = fe_select(fe_is_negative(fe_mul(x2, z_inv)), fe_neg(y2), y2)
    return fe_abs(fe_mul(den_inv, fe_sub(z, y2)))


def is_identity_words(x: list, y: list) -> bool:
    """ristretto.cu is_identity_kernel: X or Y is 0 mod p."""
    return fe_is_zero(x) or fe_is_zero(y)


def horner_identity_lanes(coords: list) -> bool:
    """msm.cu horner_kernel's tail, lane by lane: lanes 0-3 hold the sum's
    X, Y, Z, T (8 words each), every lane tests its coordinate with
    fe_is_zero, and lane 0 joins its test with lane 1's (a shuffle down by
    one)."""
    zero = [fe_is_zero(c) for c in coords]
    return zero[0] or zero[1]


# ---------------------------------------------------------------------------
# csrc/divsteps.cuh fe_inv and csrc/ristretto.cu double_compress_kernel
# ---------------------------------------------------------------------------

DC_THREADS = 32  # the double-and-encode's block: one warp


def fe_inv(x: list) -> list:
    """divsteps.cuh fe_inv: x^-1 mod p, canonical (inv(0) = 0), by a fixed
    DS_BATCHES batches of 30 divsteps whatever the input: f = p, g = the
    canonical x, d = 0, e = 1, each batch one 2 x 2 matrix applied to (f, g)
    and (d, e); then f = +-1 and x^-1 = +-d."""
    from . import scalar_model as sm

    c = fe_canon(x)
    f, g = sm._s30(P), sm.words_to_s30(c)
    d, e = [0] * 9, [1] + [0] * 8
    zeta = -1
    for _ in range(sm.INV_BATCHES):
        zeta, t = sm.divsteps_30(zeta, f[0], g[0])
        d, e = sm._update_de(d, e, t, P)
        f, g = sm._update_fg(f, g, t)
    assert not any(g) and sm._s30_value(f) in ((1, -1) if any(c) else (P,))
    return sm.s30_to_words(sm._normalize(d, f[8], P))


def double_compress_words(points: list) -> list:
    """ristretto.cu double_compress_kernel: the canonical encodings of 2Q for
    n points Q = [x, y, z, t] (words), block by block of DC_THREADS lanes:
    each lane's e, f, g, h and efgh (1 where e is 0 and past n), the
    butterfly of products over the warp, one fe_inv a lane of the warp's
    product, the way down by the siblings' products, then the tail."""
    n = len(points)
    out = []
    for base in range(0, n, DC_THREADS):
        lanes = []
        for lane in range(DC_THREADS):
            x, y, z, t = points[min(base + lane, n - 1)]
            xx, yy, zz = fe_sqr(x), fe_sqr(y), fe_sqr(z)
            dtt = fe_mul(fe_sqr(t), to_words(D))
            e = fe_mul(x, fe_add(y, y))
            f, g, h = fe_add(zz, dtt), fe_add(yy, xx), fe_sub(zz, dtt)
            eg, fh = fe_mul(e, g), fe_mul(f, h)
            torsion = fe_is_zero(e)
            acc = fe_select(torsion or base + lane >= n, to_words(1), fe_mul(eg, fh))
            lanes.append({"e": e, "f": f, "g": g, "h": h, "eg": eg, "fh": fh, "torsion": torsion, "acc": acc,
                          "sib": []})
        for k in range(5):
            sibs = [lanes[lane ^ (1 << k)]["acc"] for lane in range(DC_THREADS)]
            for lane, sib in zip(lanes, sibs):
                lane["sib"].append(sib)
                lane["acc"] = fe_mul(lane["acc"], sib)
        for lane in lanes[: n - base]:
            inv = fe_inv(lane["acc"])
            for k in range(4, -1, -1):
                inv = fe_mul(inv, lane["sib"][k])
            e, f, g, h, eg, fh = (lane[k] for k in ("e", "f", "g", "h", "eg", "fh"))
            zinv, tinv = fe_mul(eg, inv), fe_mul(fh, inv)
            rotate = fe_is_negative(fe_mul(eg, zinv))
            sqrt_m1 = to_words(SQRT_M1)
            e1 = fe_select(rotate, g, e)
            g1 = fe_select(rotate, fe_neg(e), g)
            h1 = fe_select(rotate, fe_mul(f, sqrt_m1), h)
            magic = fe_select(rotate, sqrt_m1, to_words(INVSQRT_A_MINUS_D))
            g1 = fe_select(fe_is_negative(fe_mul(fe_mul(h1, e1), zinv)), fe_neg(g1), g1)
            s = fe_abs(fe_mul(fe_sub(h1, g1), fe_mul(magic, fe_mul(g1, tinv))))
            out.append(fe_select(lane["torsion"], [0] * 8, s))
    return out
