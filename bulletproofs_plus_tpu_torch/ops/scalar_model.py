"""Word-exact model of csrc/scalar_l.cuh in plain Python: the reduction of a
512-bit value mod l on 32-bit words, and the GF(l) arithmetic on it that S1
(csrc/scalar_pass.cu) and P1-P3 (csrc/prover.cu) compute with.

Like ops/field_model.py for csrc/field25519.cuh: the CUDA code cannot run
without a card, and its carry logic is where it can go wrong.  Every PTX
carry-flag instruction is a method of `field_model.Carry`, every loop runs in
the order of the CUDA loop, and every bound the CUDA code relies on (a carry
that cannot occur, a remainder below 2l) is asserted.  ops/cuda_replay.py's
`replay_model` runs R1's epilogue through `reduce_fold`, and
ops/cuda_scalar.py's `scalar_pass_model` runs S1's programs on `mul_l`,
`sqr_l`, `add_l`, `sub_l` and `inv_l`, and ops/cuda_transcript.py's
`transcript_model` T1's inverses on `inv_l_var` (the warp's variable-time
inversion, lane by lane); tests/test_torch_replay.py holds the reduction
against Python integers and the torch and JAX `reduce_wide_l`,
tests/test_torch_scalar.py the field operations and
tests/test_torch_transcript.py `inv_l_var` against Python integers.

The reduction folds 2^252 = -delta (mod l) three times, delta = l - 2^252
being below 2^125 (`reduce_fold`).
"""

from __future__ import annotations

import functools

from .field_model import M32, Carry

L = 2**252 + 27742317777372353535851937790883648493
N = 9  # words of the fold's sums


def to_words(value: int, n: int) -> list:
    if not 0 <= value < 1 << (32 * n):
        raise ValueError(f"a value of {n} words is below 2^{32 * n}")
    return [(value >> (32 * k)) & M32 for k in range(n)]


def from_words(words) -> int:
    assert all(0 <= w <= M32 for w in words)
    return sum(w << (32 * k) for k, w in enumerate(words))


L_WORDS = to_words(L, N)
DELTA = L - 2**252  # below 2^125: l = 2^252 + delta
DELTA_WORDS = to_words(DELTA, 4)
M30 = (1 << 30) - 1
L_S30 = [(L >> (30 * i)) & M30 for i in range(9)]  # l in nine 30-bit limbs, SC_L_S30
L_INV30 = pow(L, -1, 1 << 30)  # l^-1 mod 2^30, SC_L_INV30
INV_BATCHES = 20  # 600 divsteps: 590 suffice for any modulus and input below 2^256


def mul_wide(cc: Carry, a: list, b: list) -> list:
    """a * b, len(a) + len(b) words: each row adds its low halves in one carry
    chain and its high halves in another, one word up."""
    na, nb = len(a), len(b)
    assert nb >= 2
    r = [0] * (na + nb)
    for i in range(na):
        r[i] = cc.mad_lo_cc(a[i], b[0], r[i])
        for j in range(1, nb):
            r[i + j] = cc.madc_lo_cc(a[i], b[j], r[i + j])
        assert r[i + nb] == 0, "a word above the rows so far was set"
        r[i + nb] = cc.addc(r[i + nb], 0)
        r[i + 1] = cc.mad_hi_cc(a[i], b[0], r[i + 1])
        for j in range(1, nb - 1):
            r[i + j + 1] = cc.madc_hi_cc(a[i], b[j], r[i + j + 1])
        assert ((a[i] * b[nb - 1]) >> 32) + r[i + nb] + cc.cf <= M32, "a row carried out of its top word"
        r[i + nb] = cc.madc_hi(a[i], b[nb - 1], r[i + nb])
    return r


def _csub_l(cc: Carry, r: list) -> list:
    """r - l if that does not borrow, else r (a select on the borrow mask)."""
    t = [0] * N
    t[0] = cc.sub_cc(r[0], L_WORDS[0])
    for k in range(1, N):
        t[k] = cc.subc_cc(r[k], L_WORDS[k])
    borrow = cc.subc(0, 0)
    return list(r) if borrow else t


# ---------------------------------------------------------------------------
# GF(l) on 8 words (S1, P1-P3)
# ---------------------------------------------------------------------------


def _shr252(x: list, n: int) -> list:
    """Words 0..n-1 of x >> 252: a funnel shift by 28 of words 7 + i and 8 + i."""
    return [((x[7 + i] >> 28) | ((x[8 + i] if 8 + i < len(x) else 0) << 4)) & M32 for i in range(n)]


def _low252(x: list) -> list:
    return list(x[:7]) + [x[7] & 0x0FFFFFFF]


def _add_words(cc: Carry, a: list, b: list) -> list:
    """a + b on len(a) words, len(b) <= len(a), the carry out of the top word asserted away."""
    b = list(b) + [0] * (len(a) - len(b))
    r = [cc.add_cc(a[0], b[0])] + [cc.addc_cc(a[k], b[k]) for k in range(1, len(a) - 1)]
    return r + [cc.addc(a[-1], b[-1])]


def _sub_words(cc: Carry, a: list, b: list) -> list:
    """a - b on len(a) words, len(b) <= len(a), a borrow out of the top word asserted away."""
    b = list(b) + [0] * (len(a) - len(b))
    r = [cc.sub_cc(a[0], b[0])] + [cc.subc_cc(a[k], b[k]) for k in range(1, len(a))]
    assert cc.cf == 0, "a difference went below zero"
    return r


def reduce_fold(t: list) -> list:
    """t, 16 little-endian words (any value below 2^512) -> t mod l as 8
    words, as Scalar::from_bytes_mod_order_wide gives it, by folding
    2^252 = -delta (mod l) three times (sc_reduce_fold):
      t = H1 2^252 + L1             -> t = L1 - H1 delta, H1 delta = X1 < 2^385;
      X1 = H2 2^252 + L2            -> t = L1 - L2 + X2 (mod l), X2 = H2 delta < 2^258;
      v = L1 + l - L2 + X2, in [0, 2^260): v = H3 2^252 + L3, H3 < 2^8;
      r = L3 + l - H3 delta, in (l - 2^133, l + 2^252): one conditional subtraction of l."""
    assert len(t) == 16
    cc = Carry()
    x1 = mul_wide(cc, _shr252(t, 9), DELTA_WORDS)
    assert from_words(x1) < 1 << 385
    h2 = _shr252(x1, 5)
    assert h2[4] >> 5 == 0
    x2 = mul_wide(cc, h2, DELTA_WORDS)
    assert from_words(x2) < 1 << 258
    v = _add_words(cc, x2, L_WORDS)  # X2 + l, nine words
    v = _add_words(cc, v, _low252(t))
    v = _sub_words(cc, v, _low252(x1))
    assert from_words(v) < 1 << 260
    h3 = (v[7] >> 28) | ((v[8] << 4) & M32)
    x3 = mul_wide(cc, [h3], DELTA_WORDS)
    r = _add_words(cc, _low252(v) + [0], L_WORDS)  # L3 + l below 2^254
    r = _sub_words(cc, r, x3)
    assert L - (1 << 133) < from_words(r) < L + (1 << 252)
    r = _csub_l(cc, r)
    assert from_words(r) < L and r[8] == 0
    return r[:8]


def mul_l(a: list, b: list) -> list:
    """sc_mul_l: a * b mod l for 8-word a and b below 2^256."""
    assert len(a) == 8 and len(b) == 8
    return reduce_fold(mul_wide(Carry(), a, b))


def sqr_l(a: list) -> list:
    """sc_sqr_l."""
    return mul_l(a, a)


def add_l(a: list, b: list) -> list:
    """sc_add_l: a + b on nine words, less l where that does not borrow, the
    low eight words kept (ops/field.py's add_l)."""
    cc = Carry()
    s = [0] * N
    s[0] = cc.add_cc(a[0], b[0])
    for k in range(1, 8):
        s[k] = cc.addc_cc(a[k], b[k])
    s[8] = cc.addc(0, 0)
    return _csub_l(cc, s)[:8]


def sub_l(a: list, b: list) -> list:
    """sc_sub_l: a - b, plus l mod 2^256 where that borrows (ops/field.py's
    sub_l)."""
    cc = Carry()
    t = [0] * 8
    t[0] = cc.sub_cc(a[0], b[0])
    for k in range(1, 8):
        t[k] = cc.subc_cc(a[k], b[k])
    mask = cc.subc(0, 0)
    r = [0] * 8
    r[0] = cc.add_cc(t[0], L_WORDS[0] & mask)
    for k in range(1, 7):
        r[k] = cc.addc_cc(t[k], L_WORDS[k] & mask)
    r[7] = (t[7] + (L_WORDS[7] & mask) + cc.cf) & M32  # addc: the carry out of 2^256 is dropped
    if mask == 0:
        assert r == t
    return r


# ---------------------------------------------------------------------------
# The inverse mod l: Bernstein-Yang divsteps on signed 30-bit limbs (sc_inv_l_warp)
# ---------------------------------------------------------------------------


def _i32(v: int) -> int:
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def _s30_value(s: list) -> int:
    return sum(v << (30 * i) for i, v in enumerate(s))


def divsteps_30(zeta: int, f0: int, g0: int):
    """divsteps.cuh divsteps_30: 30 divsteps on the low words of f and g (f odd), zeta
    = -(delta + 1/2); returns zeta and the transition matrix (u, v, q, r),
    each in [-2^30, 2^30], scaled by 2^30.  Each step is selects on two
    conditions, zeta < 0 and g odd: g (and q, r) gains f (u, v) negated
    where zeta < 0, where g is odd; where both hold, f (u, v) takes the old
    g (q, r) and zeta becomes -zeta - 2, else zeta - 1; then g halves and u,
    v double."""
    u, v, q, r = 1, 0, 0, 1
    f, g = f0, g0
    for i in range(30):
        assert f & 1, "f must stay odd"
        assert (u * f0 + v * g0) & M32 == (f << i) & M32 and (q * f0 + r * g0) & M32 == (g << i) & M32
        neg, odd = zeta < 0, g & 1
        x, y, z = ((-f) & M32, (-u) & M32, (-v) & M32) if neg else (f, u, v)
        g2, q2, r2 = ((g + x) & M32, (q + y) & M32, (r + z) & M32) if odd else (g, q, r)
        if neg and odd:
            f, u, v, zeta = g, q, r, -zeta - 2
        else:
            zeta -= 1
        g, q, r = g2 >> 1, q2, r2
        u, v = (u << 1) & M32, (v << 1) & M32
        assert -601 <= zeta <= 601
    t = tuple(_i32(w) for w in (u, v, q, r))
    assert all(-(1 << 30) <= w <= 1 << 30 for w in t)
    return zeta, t


def _s30(modulus: int) -> list:
    return [(modulus >> (30 * i)) & M30 for i in range(9)]


def _update_de(d: list, e: list, t, modulus: int = L) -> tuple:
    """divsteps.cuh divsteps_update_de: (d, e) <- t (d, e) / 2^30 mod M,
    with the multiples md, me of M that clear the low 30 bits; d and e stay
    in (-2M, M)."""
    m30, inv30 = _s30(modulus), pow(modulus, -1, 1 << 30)
    u, v, q, r = t
    for x in (d, e):
        assert -2 * modulus < _s30_value(x) < modulus
    sd, se = d[8] < 0, e[8] < 0
    md = (u if sd else 0) + (v if se else 0)
    me = (q if sd else 0) + (r if se else 0)
    cd = u * d[0] + v * e[0]
    ce = q * d[0] + r * e[0]
    md -= (inv30 * (cd & M32) + md) & M30
    me -= (inv30 * (ce & M32) + me) & M30
    cd += m30[0] * md
    ce += m30[0] * me
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= 30
    ce >>= 30
    nd, ne = [0] * 9, [0] * 9
    for i in range(1, 9):
        cd += u * d[i] + v * e[i] + m30[i] * md
        ce += q * d[i] + r * e[i] + m30[i] * me
        assert abs(cd) < 1 << 63 and abs(ce) < 1 << 63
        nd[i - 1], ne[i - 1] = cd & M30, ce & M30
        cd >>= 30
        ce >>= 30
    nd[8], ne[8] = cd, ce
    assert -(1 << 31) <= cd < 1 << 31 and -(1 << 31) <= ce < 1 << 31
    return nd, ne


def _update_fg(f: list, g: list, t) -> tuple:
    """divsteps.cuh divsteps_update_fg: (f, g) <- t (f, g) / 2^30, exact."""
    u, v, q, r = t
    cf = u * f[0] + v * g[0]
    cg = q * f[0] + r * g[0]
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= 30
    cg >>= 30
    nf, ng = [0] * 9, [0] * 9
    for i in range(1, 9):
        cf += u * f[i] + v * g[i]
        cg += q * f[i] + r * g[i]
        nf[i - 1], ng[i - 1] = cf & M30, cg & M30
        cf >>= 30
        cg >>= 30
    nf[8], ng[8] = cf, cg
    assert -(1 << 31) <= cf < 1 << 31 and -(1 << 31) <= cg < 1 << 31
    return nf, ng


def _normalize(d: list, sign: int, modulus: int = L) -> list:
    """divsteps.cuh divsteps_normalize: d in (-2M, M), negated where sign <
    0, to [0, M)."""
    r = list(d)
    for _ in range(2):
        if r[8] < 0:
            r = [a + m for a, m in zip(r, _s30(modulus))]
        if sign < 0:
            r = [-a for a in r]
            sign = 0
        for i in range(8):
            r[i + 1] += r[i] >> 30
            r[i] &= M30
    value = _s30_value(r)
    assert 0 <= value < modulus and all(0 <= a <= M30 for a in r)
    return r


def words_to_s30(x: list) -> list:
    """divsteps.cuh words_to_s30: 8 words -> nine 30-bit limbs (funnel shifts)."""
    out = []
    for i in range(9):
        w, sh = (30 * i) >> 5, (30 * i) & 31
        hi = x[w + 1] if w + 1 < 8 else 0
        out.append((((hi << 32) | x[w]) >> sh) & M30)
    return out


def s30_to_words(s: list) -> list:
    """divsteps.cuh s30_to_words: nine limbs in [0, 2^30) -> 8 words."""
    out = []
    for k in range(8):
        i, off = (32 * k) // 30, (32 * k) % 30
        out.append(((s[i] >> off) | (s[i + 1] << (30 - off))) & M32)
    return out


def inv_l(x: list, extra_batches: int = 0) -> list:
    """sc_inv_l_warp: x^-1 mod l for a canonical 8-word x (inv(0) = 0), by
    batches of 30 divsteps, each applied to (f, g) and (d, e) as a 2 x 2
    matrix: from f = l, g = x, d = 0, e = 1 until g = 0, when f = +-1 and
    x^-1 = +-d.  On the card a batch runs until every lane of the warp has
    g = 0, so a lane may run more batches than its own input needs;
    `extra_batches` runs those (up to INV_BATCHES in all), which leave d
    the same mod l."""
    assert len(x) == 8 and from_words(x) < L
    f, g = list(L_S30), words_to_s30(x)
    d, e = [0] * 9, [1] + [0] * 8
    zeta, batches = -1, 0
    while batches < INV_BATCHES and (any(g) or extra_batches):
        if not any(g):
            extra_batches -= 1
        zeta, t = divsteps_30(zeta, f[0], g[0])
        d, e = _update_de(d, e, t, L)
        f, g = _update_fg(f, g, t)
        batches += 1
    assert not any(g) and _s30_value(f) in ((1, -1) if any(x) else (L,))
    return s30_to_words(_normalize(d, f[8]))


def inv_batches(x: list) -> int:
    """The batches of divsteps until g = 0 for a canonical 8-word x."""
    f, g, zeta, n = list(L_S30), words_to_s30(x), -1, 0
    while any(g):
        zeta, t = divsteps_30(zeta, f[0], g[0])
        f, g = _update_fg(f, g, t)
        n += 1
    return n


# ---------------------------------------------------------------------------
# The inverse mod l of a public value, a warp for one value (sc_inv_l_var, T1's)
# ---------------------------------------------------------------------------

INV_VAR_BATCHES = 20  # SC_INV_VAR_BATCHES: 600 divsteps of the zeta form


def jump4_entry(zeta: int, f: int, g: int) -> tuple:
    """Four divsteps of the zeta form from zeta, f (odd) and g: ((u, v, q,
    r), sign, c) with 2^4 (f4, g4) = (u f + v g, q f + r g) and zeta4 =
    sign zeta + c."""
    u, v, q, r, sign, c = 1, 0, 0, 1, 1, 0
    for _ in range(4):
        if zeta < 0 and g & 1:
            f, g, u, v, q, r = g, (g - f) >> 1, 2 * q, 2 * r, q - u, r - v
            zeta, sign, c = -zeta - 2, -sign, -c - 2
        else:
            if g & 1:
                g, q, r = g + f, q + u, r + v
            g, u, v, zeta, c = g >> 1, 2 * u, 2 * v, zeta - 1, c - 1
    return (u, v, q, r), sign, c


@functools.lru_cache(maxsize=None)
def jump4_table() -> tuple:
    """divsteps.cuh DS_JUMP4: entry (clamp(zeta, -4, 3) + 4) << 7 | (f mod
    16) >> 1 << 4 | g mod 16 is `jump4_entry` of that clamped zeta, f mod 16
    and g mod 16 (the four steps decide alike for any zeta past the clamp),
    as ((u, v, q, r), sign, c)."""
    table = []
    for idx in range(1024):
        entry = jump4_entry((idx >> 7) - 4, 2 * ((idx >> 4) & 7) + 1, idx & 15)
        assert all(-16 <= w <= 16 for w in entry[0]) and -10 <= entry[2] <= 10
        table.append(entry)
    return tuple(table)


def divsteps_30_jump(zeta: int, f0: int, g0: int):
    """divsteps.cuh divsteps_30_jump: divsteps_30's zeta and matrix by seven
    jumps of four steps from `jump4_table` on the words f and g (exact mod
    2^(32 - 4 j) after j jumps), then two single steps."""
    table = jump4_table()
    u, v, q, r, f, g = 1, 0, 0, 1, f0, g0
    for _ in range(7):
        assert f & 1, "f must stay odd"
        (a, b, c, d), sign, add = table[(min(max(zeta, -4), 3) + 4) << 7 | ((f >> 1) & 7) << 4 | (g & 15)]
        f, g = ((a * f + b * g) & M32) >> 4, ((c * f + d * g) & M32) >> 4
        u, v, q, r = a * u + b * q, a * v + b * r, c * u + d * q, c * v + d * r
        zeta = sign * zeta + add
    for _ in range(2):
        assert f & 1, "f must stay odd"
        if zeta < 0 and g & 1:
            f, g, u, v, q, r, zeta = g, ((g - f) & M32) >> 1, 2 * q, 2 * r, q - u, r - v, -zeta - 2
        else:
            if g & 1:
                g, q, r = (g + f) & M32, q + u, r + v
            g, u, v, zeta = g >> 1, 2 * u, 2 * v, zeta - 1
    assert not (u * f0 + v * g0 - (f << 30)) & M32 and not (q * f0 + r * g0 - (g << 30)) & M32
    assert all(-(1 << 30) <= w <= 1 << 30 for w in (u, v, q, r)) and -601 <= zeta <= 601
    return zeta, (u, v, q, r)


def settle(p: list) -> tuple:
    """divsteps.cuh divsteps_settle for one value on one half-warp, lane by
    lane: lanes 0-8's 64-bit sums p of P, a multiple of 2^30 (lanes 9-15
    hold zeroes and give them) -> (lanes 0-8's limbs of P / 2^30, the carry
    rounds it needs after the first; the warp runs the most that any of its
    four values needs, which leave the others as they are)."""
    assert len(p) == 9 and not p[0] & M30
    s = [(p[i + 1] & M30) + (p[i] >> 30) for i in range(8)] + [p[8] >> 30]
    carry = [w >> 30 for w in s]
    assert -(1 << 63) <= min(s) and max(s) < 1 << 63 and -(1 << 31) <= min(carry) and max(carry) < 1 << 31
    val = [s[0] & M30] + [(s[i] & M30) + carry[i - 1] for i in range(1, 8)]
    top = s[8] + carry[7]
    rounds = 0
    while min(val) < 0 or max(val) > M30:
        rounds += 1
        carry = [w >> 30 for w in val]
        assert -1 <= min(carry) and max(carry) <= 1
        val = [val[0] & M30] + [(val[i] & M30) + carry[i - 1] for i in range(1, 8)]
        top += carry[7]
    assert -(1 << 31) <= top < 1 << 31
    return val + [top], rounds


def inv_l_var(x: list, counts: dict | None = None) -> list:
    """scalar_l.cuh sc_inv_l_var: x^-1 mod l for a canonical 8-word x (inv(0)
    = 0), by a warp, lane by lane: lane i < 9 holds limb i of d and e, lane
    16 + i limb i of f and g; from f = l, g = x, d = 0, e = 1, zeta = -1,
    batches until g = 0 (at most INV_VAR_BATCHES): the steps from f's and
    g's low limbs (`divsteps_30_jump`), every lane's products, the multiples
    of l that clear d's and e's low 30 bits from lane 0's products, and
    `settle` for each half; then d gathered and normalized by f's sign.
    `counts`, where given, gets the batches and the carry rounds after the
    first ("rounds", the most of the four values' a batch)."""
    assert len(x) == 8 and from_words(x) < L
    d, e, f, g = [0] * 9, [1] + [0] * 8, list(L_S30), words_to_s30(x)
    zeta, batches, rounds = -1, 0, 0
    for _ in range(INV_VAR_BATCHES):
        if not any(g):
            break
        zeta, (u, v, q, r) = divsteps_30_jump(zeta, f[0] & M32, g[0] & M32)
        sd, se = -(d[8] < 0), -(e[8] < 0)
        pd = [u * a + v * b for a, b in zip(d, e)]
        pe = [q * a + r * b for a, b in zip(d, e)]
        md, me = (u & sd) + (v & se), (q & sd) + (r & se)
        md -= (L_INV30 * (pd[0] & M32) + (md & M32)) & M30
        me -= (L_INV30 * (pe[0] & M32) + (me & M32)) & M30
        (d, rd), (e, re) = (settle([w + m * md for w, m in zip(pd, L_S30)]),
                            settle([w + m * me for w, m in zip(pe, L_S30)]))
        (f, rf), (g, rg) = settle([u * a + v * b for a, b in zip(f, g)]), settle([q * a + r * b for a, b in zip(f, g)])
        assert -2 * L < _s30_value(d) < L and -2 * L < _s30_value(e) < L
        batches += 1
        rounds += max(rd, rf, re, rg)
    assert not any(g), "g = 0 within INV_VAR_BATCHES"
    assert _s30_value(f) in ((1, -1) if any(x) else (L,))
    if counts is not None:
        counts.update(batches=batches, rounds=rounds)
    return s30_to_words(_normalize(d, f[8]))

