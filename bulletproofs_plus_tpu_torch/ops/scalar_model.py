"""Word-exact model of csrc/scalar_l.cuh in plain Python: the reduction of a
64-byte challenge mod l on 32-bit words, and the GF(l) arithmetic on it that
S1 (csrc/scalar_pass.cu) computes with.

Like ops/field_model.py for csrc/field25519.cuh: the CUDA code cannot run
without a card, and its carry logic is where it can go wrong.  Every PTX
carry-flag instruction is a method of `field_model.Carry`, every loop runs in
the order of the CUDA loop, and every bound the CUDA code relies on (a carry
that cannot occur, a remainder below 2l) is asserted.  ops/cuda_replay.py's
`replay_model` runs R1's epilogue through `reduce_wide`, and
ops/cuda_scalar.py's `scalar_pass_model` runs S1's programs on `mul_l`,
`sqr_l`, `add_l`, `sub_l` and `inv_l`; tests/test_torch_replay.py holds the
reduction against Python integers and the torch and JAX `reduce_wide_l`,
tests/test_torch_scalar.py the field operations against Python integers.

The reduction is Barrett's (HAC 14.42) with b = 2^32 and k = 8, since
2^224 <= l < 2^256: for x < 2^512, q1 = x >> 224 and mu = floor(2^512 / l)
are nine words each and q3 = (q1 mu) >> 288.  HAC allows q3 to fall 2
below floor(x / l); for this l, x / l - q3 < 1 + frac(2^512 / l) +
2^224 / l < 1.23, so r = (x - q3 l) mod 2^288 lies below 2l and one
conditional subtraction of l leaves the canonical residue.
"""

from __future__ import annotations

from .field_model import M32, Carry

L = 2**252 + 27742317777372353535851937790883648493
MU = 2**512 // L
N = 9  # words of q1, mu, q3 and the residues mod 2^288


def to_words(value: int, n: int) -> list:
    if not 0 <= value < 1 << (32 * n):
        raise ValueError(f"a value of {n} words is below 2^{32 * n}")
    return [(value >> (32 * k)) & M32 for k in range(n)]


def from_words(words) -> int:
    assert all(0 <= w <= M32 for w in words)
    return sum(w << (32 * k) for k, w in enumerate(words))


MU_WORDS = to_words(MU, N)
L_WORDS = to_words(L, N)
LM2_WORDS = to_words(L - 2, 8)  # the Fermat exponent, SC_L_MINUS_2; its top bit is bit 252


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


def mul_lo(cc: Carry, a: list, b: list) -> list:
    """a * b mod 2^(32 n) for n-word a and b: row i's chains stop at word
    n - 1, whose carry out is dropped."""
    n = len(a)
    assert len(b) == n
    r = [0] * n
    for i in range(n):
        m = n - i  # low halves of row i: words i .. n - 1
        if m == 1:
            r[n - 1] = (r[n - 1] + a[i] * b[0]) & M32  # mad.lo
        else:
            r[i] = cc.mad_lo_cc(a[i], b[0], r[i])
            for j in range(1, m - 1):
                r[i + j] = cc.madc_lo_cc(a[i], b[j], r[i + j])
            r[n - 1] = cc.madc_lo(a[i], b[m - 1], r[n - 1])
        h = m - 1  # high halves of row i: words i + 1 .. n - 1
        if h == 1:
            r[n - 1] = (r[n - 1] + ((a[i] * b[0]) >> 32)) & M32  # mad.hi
        elif h >= 2:
            r[i + 1] = cc.mad_hi_cc(a[i], b[0], r[i + 1])
            for j in range(1, h - 1):
                r[i + j + 1] = cc.madc_hi_cc(a[i], b[j], r[i + j + 1])
            r[n - 1] = cc.madc_hi(a[i], b[h - 1], r[n - 1])
    return r


def _csub_l(cc: Carry, r: list) -> list:
    """r - l if that does not borrow, else r (a select on the borrow mask)."""
    t = [0] * N
    t[0] = cc.sub_cc(r[0], L_WORDS[0])
    for k in range(1, N):
        t[k] = cc.subc_cc(r[k], L_WORDS[k])
    borrow = cc.subc(0, 0)
    return list(r) if borrow else t


def reduce_wide(x: list) -> list:
    """x, 16 little-endian 32-bit words (a value below 2^512) -> x mod l as
    8 words, as Scalar::from_bytes_mod_order_wide gives it."""
    assert len(x) == 16
    cc = Carry()
    q3 = mul_wide(cc, x[7:16], MU_WORDS)[N:]
    r2 = mul_lo(cc, q3, L_WORDS)
    r = [0] * N
    r[0] = cc.sub_cc(x[0], r2[0])
    for k in range(1, N - 1):
        r[k] = cc.subc_cc(x[k], r2[k])
    r[N - 1] = cc.subc(x[N - 1], r2[N - 1])
    assert from_words(r) < 2 * L, "Barrett's remainder reached 2l"
    r = _csub_l(cc, r)
    assert from_words(r) < L and r[8] == 0
    return r[:8]


# ---------------------------------------------------------------------------
# GF(l) on 8 words (S1)
# ---------------------------------------------------------------------------


def mul_l(a: list, b: list) -> list:
    """sc_mul_l: a * b mod l for 8-word a and b below 2^256."""
    assert len(a) == 8 and len(b) == 8
    return reduce_wide(mul_wide(Carry(), a, b))


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


def inv_l(x: list) -> list:
    """sc_inv_l: x^(l - 2) mod l by square-and-multiply from bit 251, the
    accumulator starting at x for the top bit; inv(0) = 0."""
    assert (LM2_WORDS[7] >> 28) == 1 and len(x) == 8
    acc = list(x)
    for bit in range(251, -1, -1):
        acc = sqr_l(acc)
        if (LM2_WORDS[bit >> 5] >> (bit & 31)) & 1:
            acc = mul_l(acc, x)
    return acc
