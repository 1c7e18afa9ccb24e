"""Modular arithmetic on limb tensors: GF(2^255-19) and GF(l).

Counterpart of bulletproofs_plus_tpu/ops/field.py.  Values are
(..., NLIMBS) int64 tensors holding radix-2^16 limbs (the JAX package's
layout, see limbs.py), with the batch in the leading axes.  Torch has no
unsigned 32-bit `+`, `>>` or `<` on the CPU, so the limbs live in int64; the
headroom also lets a whole 16x16 limb product accumulate without the JAX
package's lo/hi-16 split.

Invariants (as in the JAX package):
  * fp (mod 2^255-19): limbs < 2^16, value < 2^256 (lazily reduced);
    canonicalised only at encode/compare time.
  * fl (mod l): always fully reduced (< l).

Everything here is plain torch and runs on whatever device its inputs live
on.  The one exception is `pow_p58`, which on a CUDA tensor launches the
hand-written pow-chain kernel (ops/cuda_pow.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as tnf

from .limbs import LIMB_BITS, LIMB_MASK, NLIMBS, limbs_from_int

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493

_MU = 2**512 // L  # Barrett mu, 17 limbs


@functools.lru_cache(maxsize=None)
def _limbs_on(value: int, nlimbs: int, device: str, limbwise: int) -> torch.Tensor:
    arr = limbs_from_int(value, nlimbs).astype(np.int64) * limbwise
    return torch.as_tensor(arr, device=device)


def limbs_const(value: int, like: torch.Tensor, nlimbs: int = NLIMBS) -> torch.Tensor:
    """Limbs of a python int as a cached int64 tensor on `like`'s device."""
    return _limbs_on(value, nlimbs, str(like.device), 1)


def _4p_limbwise(like: torch.Tensor) -> torch.Tensor:
    """4p as 4x the canonical limbs of p (each >= 2^16, unlike limbs of 4p)."""
    return _limbs_on(P, NLIMBS, str(like.device), 4)


# ---------------------------------------------------------------------------
# Generic limb primitives (int64 holding radix-2^16 limbs)
# ---------------------------------------------------------------------------


def _shift_limbs(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift limbs towards higher indices by k, zero-filling (value * b^k)."""
    return tnf.pad(x, (k, 0))[..., : x.shape[-1]]


def _carry_chain(g: torch.Tensor, p: torch.Tensor):
    """Resolve a ripple: carry_in[i] = g[i-1] | (p[i-1] & carry_in[i-1]).

    g, p: (..., n) 0/1 int64 with g & p == 0 and n < 62.  Packed into one
    bitmask each, the chain is the carry pattern of the integer sum
    (G | P) + G, read back as C = ((G | P) + G) ^ (G | P) ^ G: constant
    depth instead of a log-depth lookahead.  Returns (carry into each limb,
    carry out of the top limb)."""
    n = g.shape[-1]
    sh = _arange_on(n, str(g.device))
    G = (g << sh).sum(-1)
    X = G | (p << sh).sum(-1)
    C = (X + G) ^ X ^ G
    return (C[..., None] >> sh) & 1, (C >> n) & 1


@functools.lru_cache(maxsize=None)
def _arange_on(n: int, device: str) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def carry_prop(x: torch.Tensor, out_limbs: int | None = None, bits: int = 32) -> torch.Tensor:
    """Full carry propagation of nonnegative limbs below 2^bits.

    Returns (..., out_limbs) with limbs < 2^16; out_limbs defaults to n+1 and
    the final limb takes the carry-out (the caller sizes it).  Carry-save
    passes bring every limb below 2^17 - 1 (the pass count follows from the
    static `bits`), then one carry chain resolves the 0/1 ripple.
    """
    n = x.shape[-1]
    if out_limbs is None:
        out_limbs = n + 1
    if out_limbs < n:
        raise ValueError("carry_prop cannot truncate")
    if out_limbs > n:
        x = tnf.pad(x, (0, out_limbs - n))
    m = (1 << bits) - 1  # largest possible limb
    while m > 2 * LIMB_MASK:
        x = (x & LIMB_MASK) + _shift_limbs(x >> LIMB_BITS, 1)
        m = LIMB_MASK + (m >> LIMB_BITS)
    cin, _ = _carry_chain(x >> LIMB_BITS, ((x & LIMB_MASK) == LIMB_MASK).long())
    return (x + cin) & LIMB_MASK


def _antidiag_sum(prod: torch.Tensor) -> torch.Tensor:
    """out[..., k] = sum_i prod[..., i, k-i]: the (..., na, nb) product grid
    of two limb vectors summed into (..., na+nb-1) polynomial coefficients.

    Skew trick: pad each row by na zeros, flatten, trim, and re-view with
    rows one shorter, so entry (i, j) lands in column i + j."""
    na, nb = prod.shape[-2], prod.shape[-1]
    w = na + nb - 1
    flat = tnf.pad(prod, (0, na)).reshape(prod.shape[:-2] + (na * (nb + na),))
    return flat[..., : na * w].reshape(prod.shape[:-2] + (na, w)).sum(-2)


def mul_limbs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of limb vectors (limbs < 2^16).
    Returns (..., na+nb) carried limbs (< 2^16)."""
    na, nb = a.shape[-1], b.shape[-1]
    coeffs = _antidiag_sum(a[..., :, None] * b[..., None, :])  # < min(na,nb) * 2^32
    return carry_prop(coeffs, na + nb, bits=32 + max(min(na, nb), 2).bit_length())


def sub_with_borrow(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a - b over equal-width canonical (< 2^16) limb vectors.
    Returns (diff, borrow_out) by borrow lookahead."""
    borrow_in, borrow_out = _carry_chain((a < b).long(), (a == b).long())
    return (a - b - borrow_in) & LIMB_MASK, borrow_out


def geq(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a >= m over canonical limbs; returns bool (...)."""
    _, borrow = sub_with_borrow(a, m.expand(a.shape))
    return borrow == 0


def cond_sub(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a - m if a >= m else a (canonical limbs)."""
    diff, borrow = sub_with_borrow(a, m.expand(a.shape))
    return torch.where((borrow == 0)[..., None], diff, a)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """where(mask, a, b) with mask shaped (...) and a/b (..., n)."""
    return torch.where(mask[..., None], a, b)


# ---------------------------------------------------------------------------
# GF(2^255 - 19)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fold_weights(device: str):
    """(wrap, unit): 38 at limb 0 and 1 elsewhere, and the unit vector at limb 0."""
    wrap = torch.ones(NLIMBS, dtype=torch.int64, device=device)
    wrap[0] = 38
    unit = torch.zeros(NLIMBS, dtype=torch.int64, device=device)
    unit[0] = 1
    return wrap, unit


_FOLD_MAX = LIMB_MASK + 38  # limbs at most 2^16 + 37 before the exact chain


def reduce25519(x: torch.Tensor, limb_max: int) -> torch.Tensor:
    """16 nonnegative limbs, each at most `limb_max` (static) -> limbs
    < 2^16, value < 2^256, congruent mod p.

    Cyclic carry-save passes send the carry out of limb 15 back into limb 0
    times 38 (2^256 == 38 mod p) until every limb is at most 2^16 + 37.  One
    carry chain then leaves a carry-out c; the value below 2^256 is then
    under 2^247, so adding 38c cannot overflow again, and a second chain
    settles the ripple it starts.  (A single fold that dropped that last
    carry was the JAX package's pfield._fold16 bug.)"""
    wrap, unit = _fold_weights(str(x.device))
    m = limb_max
    while m > _FOLD_MAX:
        x = (x & LIMB_MASK) + torch.roll(x >> LIMB_BITS, 1, -1) * wrap
        m = LIMB_MASK + 38 * (m >> LIMB_BITS)
    cin, cout = _carry_chain(x >> LIMB_BITS, ((x & LIMB_MASK) == LIMB_MASK).long())
    x = ((x + cin) & LIMB_MASK) + (38 * cout)[..., None] * unit
    cin, _ = _carry_chain(x >> LIMB_BITS, ((x & LIMB_MASK) == LIMB_MASK).long())
    return (x + cin) & LIMB_MASK


def add25519(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce25519(a + b, 2 * LIMB_MASK)


def sub25519(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod-ish p: adds 4p limb-wise so no limb underflows."""
    return reduce25519(a + _4p_limbwise(a) - b, LIMB_MASK + 4 * 0xFFFF)


def neg25519(a: torch.Tensor) -> torch.Tensor:
    return reduce25519(_4p_limbwise(a) - a, 4 * 0xFFFF)


def mul25519(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Modular product, folded through 2^256 == 38 before any carry: the 31
    uncarried coefficients (each below 16 * 2^32) fold to 16 limbs below
    39 * 2^36, then one reduction runs."""
    coeffs = _antidiag_sum(a[..., :, None] * b[..., None, :])  # (..., 31)
    folded = coeffs[..., :NLIMBS] + tnf.pad(38 * coeffs[..., NLIMBS:], (0, 1))
    return reduce25519(folded, 39 * 16 * LIMB_MASK**2)


def sqr25519(a: torch.Tensor) -> torch.Tensor:
    return mul25519(a, a)


def mul_small25519(a: torch.Tensor, k: int) -> torch.Tensor:
    """Multiply by a small constant (< 2^15)."""
    if not 0 <= k < 2**15:
        raise ValueError("mul_small25519 takes 0 <= k < 2^15")
    return reduce25519(a * k, k * LIMB_MASK)


def canon25519(a: torch.Tensor) -> torch.Tensor:
    """Fully reduce to [0, p)."""
    m = limbs_const(P, a)
    return cond_sub(cond_sub(a, m), m)


def eq25519(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.all(canon25519(a) == canon25519(b), dim=-1)


def is_zero25519(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canon25519(a) == 0, dim=-1)


def is_negative25519(a: torch.Tensor) -> torch.Tensor:
    """RFC 9496 negativity: the canonical encoding is odd."""
    return (canon25519(a)[..., 0] & 1).bool()


def abs25519(a: torch.Tensor) -> torch.Tensor:
    return select(is_negative25519(a), neg25519(a), a)


def _pow_bits(x: torch.Tensor, exp: int, mul, sqr) -> torch.Tensor:
    """Left-to-right square-and-multiply with a static exponent."""
    acc = limbs_const(1, x).expand(x.shape)
    for i in reversed(range(exp.bit_length())):
        acc = sqr(acc)
        if (exp >> i) & 1:
            acc = mul(acc, x)
    return acc


def sqr_n(x: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        x = sqr25519(x)
    return x


def chain_250(x: torch.Tensor):
    """The curve25519 addition chain: returns (x^(2^250 - 1), x^11), the
    shared prefix of the inversion and sqrt-ratio exponents."""
    z2 = sqr25519(x)
    z9 = mul25519(x, sqr_n(z2, 2))
    z11 = mul25519(z2, z9)
    z_5_0 = mul25519(z9, sqr25519(z11))
    z_10_0 = mul25519(sqr_n(z_5_0, 5), z_5_0)
    z_20_0 = mul25519(sqr_n(z_10_0, 10), z_10_0)
    z_40_0 = mul25519(sqr_n(z_20_0, 20), z_20_0)
    z_50_0 = mul25519(sqr_n(z_40_0, 10), z_10_0)
    z_100_0 = mul25519(sqr_n(z_50_0, 50), z_50_0)
    z_200_0 = mul25519(sqr_n(z_100_0, 100), z_100_0)
    z_250_0 = mul25519(sqr_n(z_200_0, 50), z_50_0)
    return z_250_0, z11


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3), the sqrt-ratio exponent (RFC 9496).
    Launches the pow-chain kernel on a CUDA tensor (ops/cuda_pow.py)."""
    from .cuda_pow import pow_p58 as _pow_p58

    return _pow_p58(x)


def pow25519(x: torch.Tensor, exp: int) -> torch.Tensor:
    if exp == (P - 5) // 8:
        return pow_p58(x)
    return _pow_bits(x, exp, mul25519, sqr25519)


# ---------------------------------------------------------------------------
# GF(l) — scalar field, Barrett reduction, always canonical (< l)
# ---------------------------------------------------------------------------


def barrett_reduce(x: torch.Tensor) -> torch.Tensor:
    """Reduce x (at most 32 limbs < 2^16, value < 2^512) mod l.
    HAC Algorithm 14.42 with b = 2^16, k = 16."""
    n = x.shape[-1]
    if n > 32:
        raise ValueError("barrett input too wide")
    if n < 32:
        x = tnf.pad(x, (0, 32 - n))
    q1 = x[..., 15:]  # floor(x / b^(k-1)), 17 limbs
    q3 = mul_limbs(q1, limbs_const(_MU, x, 17))[..., 17:]  # floor(q1*mu / b^(k+1)), 17 limbs
    r1 = x[..., :17]
    r2 = mul_limbs(q3, limbs_const(L, x))[..., :17]  # (q3*l) mod b^(k+1)
    # The masked difference already equals r1 - r2 + b^17 on a borrow.
    r, _ = sub_with_borrow(r1, r2)
    lm17 = limbs_const(L, x, 17)
    r = cond_sub(cond_sub(r, lm17), lm17)  # r < 3l
    return r[..., :NLIMBS]


def mul_l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return barrett_reduce(mul_limbs(a, b))


def sqr_l(a: torch.Tensor) -> torch.Tensor:
    return mul_l(a, a)


def add_l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = carry_prop(a + b, NLIMBS + 1, bits=17)
    return cond_sub(s, limbs_const(L, a, 17))[..., :NLIMBS]


def sub_l(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod l for canonical a, b."""
    d, borrow = sub_with_borrow(a, b)
    dl = carry_prop(d + limbs_const(L, d), NLIMBS, bits=17)  # a - b + l < l: no carry-out
    return select(borrow == 0, d, dl)


def neg_l(a: torch.Tensor) -> torch.Tensor:
    return sub_l(torch.zeros_like(a), a)


def pow_l(x: torch.Tensor, exp: int) -> torch.Tensor:
    return _pow_bits(x, exp, mul_l, sqr_l)


def inv_l(x: torch.Tensor) -> torch.Tensor:
    """Inverse mod l by Fermat; inv(0) = 0."""
    return pow_l(x, L - 2)
