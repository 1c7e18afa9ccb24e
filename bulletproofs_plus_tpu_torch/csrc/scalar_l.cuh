// GF(l), l the order of ristretto255's group, on 32-bit words: the
// reduction of a 512-bit value mod l (what Scalar::from_bytes_mod_order_wide
// computes, and what R1, replay.cu, does to each 64-byte Fiat-Shamir
// challenge), and on it the field arithmetic of S1 (scalar_pass.cu) and of
// the prover's P1-P3 (prover.cu): a product, a square, a sum, a difference
// and an inverse of 8-word values, and their load and store as int64 limbs.
//
// Counterpart of the JAX package's `_wide_to_scalar` (models/replay_device.py,
// F.reduce_wide_l: Barrett on radix-2^16 limbs).  Here it is Barrett's
// reduction (HAC 14.42) with b = 2^32 and k = 8, since 2^224 <= l < 2^256:
//   q1 = x >> 224 and mu = floor(2^512 / l), nine words each;
//   q3 = (q1 mu) >> 288;
//   r  = (x - q3 l) mod 2^288;
//   one conditional subtraction of l.
// HAC allows q3 to fall 2 below floor(x / l); for this l it falls at most 1:
// x / l - q3 < 1 + frac(2^512 / l) + 2^224 / l < 1.23, so r < 2l.
// Products are row scanning on the hardware carry flag, as in
// field25519.cuh: each row adds its low halves in one carry chain and its
// high halves in another, one word up (9 x 9 words for q1 mu; q3 l only below
// 2^288, its chains cut at word 8).  It runs once a challenge, nine to
// eleven a proof side by side on a warp's lanes, so its latency of some 250
// dependent instructions sits once at R1's end.
//
// The field operations keep ops/field.py's contract: `sc_mul_l` and
// `sc_sqr_l` take any values below 2^256 (their product is below 2^512, the
// reduction's whole range; below 2^506 for canonical inputs) and return the
// canonical residue; `sc_add_l` is a + b less l where that does not borrow,
// `sc_sub_l` is a - b plus l mod 2^256 where a - b borrows, as field.py's
// `add_l` and `sub_l`, so canonical inputs give the canonical result;
// `sc_inv_l` is Fermat's x^(l - 2), with inv(0) = 0 as `F.inv_l` has it.
//
// ops/scalar_model.py repeats this file word for word in Python, with every
// bound it relies on asserted; tests/test_torch_replay.py holds the reduction
// against Python integers and the torch and JAX `reduce_wide_l`, and
// tests/test_torch_scalar.py the field operations against Python integers.

#pragma once

#include "field25519.cuh"

__device__ __forceinline__ u32 mad_hi_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_lo(u32 a, u32 b, u32 c) {  // the carry out is dropped
    u32 r;
    asm volatile("madc.lo.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_hi(u32 a, u32 b, u32 c) {  // the carry out is dropped
    u32 r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

#define SC_N 9  // words of q1, mu, q3 and the residues mod 2^288

// r = a * b, NA + NB words (NB >= 2).  Before row i the sum is below
// 2^(32 (i + NB)), so word i + NB takes only the low chain's carry and the
// high chain carries out of no row.
template <int NA, int NB>
__device__ __forceinline__ void sc_mul_wide(const u32 *a, const u32 *b, u32 *r) {
#pragma unroll
    for (int k = 0; k < NA + NB; ++k) r[k] = 0u;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
        r[i] = mad_lo_cc(a[i], b[0], r[i]);
#pragma unroll
        for (int j = 1; j < NB; ++j) r[i + j] = madc_lo_cc(a[i], b[j], r[i + j]);
        r[i + NB] = addc(r[i + NB], 0u);
        r[i + 1] = mad_hi_cc(a[i], b[0], r[i + 1]);
#pragma unroll
        for (int j = 1; j < NB - 1; ++j) r[i + j + 1] = madc_hi_cc(a[i], b[j], r[i + j + 1]);
        r[i + NB] = madc_hi(a[i], b[NB - 1], r[i + NB]);
    }
}

// r = a * b mod 2^(32 N): row i's chains stop at word N - 1, whose carry out is dropped.
template <int N>
__device__ __forceinline__ void sc_mul_lo(const u32 *a, const u32 *b, u32 *r) {
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = 0u;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int m = N - i;  // low halves: words i .. N - 1
        if (m == 1) {
            r[N - 1] += a[i] * b[0];
        } else {
            r[i] = mad_lo_cc(a[i], b[0], r[i]);
#pragma unroll
            for (int j = 1; j < m - 1; ++j) r[i + j] = madc_lo_cc(a[i], b[j], r[i + j]);
            r[N - 1] = madc_lo(a[i], b[m - 1], r[N - 1]);
        }
        const int h = m - 1;  // high halves: words i + 1 .. N - 1
        if (h == 1) {
            r[N - 1] += __umulhi(a[i], b[0]);
        } else if (h >= 2) {
            r[i + 1] = mad_hi_cc(a[i], b[0], r[i + 1]);
#pragma unroll
            for (int j = 1; j < h - 1; ++j) r[i + j + 1] = madc_hi_cc(a[i], b[j], r[i + j + 1]);
            r[N - 1] = madc_hi(a[i], b[h - 1], r[N - 1]);
        }
    }
}

// r - l where that does not borrow, else r (nine words).
__device__ __forceinline__ void sc_csub_l(u32 *r, const u32 *l) {
    u32 t[SC_N];
    t[0] = sub_cc(r[0], l[0]);
#pragma unroll
    for (int k = 1; k < SC_N; ++k) t[k] = subc_cc(r[k], l[k]);
    const u32 borrow = subc(0u, 0u);
#pragma unroll
    for (int k = 0; k < SC_N; ++k) r[k] = borrow ? r[k] : t[k];
}

// x: 16 little-endian words, any value below 2^512 -> r: x mod l, 8 words.
__device__ __forceinline__ void sc_reduce_wide(const u32 x[16], u32 r[8]) {
    const u32 mu[SC_N] = {0x0a2c131bu, 0xed9ce5a3u, 0x086329a7u, 0x2106215du, 0xffffffebu,
                          0xffffffffu, 0xffffffffu, 0xffffffffu, 0x0000000fu};
    const u32 l[SC_N] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0u, 0u, 0u, 0x10000000u, 0u};
    u32 q2[2 * SC_N], r2[SC_N], w[SC_N];
    sc_mul_wide<SC_N, SC_N>(x + 7, mu, q2);
    sc_mul_lo<SC_N>(q2 + SC_N, l, r2);
    w[0] = sub_cc(x[0], r2[0]);
#pragma unroll
    for (int k = 1; k < SC_N - 1; ++k) w[k] = subc_cc(x[k], r2[k]);
    w[SC_N - 1] = subc(x[SC_N - 1], r2[SC_N - 1]);
    sc_csub_l(w, l);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = w[k];
}

// ---------------------------------------------------------------------------
// GF(l) on 8 little-endian words (S1)
// ---------------------------------------------------------------------------

// int64 radix-2^16 limbs (ops/field.py's layout, each limb below 2^16) <-> 8 words, at the kernels' boundary.
__device__ __forceinline__ void load_limbs(const int64_t *p, u32 *w) {
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = (u32)p[2 * k] | ((u32)p[2 * k + 1] << 16);
}

__device__ __forceinline__ void store_limbs(int64_t *p, const u32 *w) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        p[2 * k] = (int64_t)(w[k] & 0xffffu);
        p[2 * k + 1] = (int64_t)(w[k] >> 16);
    }
}

__device__ __forceinline__ void copy8(u32 *r, const u32 *a) {
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = a[k];
}

__device__ __forceinline__ void set_small(u32 *r, u32 v) {
    r[0] = v;
#pragma unroll
    for (int k = 1; k < 8; ++k) r[k] = 0u;
}


// l - 2, the Fermat exponent; its top bit is bit 252.
__constant__ u32 SC_L_MINUS_2[8] = {0x5cf5d3ebu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0u, 0u, 0u, 0x10000000u};

// r = a * b mod l; r may be a or b.
__device__ __forceinline__ void sc_mul_l(const u32 *a, const u32 *b, u32 *r) {
    u32 t[16];
    sc_mul_wide<8, 8>(a, b, t);
    sc_reduce_wide(t, r);
}

__device__ __forceinline__ void sc_sqr_l(const u32 *a, u32 *r) { sc_mul_l(a, a, r); }

// r = a + b, less l where that does not borrow (nine words, then the low eight); r may be a or b.
__device__ __forceinline__ void sc_add_l(const u32 *a, const u32 *b, u32 *r) {
    const u32 l[SC_N] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0u, 0u, 0u, 0x10000000u, 0u};
    u32 s[SC_N];
    s[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) s[k] = addc_cc(a[k], b[k]);
    s[8] = addc(0u, 0u);
    sc_csub_l(s, l);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = s[k];
}

// r = a - b, plus l mod 2^256 where a - b borrows; r may be a or b.
__device__ __forceinline__ void sc_sub_l(const u32 *a, const u32 *b, u32 *r) {
    const u32 l[8] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0u, 0u, 0u, 0x10000000u};
    u32 t[8];
    t[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) t[k] = subc_cc(a[k], b[k]);
    const u32 mask = subc(0u, 0u);
    r[0] = add_cc(t[0], l[0] & mask);
#pragma unroll
    for (int k = 1; k < 7; ++k) r[k] = addc_cc(t[k], l[k] & mask);
    r[7] = addc(t[7], l[7] & mask);  // the carry out of 2^256 is dropped
}

// r = x^(l - 2) mod l (inv(0) = 0): square-and-multiply from bit 251, the accumulator starting at x for the
// top bit; r may be x.  One loop body, the exponent's bit read from constant memory.
__device__ __forceinline__ void sc_inv_l(const u32 *x, u32 *r) {
    u32 acc[8], base[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = base[k] = x[k];
#pragma unroll 1
    for (int bit = 251; bit >= 0; --bit) {
        sc_sqr_l(acc, acc);
        if ((SC_L_MINUS_2[bit >> 5] >> (bit & 31)) & 1u) sc_mul_l(acc, base, acc);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = acc[k];
}
