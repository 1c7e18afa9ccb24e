// GF(l), l = 2^252 + delta the order of ristretto255's group, on 32-bit
// words: the reduction of a 512-bit value mod l (what
// Scalar::from_bytes_mod_order_wide computes, what R1, replay.cu, does to
// each 64-byte Fiat-Shamir challenge, and what ends each product), and the
// field arithmetic of S1 (scalar_pass.cu) and of the prover's P1-P3
// (prover.cu): a product, a square, a sum, a difference and an inverse of
// 8-word values, and their load and store as int64 limbs.
//
// The reduction (`sc_reduce_fold`, the counterpart of the JAX package's
// `_wide_to_scalar`, F.reduce_wide_l) uses the shape of l: delta is below
// 2^125, so 2^252 = -delta (mod l) folds a 512-bit value to 385 bits, then
// 258, then 253, in 120 multiply-adds, and one conditional subtraction of l
// ends it.
// Products are row scanning on the hardware carry flag, as in
// field25519.cuh: each row adds its low halves in one carry chain and its
// high halves in another, one word up.
//
// The field operations keep ops/field.py's contract: `sc_mul_l` and
// `sc_sqr_l` take any values below 2^256 (their product is below 2^512, the
// fold's whole range) and return the canonical residue; `sc_add_l` is a + b
// less l where that does not borrow, `sc_sub_l` is a - b plus l mod 2^256
// where a - b borrows, as field.py's `add_l` and `sub_l`, so canonical inputs
// give the canonical result; `sc_inv_l_warp` is the inverse of a canonical
// value by Bernstein and Yang's divsteps (divsteps.cuh), which is x^(l - 2) as
// `F.inv_l` computes it, with inv(0) = 0.
//
// ops/scalar_model.py repeats this file word for word in Python, with every
// bound it relies on asserted; tests/test_torch_replay.py holds the reduction
// against Python integers and the torch and JAX `reduce_wide_l`, and
// tests/test_torch_scalar.py the field operations against Python integers.

#pragma once

#include "divsteps.cuh"

__device__ __forceinline__ u32 mad_hi_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("mad.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_hi(u32 a, u32 b, u32 c) {  // the carry out is dropped
    u32 r;
    asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

#define SC_N 9  // words of the fold's sums

// l = 2^252 + delta on SC_N words, and delta, below 2^125.
#define SC_L_WORDS {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu, 0u, 0u, 0u, 0x10000000u, 0u}
#define SC_DELTA {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu}

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


// Words 0 .. N - 1 of x >> 252 (x of NX words): a funnel shift by 28 of words 7 + i and 8 + i.
template <int NX, int N>
__device__ __forceinline__ void sc_shr252(const u32 *x, u32 *out) {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __funnelshift_r(x[7 + i], 8 + i < NX ? x[8 + i] : 0u, 28);
}

// r = x mod 2^252, eight words of NR (the words above are zero).
template <int NR>
__device__ __forceinline__ void sc_low252(const u32 *x, u32 *r) {
#pragma unroll
    for (int k = 0; k < 7; ++k) r[k] = x[k];
    r[7] = x[7] & 0x0fffffffu;
#pragma unroll
    for (int k = 8; k < NR; ++k) r[k] = 0u;
}

// r = a + b on NA words, b of NB <= NA words; the values never carry out of the top word.
template <int NA, int NB>
__device__ __forceinline__ void sc_add_words(const u32 *a, const u32 *b, u32 *r) {
    r[0] = add_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < NA - 1; ++k) r[k] = addc_cc(a[k], k < NB ? b[k] : 0u);
    r[NA - 1] = addc(a[NA - 1], NA - 1 < NB ? b[NA - 1] : 0u);
}

// r = a - b on NA words, b of NB <= NA words; the values never borrow out of the top word.
template <int NA, int NB>
__device__ __forceinline__ void sc_sub_words(const u32 *a, const u32 *b, u32 *r) {
    r[0] = sub_cc(a[0], b[0]);
#pragma unroll
    for (int k = 1; k < NA - 1; ++k) r[k] = subc_cc(a[k], k < NB ? b[k] : 0u);
    r[NA - 1] = subc(a[NA - 1], NA - 1 < NB ? b[NA - 1] : 0u);
}

// t: 16 words, any value below 2^512 -> r: t mod l, 8 words, folding 2^252 = -delta (mod l) three times:
//   t  = H1 2^252 + L1, X1 = H1 delta < 2^385;  X1 = H2 2^252 + L2, X2 = H2 delta < 2^258;
//   t = L1 - L2 + X2 (mod l), and v = X2 + l + L1 - L2 lies in [0, 2^260);
//   v  = H3 2^252 + L3, H3 < 2^8;  r = L3 + l - H3 delta lies in (l - 2^133, l + 2^252): one conditional
//   subtraction of l.  120 multiply-adds.
__device__ __forceinline__ void sc_reduce_fold(const u32 t[16], u32 r[8]) {
    const u32 delta[4] = SC_DELTA;
    const u32 l[SC_N] = SC_L_WORDS;
    u32 h1[9], x1[13], h2[5], x2[9], lo[8], v[SC_N], x3[5], w[SC_N];
    sc_shr252<16, 9>(t, h1);
    sc_mul_wide<9, 4>(h1, delta, x1);
    sc_shr252<13, 5>(x1, h2);
    sc_mul_wide<5, 4>(h2, delta, x2);
    sc_add_words<SC_N, SC_N>(x2, l, v);
    sc_low252<8>(t, lo);
    sc_add_words<SC_N, 8>(v, lo, v);
    sc_low252<8>(x1, lo);
    sc_sub_words<SC_N, 8>(v, lo, v);
    const u32 h3 = __funnelshift_r(v[7], v[8], 28);
    sc_mul_wide<1, 4>(&h3, delta, x3);
    sc_low252<SC_N>(v, w);
    sc_add_words<SC_N, SC_N>(w, l, w);
    sc_sub_words<SC_N, 5>(w, x3, w);
    sc_csub_l(w, l);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = w[k];
}

// r = a * b mod l; r may be a or b.
__device__ __forceinline__ void sc_mul_l(const u32 *a, const u32 *b, u32 *r) {
    u32 t[16];
    sc_mul_wide<8, 8>(a, b, t);
    sc_reduce_fold(t, r);
}

__device__ __forceinline__ void sc_sqr_l(const u32 *a, u32 *r) { sc_mul_l(a, a, r); }

// r = a + b, less l where that does not borrow (nine words, then the low eight); r may be a or b.
__device__ __forceinline__ void sc_add_l(const u32 *a, const u32 *b, u32 *r) {
    const u32 l[SC_N] = SC_L_WORDS;
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
    const u32 l[SC_N] = SC_L_WORDS;
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

// ---------------------------------------------------------------------------
// The inverse mod l: Bernstein and Yang's divsteps (divsteps.cuh) with modulus
// l, its calling lanes leaving their loop when all have g = 0: the batches a
// lane runs past its own g = 0 leave d the same mod l.
// ---------------------------------------------------------------------------

#define SC_M30 DS_M30
#define SC_INV_BATCHES 20
#define SC_L_S30 {0x1cf5d3ed, 0x20498c69, 0x2f79cd65, 0x37be77a8, 0x14, 0, 0, 0, 0x1000}  // l in 30-bit limbs
#define SC_L_INV30 0x2dab81e5u  // l^-1 mod 2^30

struct ModL {
    static constexpr u32 inv30 = SC_L_INV30;
    __host__ __device__ static constexpr int32_t limb(int i) {
        constexpr int32_t limbs[9] = SC_L_S30;
        return limbs[i];
    }
};

// r = x^-1 mod l (inv(0) = 0); r may be x.  x must be canonical, below l: a non-zero multiple of l has no
// inverse here where Fermat's chain gave 0.  Every lane of `mask` calls it together, with the same mask, from
// converged code: the batches end by a vote of those lanes (`__all_sync`), so a lane outside the mask or one that
// does not arrive is undefined behaviour.
__device__ __forceinline__ void sc_inv_l_warp(const u32 *x, u32 *r, u32 mask) {
    int32_t f[9], g[9], d[9], e[9];
    words_to_s30(x, g);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        f[i] = ModL::limb(i);
        d[i] = 0;
        e[i] = i == 0;
    }
    int32_t zeta = -1;
#pragma unroll 1
    for (int batch = 0; batch < SC_INV_BATCHES; ++batch) {
        u32 live = 0u;
#pragma unroll
        for (int i = 0; i < 9; ++i) live |= (u32)g[i];
        if (__all_sync(mask, live == 0u)) break;
        int32_t t[4];
        zeta = divsteps_30(zeta, (u32)f[0], (u32)g[0], t);
        divsteps_update_de<ModL>(d, e, t);
        divsteps_update_fg(f, g, t);
    }
    divsteps_normalize<ModL>(d, f[8]);
    s30_to_words(d, r);
}
