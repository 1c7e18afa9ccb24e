// Modular inversion by Bernstein and Yang's divsteps ("Fast constant-time gcd
// computation and modular inversion", 2019) on nine signed 30-bit limbs, in
// batches of 30 divsteps applied as one 2 x 2 matrix, as libsecp256k1's
// modinv32 arranges them, for any odd modulus below 2^256: the steps are
// templates over the modulus (`Mod::limb(i)`, its 30-bit limbs, and
// `Mod::inv30`, its inverse mod 2^30).  Two users:
//   scalar_l.cuh `sc_inv_l_warp`, the inverse mod l of S1 (scalar_pass.cu),
//     whose calling lanes leave their loop when all have g = 0;
//   `fe_inv` below, the inverse mod p = 2^255 - 19 of C1's double-and-encode
//     (ristretto.cu), which runs a fixed DS_BATCHES with no exit: its inputs
//     are coordinates of points built from the prover's secret masks, and
//     the reference's encoding takes the same time for every input.
// From f = M, g = x, d = 0, e = 1 each batch keeps f = d x and g = e x
// (mod M); once g = 0, f = +-1 and x^-1 = +-d.  600 divsteps (20 batches)
// suffice for any modulus and input below 2^256; random inputs reach g = 0
// after 17 or 18.  The divsteps are branch-free (selects on zeta < 0 and g
// odd), and batches run past g = 0 leave d the same mod M.  inv(0) = 0: g
// starts at 0 and d stays 0.
//
// ops/scalar_model.py repeats these steps word for word (`divsteps_30`,
// `_update_de`, `_update_fg`, `_normalize`), and ops/field_model.py `fe_inv`
// the inversion mod p.

#pragma once

#include "field25519.cuh"

#define DS_M30 0x3fffffff
#define DS_BATCHES 20

// 30 divsteps on the low words of f (odd) and g; zeta = -(delta + 1/2).  t: the transition matrix (u, v, q, r)
// scaled by 2^30, each entry in [-2^30, 2^30].  Each step is selects on two conditions, zeta < 0 and g odd: g (and
// q, r) gains f (u, v) negated where zeta < 0, where g is odd; where both hold, f (u, v) takes the old g (q, r),
// which is f plus the new g, and zeta becomes -zeta - 2, else zeta - 1; then g halves and u, v double.  g's own
// path is a parity, an addition and a shift a step.
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, u32 f, u32 g, int32_t t[4]) {
    u32 u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
    for (int i = 0; i < 30; ++i) {
        const bool neg = zeta < 0, odd = g & 1u, swap = neg && odd;
        const u32 x = neg ? 0u - f : f, y = neg ? 0u - u : u, z = neg ? 0u - v : v;
        const u32 g2 = odd ? g + x : g, q2 = odd ? q + y : q, r2 = odd ? r + z : r;
        f = swap ? g : f;
        u = swap ? q : u;
        v = swap ? r : v;
        zeta = swap ? -zeta - 2 : zeta - 1;
        g = g2 >> 1;
        q = q2;
        r = r2;
        u <<= 1;
        v <<= 1;
    }
    t[0] = (int32_t)u;
    t[1] = (int32_t)v;
    t[2] = (int32_t)q;
    t[3] = (int32_t)r;
    return zeta;
}

// (d, e) <- t (d, e) / 2^30 mod M: md and me multiples of M clear the low 30 bits; d and e stay in (-2M, M).
// Limbs of M that are zero add nothing and are skipped.
template <class Mod>
__device__ __forceinline__ void divsteps_update_de(int32_t *d, int32_t *e, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    const int32_t sd = d[8] >> 31, se = e[8] >> 31;
    int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
    int64_t cd = (int64_t)u * d[0] + (int64_t)v * e[0];
    int64_t ce = (int64_t)q * d[0] + (int64_t)r * e[0];
    md -= (int32_t)((Mod::inv30 * (u32)cd + (u32)md) & DS_M30);
    me -= (int32_t)((Mod::inv30 * (u32)ce + (u32)me) & DS_M30);
    cd += (int64_t)Mod::limb(0) * md;
    ce += (int64_t)Mod::limb(0) * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        cd += (int64_t)u * d[i] + (int64_t)v * e[i];
        ce += (int64_t)q * d[i] + (int64_t)r * e[i];
        if (Mod::limb(i)) {
            cd += (int64_t)Mod::limb(i) * md;
            ce += (int64_t)Mod::limb(i) * me;
        }
        d[i - 1] = (int32_t)cd & DS_M30;
        e[i - 1] = (int32_t)ce & DS_M30;
        cd >>= 30;
        ce >>= 30;
    }
    d[8] = (int32_t)cd;
    e[8] = (int32_t)ce;
}

// (f, g) <- t (f, g) / 2^30, exact.
__device__ __forceinline__ void divsteps_update_fg(int32_t *f, int32_t *g, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    int64_t cf = (int64_t)u * f[0] + (int64_t)v * g[0];
    int64_t cg = (int64_t)q * f[0] + (int64_t)r * g[0];
    cf >>= 30;
    cg >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        cf += (int64_t)u * f[i] + (int64_t)v * g[i];
        cg += (int64_t)q * f[i] + (int64_t)r * g[i];
        f[i - 1] = (int32_t)cf & DS_M30;
        g[i - 1] = (int32_t)cg & DS_M30;
        cf >>= 30;
        cg >>= 30;
    }
    f[8] = (int32_t)cf;
    g[8] = (int32_t)cg;
}

// d in (-2M, M) -> d, negated where sign < 0, in [0, M): add M where negative, negate, carry; add M where
// still negative, carry.
template <class Mod>
__device__ __forceinline__ void divsteps_normalize(int32_t *d, int32_t sign) {
#pragma unroll
    for (int round = 0; round < 2; ++round) {
        const int32_t add = d[8] >> 31;
#pragma unroll
        for (int i = 0; i < 9; ++i) d[i] += Mod::limb(i) & add;
        if (round == 0) {
            const int32_t neg = sign >> 31;
#pragma unroll
            for (int i = 0; i < 9; ++i) d[i] = (d[i] ^ neg) - neg;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            d[i + 1] += d[i] >> 30;
            d[i] &= DS_M30;
        }
    }
}

// 8 words -> nine 30-bit limbs, and back (limbs in [0, 2^30)).
__device__ __forceinline__ void words_to_s30(const u32 *x, int32_t *s) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        const int w = (30 * i) >> 5;
        s[i] = (int32_t)(__funnelshift_r(x[w], w + 1 < 8 ? x[w + 1] : 0u, (30 * i) & 31) & DS_M30);
    }
}

__device__ __forceinline__ void s30_to_words(const int32_t *s, u32 *r) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const int i = (32 * k) / 30, off = (32 * k) % 30;
        r[k] = ((u32)s[i] >> off) | ((u32)s[i + 1] << (30 - off));
    }
}

// p = 2^255 - 19 in 30-bit limbs, and p^-1 mod 2^30.
struct ModP {
    static constexpr u32 inv30 = 0x179435e5u;
    __host__ __device__ static constexpr int32_t limb(int i) {
        return i == 0 ? 0x3fffffed : i == 8 ? 0x7fff : 0x3fffffff;
    }
};

// x^-1 mod p for any x below 2^256 (inv(0) = 0), canonical: DS_BATCHES batches whatever the input, no exit.
__device__ __forceinline__ fe fe_inv(const fe &x) {
    const fe c = fe_canon(x);
    int32_t f[9], g[9], d[9], e[9];
    words_to_s30(c.w, g);
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        f[i] = ModP::limb(i);
        d[i] = 0;
        e[i] = i == 0;
    }
    int32_t zeta = -1;
#pragma unroll 1
    for (int batch = 0; batch < DS_BATCHES; ++batch) {
        int32_t t[4];
        zeta = divsteps_30(zeta, (u32)f[0], (u32)g[0], t);
        divsteps_update_de<ModP>(d, e, t);
        divsteps_update_fg(f, g, t);
    }
    divsteps_normalize<ModP>(d, f[8]);
    fe r;
    s30_to_words(d, r.w);
    return r;
}
