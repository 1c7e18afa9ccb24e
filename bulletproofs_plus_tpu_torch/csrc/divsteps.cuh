// Modular inversion by Bernstein and Yang's divsteps ("Fast constant-time gcd
// computation and modular inversion", 2019) on nine signed 30-bit limbs, in
// batches of 30 divsteps applied as one 2 x 2 matrix, as libsecp256k1's
// modinv32 arranges them, for any odd modulus below 2^256: the steps are
// templates over the modulus (`Mod::limb(i)`, its 30-bit limbs, and
// `Mod::inv30`, its inverse mod 2^30).  Three users:
//   scalar_l.cuh `sc_inv_l_warp`, the inverse mod l of S1 (scalar_pass.cu),
//     whose calling lanes leave their loop when all have g = 0: its lanes
//     invert different values in lock-step, where a loop whose length
//     depends on the data would diverge;
//   `fe_inv` below, the inverse mod p = 2^255 - 19 of C1's double-and-encode
//     (ristretto.cu), which runs a fixed DS_BATCHES with no exit: its inputs
//     are coordinates of points built from the prover's secret masks, and
//     the reference's encoding takes the same time for every input;
//   scalar_l.cuh `sc_inv_l_var`, T1's inverse of a Fiat-Shamir challenge
//     (transcript.cu), a warp for one value, on the jumps of four steps and
//     the warp's update below (`divsteps_30_jump`, `divsteps_settle`): a
//     challenge is public, since any verifier recomputes it from the proof,
//     so the time its inversion takes tells nothing.  Only public values
//     may take them.
//
// From f = M, g = x, d = 0, e = 1 each batch keeps f = d x and g = e x
// (mod M); once g = 0, f = +-1 and x^-1 = +-d.  600 divsteps (20 batches)
// suffice for any modulus and input below 2^256; random inputs reach g = 0
// after 17 or 18.  The divsteps are branch-free (selects on zeta < 0 and g
// odd), and batches run past g = 0 leave d the same mod M.  inv(0) = 0: g
// starts at 0 and d stays 0.
//
// ops/scalar_model.py repeats these steps word for word (`divsteps_30`,
// `_update_de`, `_update_fg`, `_normalize`; `jump4_table`,
// `divsteps_30_jump`, `settle`), and ops/field_model.py `fe_inv` the
// inversion mod p.

#pragma once

#include <cuda_pipeline.h>

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

// ---------------------------------------------------------------------------
// Divsteps four at a time, for public values (T1's `sc_inv_l_var`)
// ---------------------------------------------------------------------------

// The steps of 30 divsteps, in the same zeta form, seven jumps of four steps and two single steps.  A jump's
// matrix and its effect on zeta follow from zeta clamped to [-4, 3] (outside it the four steps decide alike: at
// most one swap, after which zeta stays >= 0), f mod 16 and g mod 16: entry (clamp(zeta) + 4) << 7 | (f mod 16) >> 1
// << 4 | g mod 16 of DS_JUMP4 holds M, 2^4 (f4, g4) = M (f, g), its entries in [-16, 16] as four signed bytes, then
// zeta4 = s zeta + c as c (a signed byte) at bit 32 and s < 0 at bit 40.  Built at compile time;
// ops/scalar_model.py `jump4_table` builds the same.  The jumps replace libsecp256k1's zero counts (BREV and FLO,
// 18 cycles each here) and bit cancellations: a jump's chain is a shared-memory load and two products.
struct __align__(16) DsJump4 {
    unsigned long long e[1024];
};

__host__ __device__ constexpr DsJump4 ds_jump4_table() {
    DsJump4 t{};
    for (int idx = 0; idx < 1024; ++idx) {
        int zeta = (idx >> 7) - 4, s = 1, c = 0;
        long long f = 2 * ((idx >> 4) & 7) + 1, g = idx & 15, u = 1, v = 0, q = 0, r = 1;
        for (int k = 0; k < 4; ++k) {
            if (zeta < 0 && (g & 1)) {
                const long long f1 = g, g1 = (g - f) >> 1, u1 = 2 * q, v1 = 2 * r, q1 = q - u, r1 = r - v;
                f = f1;
                g = g1;
                u = u1;
                v = v1;
                q = q1;
                r = r1;
                zeta = -zeta - 2;
                s = -s;
                c = -c - 2;
            } else {
                if (g & 1) {
                    g += f;
                    q += u;
                    r += v;
                }
                g >>= 1;
                u *= 2;
                v *= 2;
                zeta -= 1;
                c -= 1;
            }
        }
        t.e[idx] = (unsigned long long)(u & 0xff) | (unsigned long long)(v & 0xff) << 8 |
                   (unsigned long long)(q & 0xff) << 16 | (unsigned long long)(r & 0xff) << 24 |
                   (unsigned long long)(c & 0xff) << 32 | (unsigned long long)(s < 0) << 40;
    }
    return t;
}

__device__ const DsJump4 DS_JUMP4 = ds_jump4_table();

// The warp's copy of DS_JUMP4 into shared memory (`jump`, 16-byte aligned), started without waiting: 16 asynchronous
// 16-byte copies a lane, so the loads run while the warp does other work.  `ds_jump4_wait` before the first lookup.
// Each warp copies the whole table and waits for its own copies: warps of a block that share `jump` write the same
// bytes, and none needs another's.
__device__ __forceinline__ void ds_jump4_copy(unsigned long long *jump) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < 16; ++k)
        __pipeline_memcpy_async(jump + 2 * (32 * k + lane), DS_JUMP4.e + 2 * (32 * k + lane), 16);
    __pipeline_commit();
}

__device__ __forceinline__ void ds_jump4_wait() {
    __pipeline_wait_prior(0);
    __syncwarp();
}

// divsteps_30's matrix and zeta by jumps from `jump` (DS_JUMP4, in shared memory): the words f and g are exact mod
// 2^(32 - 4 j) after j jumps, enough for the steps left.
__device__ __forceinline__ int32_t divsteps_30_jump(int32_t zeta, u32 f, u32 g, int32_t t[4],
                                                    const unsigned long long *jump) {
    int32_t u = 1, v = 0, q = 0, r = 1;
#pragma unroll
    for (int j = 0; j < 7; ++j) {
        const int zc = min(max(zeta, -4), 3) + 4;
        const unsigned long long e = jump[(zc << 7) | (((f >> 1) & 7u) << 4) | (g & 15u)];
        const u32 lo = (u32)e, hi = (u32)(e >> 32);
        const int32_t a = (int8_t)lo, b = (int8_t)(lo >> 8), c = (int8_t)(lo >> 16), d = (int8_t)(lo >> 24);
        const u32 nf = ((u32)a * f + (u32)b * g) >> 4, ng = ((u32)c * f + (u32)d * g) >> 4;
        f = nf;
        g = ng;
        const int32_t nu = a * u + b * q, nv = a * v + b * r, nq = c * u + d * q, nr = c * v + d * r;
        u = nu;
        v = nv;
        q = nq;
        r = nr;
        zeta = (((hi >> 8) & 1u) ? -zeta : zeta) + (int32_t)(int8_t)hi;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // steps 29 and 30 as divsteps_30 takes them
        const bool neg = zeta < 0, odd = g & 1u, swap = neg && odd;
        const u32 x = neg ? 0u - f : f;
        const int32_t y = neg ? -u : u, z = neg ? -v : v;
        const u32 g2 = odd ? g + x : g;
        const int32_t q2 = odd ? q + y : q, r2 = odd ? r + z : r;
        f = swap ? g : f;
        u = swap ? q : u;
        v = swap ? r : v;
        zeta = swap ? -zeta - 2 : zeta - 1;
        g = g2 >> 1;
        q = q2;
        r = r2;
        u *= 2;
        v *= 2;
    }
    t[0] = u;
    t[1] = v;
    t[2] = q;
    t[3] = r;
    return zeta;
}

// A 2 x 2 update spread over a warp, both rows at once: lane i of each half (i = lane & 15) holds limb i of two
// values as 64-bit sums pa and pb of its products (limbs 9-15 zero), each sum P = sum p_i 2^(30 i) a multiple of
// 2^30.  Sets a and b to limb i of P / 2^30 (limbs 0-7 in [0, 2^30), limb 8 signed, 0 past it): position i + 1,
// the low 30 bits of lane i + 1's sum and the rest of its own; then carries, a few at first and -1, 0 or 1 after,
// move up a limb a round (shuffles within each half) until none is left in either.  Every lane calls it,
// converged.
__device__ __forceinline__ void divsteps_settle(int64_t pa, int64_t pb, int i, int32_t &a, int32_t &b) {
    const int32_t la = __shfl_down_sync(0xffffffffu, (int32_t)(pa & DS_M30), 1, 16);
    const int32_t lb = __shfl_down_sync(0xffffffffu, (int32_t)(pb & DS_M30), 1, 16);
    const int64_t sa = (int64_t)(i < 8 ? la : 0) + (pa >> 30), sb = (int64_t)(i < 8 ? lb : 0) + (pb >> 30);
    int32_t ca = __shfl_up_sync(0xffffffffu, (int32_t)(sa >> 30), 1, 16);
    int32_t cb = __shfl_up_sync(0xffffffffu, (int32_t)(sb >> 30), 1, 16);
    if (i == 0) ca = cb = 0;
    int32_t va = (int32_t)(sa & DS_M30) + ca, vb = (int32_t)(sb & DS_M30) + cb;
    int64_t ta = sa + ca, tb = sb + cb;
#pragma unroll 1
    while (__any_sync(0xffffffffu, i < 8 && (va < 0 || va > DS_M30 || vb < 0 || vb > DS_M30))) {
        ca = __shfl_up_sync(0xffffffffu, i < 8 ? va >> 30 : 0, 1, 16);
        cb = __shfl_up_sync(0xffffffffu, i < 8 ? vb >> 30 : 0, 1, 16);
        if (i == 0) ca = cb = 0;
        if (i < 8) {
            va = (va & DS_M30) + ca;
            vb = (vb & DS_M30) + cb;
        } else {
            ta += ca;
            tb += cb;
        }
    }
    a = i < 8 ? va : i == 8 ? (int32_t)ta : 0;
    b = i < 8 ? vb : i == 8 ? (int32_t)tb : 0;
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
