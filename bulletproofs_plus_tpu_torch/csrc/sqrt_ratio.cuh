// K4's device code: x^((p-5)/8) and RFC 9496 SQRT_RATIO_M1 around it, in
// the two forms of one template, shared by pow.cu (K4's own entries) and
// ristretto.cu (D1 and C1, which run the same chain inline).
//
// Bound on this card: the chain.  An element needs 251 squarings and 11
// multiplications one after another, and the callers bring 128 to 4100
// elements: at one thread an element that is at most one warp on each of an
// SM's four schedulers, so the time is 262 times what one warp takes for a
// squaring, whatever the card could do beside it (the rate bound is some
// ten times lower).  A lone warp spends about two thirds of that time
// issuing the squaring's wide multiply-adds, which go through the
// scheduler's one multiplier at a quarter of the lane rate; the rest is
// carry arithmetic.
//
// Design: the whole chain in registers on the carry-flag arithmetic of
// field25519.cuh, no shared memory, the loops rolled to keep the code small,
// in two forms of one template.
//   One lane an element: a thread owns an element.  The form for many
//   elements, where every scheduler has several warps anyway.
//   Four lanes an element: lane t multiplies by words 2t and 2t + 1 of the
//   second operand, two rows of the product, so a warp issues 16 + 8 wide
//   multiply-adds a step instead of 43 + 8; two rounds of shuffles add the
//   four partial products at their offsets in the group's first lane, which
//   folds the sum and hands the result back to the other three.  A step has
//   more to issue in all, but a quarter of the multiplier's time, and
//   with at most 4224 elements (eight a warp, one warp on each of the 528
//   schedulers) nothing else wants that scheduler.  The launchers take this
//   form up to that count.  A step is a chain of dependent instructions
//   (a lone warp issues its some 120 SASS instructions well below one a
//   clock: chip_smoke.py's `fe_sqr4_ns`, `fe_mul4_ns` and the probe's SASS),
//   so what shortens the chain pays: the lane's two words of the
//   second operand are picked by two levels of selects, not three (the
//   product 12% and the squaring 2% faster on an H100).  Tried on the same
//   card and not kept: every lane gathering the whole product by xor
//   shuffles and folding it itself (no hand-back, but 44 more selects:
//   slower), eight lanes an element (a row a lane, a third shuffle round:
//   the squaring slower, D1 at 4096 elements 43% slower with two warps a
//   scheduler), and the fold's last carry by lookahead (slower).  A squaring
//   of only the 36 distinct word products cannot be split evenly over four
//   lanes that run one instruction stream: the products along each
//   diagonal j - i = d number 8 - d, which four lanes share evenly only for
//   d = 0 and 4, so the lanes would need per-lane operand selects that cost
//   more than the 7 products they save.

#pragma once

#include "field25519.cuh"

#define COOP_MAX_N 4224  // 132 SMs x 4 schedulers x 8 elements a warp

// Lanes an element: what the caller asks for (1 or 4), or by the count.
static inline bool four_lanes(long lanes, long n) { return lanes == 4 || (lanes == 0 && n <= COOP_MAX_N); }

// The multiplier of the one-lane form: the header's own.
struct OneLane {
    __device__ __forceinline__ fe mul(const fe &a, const fe &b) const { return fe_mul(a, b); }
    __device__ __forceinline__ fe sqr(const fe &a) const { return fe_sqr(a); }
};

// The multiplier of the four-lane form.  All four lanes of a group hold the
// same operands and get the same product; all 32 lanes of the warp must call
// it together.
struct FourLanes {
    int t;  // this lane's place in its group, 0 to 3

    __device__ __forceinline__ fe mul(const fe &a, const fe &b) const {
        const unsigned full = 0xFFFFFFFFu;
        // words 2t and 2t + 1 of b, picked by two levels of selects: each step begins by waiting for them
        const bool odd = t & 1, upper = t & 2;
        const u32 lo0 = odd ? b.w[2] : b.w[0], hi0 = odd ? b.w[6] : b.w[4];
        const u32 lo1 = odd ? b.w[3] : b.w[1], hi1 = odd ? b.w[7] : b.w[5];
        const u32 b0 = upper ? hi0 : lo0, b1 = upper ? hi1 : lo1;
        u32 e[16], o[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) e[k] = o[k] = 0u;
        fe_mul_row(e, o, a, b0, 0);
        fe_mul_row(e, o, a, b1, 1);
        u32 p[10];  // a * (b0 + b1 W), W = 2^32: this lane's share, to be weighed by W^(2t)
        p[0] = e[0];
        p[1] = add_cc(e[1], o[0]);
#pragma unroll
        for (int k = 2; k < 10; ++k) p[k] = addc_cc(e[k], o[k - 1]);
        u32 got[12];
#pragma unroll
        for (int k = 0; k < 10; ++k) got[k] = __shfl_down_sync(full, p[k], 1, 4);
        u32 s[12];  // p + W^2 * (the next lane's p): right in lanes 0 and 2
        s[0] = p[0];
        s[1] = p[1];
        s[2] = add_cc(p[2], got[0]);
#pragma unroll
        for (int k = 3; k < 10; ++k) s[k] = addc_cc(p[k], got[k - 2]);
        s[10] = addc_cc(0u, got[8]);
        s[11] = addc(0u, got[9]);
#pragma unroll
        for (int k = 0; k < 12; ++k) got[k] = __shfl_down_sync(full, s[k], 2, 4);
        u32 w[16];  // s + W^4 * (lane 2's s): the whole product, right in lane 0
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = s[k];
        w[4] = add_cc(s[4], got[0]);
#pragma unroll
        for (int k = 5; k < 12; ++k) w[k] = addc_cc(s[k], got[k - 4]);
#pragma unroll
        for (int k = 12; k < 15; ++k) w[k] = addc_cc(0u, got[k - 4]);
        w[15] = addc(0u, got[11]);
        fe r = fe_fold_wide(w);
#pragma unroll
        for (int k = 0; k < 8; ++k) r.w[k] = __shfl_sync(full, r.w[k], 0, 4);
        return r;
    }
    __device__ __forceinline__ fe sqr(const fe &a) const { return mul(a, a); }
};

template <class M>
__device__ __forceinline__ fe fe_sqr_n(const M &m, fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = m.sqr(x);
    return x;
}

// v^(2^252 - 3): 251 squarings, 11 multiplications.
template <class M>
__device__ __forceinline__ fe fe_pow_p58(const M &m, const fe &v) {
    fe z2 = m.sqr(v);
    fe z9 = m.mul(v, fe_sqr_n(m, z2, 2));
    fe z11 = m.mul(z2, z9);
    fe z_5_0 = m.mul(z9, m.sqr(z11));
    fe z_10_0 = m.mul(fe_sqr_n(m, z_5_0, 5), z_5_0);
    fe z_20_0 = m.mul(fe_sqr_n(m, z_10_0, 10), z_10_0);
    fe z_40_0 = m.mul(fe_sqr_n(m, z_20_0, 20), z_20_0);
    fe z_50_0 = m.mul(fe_sqr_n(m, z_40_0, 10), z_10_0);
    fe z_100_0 = m.mul(fe_sqr_n(m, z_50_0, 50), z_50_0);
    fe z_200_0 = m.mul(fe_sqr_n(m, z_100_0, 100), z_100_0);
    fe z_250_0 = m.mul(fe_sqr_n(m, z_200_0, 50), z_50_0);
    return m.mul(fe_sqr_n(m, z_250_0, 2), v);
}

// RFC 9496 SQRT_RATIO_M1(u, v) -> was_square; r comes out canonical and
// non-negative.
template <class M>
__device__ __forceinline__ bool fe_sqrt_ratio_m1(const M &m, const fe &u, const fe &v, fe &r) {
    const fe v3 = m.mul(m.sqr(v), v);
    const fe v7 = m.mul(m.sqr(v3), v);
    r = m.mul(m.mul(u, v3), fe_pow_p58(m, m.mul(u, v7)));
    const fe check = m.mul(v, m.sqr(r));
    const fe neg_u = fe_neg(u);
    const bool correct = fe_eq(check, u);
    const bool flipped = fe_eq(check, neg_u);
    const bool flipped_i = fe_eq(check, m.mul(neg_u, fe_sqrt_m1()));
    r = fe_abs(fe_select(flipped || flipped_i, m.mul(r, fe_sqrt_m1()), r));
    return correct || flipped;
}

// Thread g of the grid -> its element and its multiplier.  In the four-lane
// form thread 4 i + t is lane t of element i; blocks are whole warps and
// every lane runs the chain (lanes past n on element n - 1, without
// storing), so that the shuffles always find their partners.
template <class M>
struct Work;
template <>
struct Work<OneLane> {
    long i;
    bool live, stores;
    OneLane m;
    __device__ __forceinline__ Work(long g, long n) : i(g), live(g < n), stores(g < n), m() {}
};
template <>
struct Work<FourLanes> {
    long i;
    bool live, stores;
    FourLanes m;
    __device__ __forceinline__ Work(long g, long n)
        : i((g >> 2) < n ? (g >> 2) : n - 1), live(true), stores((g >> 2) < n && (g & 3) == 0), m{(int)(g & 3)} {}
};

// Blocks of `threads` for n elements in the chosen form.
static inline unsigned work_blocks(bool coop, long n, unsigned threads) {
    return (unsigned)(((coop ? 4 : 1) * n + threads - 1) / threads);
}
