// GF(2^255 - 19) and extended twisted Edwards point arithmetic (a = -1)
// shared by every kernel of the port.
//
// Counterpart of bulletproofs_plus_tpu/ops/pfield.py, the limb-major field
// and point layer of the TPU kernels.  There the TPU's 32-bit vector unit
// forced radix-2^16 limbs and lo/hi product splits; here a field element is
// eight 32-bit words and each limb product is one 32x32->64 multiply-add.
//
// Representation: `fe` holds any value below 2^256 (not necessarily below
// p).  Every operation accepts any such input and returns a value below
// 2^256 congruent to the exact result; `fe_canon` reduces below p where a
// kernel compares or encodes.  Each reduction folds the overflow through
// 2^256 == 38 (mod p) until the result provably fits: after the last
// fold a carry-out can still occur when the sum lands in [2^256, 2^256+38q),
// and the final `+38` of `fe_fold_top` covers exactly that window (the JAX
// package's pfield._fold16 fix).
//
// What bounds it on this card, and the design.  A product accumulated
// through one 64-bit carry (`c += a*b + t; t = (u32)c; c >>= 32`) makes all
// 64 limb products one dependent chain of multiply, add, truncate and shift.
// Here the product is row scanning on the hardware carry flag (mad.lo.cc /
// madc.hi.cc, which ptxas pairs into one IMAD.WIDE with carry): the products
// of a row that land on even words go to one accumulator and those on odd
// words to another, so every limb product is one instruction and no carry
// chain is longer than four products.  One carry chain then joins the two
// accumulators (its low words are ready while the last rows still
// multiply), eight independent multiply-adds fold the high half through 38,
// one carry pass settles them and the top carry is folded.  `fe_sqr`
// multiplies each word by itself and by the doubled words above it (43
// products instead of 64) on the same two accumulators.  Additions and
// subtractions are carry-flag chains as well.
//
// Compiled for sm_90a (cuobjdump -sass of the probe kernels in pow.cu,
// which chip_smoke.py's build phase prints): one fe_mul is 72
// IMAD.WIDE (64 limb products, 8 of the fold) and some 80 other SASS operations,
// of which about 35 are the carry adds (IADD3.X, IMAD.X); one fe_sqr is 50
// IMAD.WIDE and some 100 others, 20 of them the shifts that double the
// operand.  Measured on an H100 (chip_smoke.py's probe): a lone warp takes
// about 261 ns for a dependent fe_mul and 207 ns for an fe_sqr, 4.9 clocks
// for each IMAD.WIDE beyond a fixed 165; eight warps on a scheduler take 169
// ns and 134 ns an operation.  So the wide multiply-add, which an SM's
// scheduler issues about once in four clocks, bounds this code, not the
// carries: two variants that shortened the carry chains at the price of
// eight more IMAD.WIDE (no joining chain, 64-bit column sums instead) or of
// a rarely taken branch (the top carry's ripple) measured 3-10% slower and
// are not kept.
//
// ops/field_model.py repeats this file's carry logic word for word in
// Python; tests/test_torch_field.py holds that model against integers.
//
// At the kernel boundary values are radix-2^16 limbs held in int64 tensors,
// limb-major (16, n) so that neighbouring threads read neighbouring
// addresses.  Limbs must be below 2^16, which every torch op of the port
// guarantees.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

struct fe {
    u32 w[8];  // little-endian words, value < 2^256
};

struct ge {  // extended coordinates (X : Y : Z : T), x = X/Z, y = Y/Z, T = XY/Z
    fe x, y, z, t;
};

struct gn {  // an affine point precomputed for the mixed addition: y + x, y - x, 2d * x * y
    fe yp, ym, t2d;
};

// ---------------------------------------------------------------------------
// The carry flag.  One instruction a function, as the compiler's own PTX
// never touches the flag; `volatile` keeps the statements in order.
// ---------------------------------------------------------------------------

__device__ __forceinline__ u32 add_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 addc_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 addc(u32 a, u32 b) {
    u32 r;
    asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 sub_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 subc_cc(u32 a, u32 b) {
    u32 r;
    asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 subc(u32 a, u32 b) {  // a - b - borrow; subc(0, 0) is 0 or 0xFFFFFFFF
    u32 r;
    asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
    return r;
}
__device__ __forceinline__ u32 mad_lo_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_lo_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}
__device__ __forceinline__ u32 madc_hi_cc(u32 a, u32 b, u32 c) {
    u32 r;
    asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
    return r;
}

__device__ __forceinline__ fe fe_zero() {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = 0u;
    return r;
}

__device__ __forceinline__ fe fe_one() {
    fe r = fe_zero();
    r.w[0] = 1u;
    return r;
}

__device__ __forceinline__ fe fe_d2() {  // 2d mod p, d = -121665/121666
    fe r;
    r.w[0] = 0x26b2f159u; r.w[1] = 0xebd69b94u; r.w[2] = 0x8283b156u; r.w[3] = 0x00e0149au;
    r.w[4] = 0xeef3d130u; r.w[5] = 0x198e80f2u; r.w[6] = 0x56dffce7u; r.w[7] = 0x2406d9dcu;
    return r;
}

__device__ __forceinline__ fe fe_sqrt_m1() {  // sqrt(-1) mod p, the even root (RFC 9496)
    fe r;
    r.w[0] = 0x4a0ea0b0u; r.w[1] = 0xc4ee1b27u; r.w[2] = 0xad2fe478u; r.w[3] = 0x2f431806u;
    r.w[4] = 0x3dfbd7a7u; r.w[5] = 0x2b4d0099u; r.w[6] = 0x4fc1df0bu; r.w[7] = 0x2b832480u;
    return r;
}

// r + c * 2^256 -> value < 2^256, for c < 2^26.
__device__ __forceinline__ void fe_fold_top(fe &r, u32 c) {
    r.w[0] = add_cc(r.w[0], 38u * c);
#pragma unroll
    for (int k = 1; k < 8; ++k) r.w[k] = addc_cc(r.w[k], 0u);
    // A carry-out here means the wrapped r is below 38 * c < 2^32 - 38,
    // so adding the last 38 cannot carry again.
    r.w[0] += 38u * addc(0u, 0u);
}

__device__ __forceinline__ fe fe_add(const fe &a, const fe &b) {
    fe r;
    r.w[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) r.w[k] = addc_cc(a.w[k], b.w[k]);
    fe_fold_top(r, addc(0u, 0u));
    return r;
}

__device__ __forceinline__ fe fe_sub(const fe &a, const fe &b) {
    fe r;
    r.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) r.w[k] = subc_cc(a.w[k], b.w[k]);
    // A borrow left r = a - b + 2^256 == a - b + 38: take 38 off.
    r.w[0] = sub_cc(r.w[0], 38u & subc(0u, 0u));
#pragma unroll
    for (int k = 1; k < 8; ++k) r.w[k] = subc_cc(r.w[k], 0u);
    // Borrowing again means r was below 38 and now sits at or above
    // 2^256 - 38: one more 38 comes off the low word without underflow.
    r.w[0] -= 38u & subc(0u, 0u);
    return r;
}

__device__ __forceinline__ fe fe_neg(const fe &a) { return fe_sub(fe_zero(), a); }

// ---------------------------------------------------------------------------
// Products.  `e` collects the limb products that start on an even word, `o`
// those that start on an odd word: o[k] has the weight of word k + 1.
// ---------------------------------------------------------------------------

// acc[p], acc[p + 1] += x * y, opening a carry chain or continuing one.
__device__ __forceinline__ void mad_pair(u32 *acc, int p, u32 x, u32 y, bool first) {
    acc[p] = first ? mad_lo_cc(x, y, acc[p]) : madc_lo_cc(x, y, acc[p]);
    acc[p + 1] = madc_hi_cc(x, y, acc[p + 1]);
}

// The carry a chain leaves goes to the word after its last pair.  That word
// holds at most a carry of the row before, so it cannot overflow; past word
// 15 there is no carry, because the accumulators never exceed the product,
// which is below 2^512.
__device__ __forceinline__ void mad_chain_end(u32 *acc, int p) {
    if (p < 16) acc[p] = addc(acc[p], 0u);
}

// A value below 2^512 as 16 words, folded to a value below 2^256: eight
// independent multiply-adds fold the high half through 38, one carry pass
// settles them and the top carry is folded.
__device__ __forceinline__ fe fe_fold_wide(const u32 *t) {
    u64 s[8];  // t[k] + 38 * t[k + 8] < 39 * 2^32
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = (u64)t[k + 8] * 38u + t[k];
    fe r;
    r.w[0] = (u32)s[0];
    r.w[1] = add_cc((u32)s[1], (u32)(s[0] >> 32));
#pragma unroll
    for (int k = 2; k < 8; ++k) r.w[k] = addc_cc((u32)s[k], (u32)(s[k - 1] >> 32));
    fe_fold_top(r, addc((u32)(s[7] >> 32), 0u));  // at most 39
    return r;
}

// e + (o << 32), a value below 2^512, folded to a value below 2^256.  One
// carry chain joins the two accumulators first; its low words are ready
// while the last rows still multiply.
__device__ __forceinline__ fe fe_reduce_wide(const u32 *e, const u32 *o) {
    u32 t[16];
    t[0] = e[0];
    t[1] = add_cc(e[1], o[0]);
#pragma unroll
    for (int k = 2; k < 16; ++k) t[k] = addc_cc(e[k], o[k - 1]);
    return fe_fold_wide(t);
}

// Row i of the product: e, o += a * y * 2^(32 i), y standing for b.w[i].
__device__ __forceinline__ void fe_mul_row(u32 *e, u32 *o, const fe &a, u32 y, int i) {
    const int j0 = i & 1, j1 = 1 - j0;  // a.w[j] * y starts on word i + j
#pragma unroll
    for (int j = j0; j < 8; j += 2) mad_pair(e, i + j, a.w[j], y, j == j0);
    mad_chain_end(e, i + j0 + 8);
#pragma unroll
    for (int j = j1; j < 8; j += 2) mad_pair(o, i + j - 1, a.w[j], y, j == j1);
    mad_chain_end(o, i + j1 + 7);
}

// 64 wide multiply-adds in 16 carry chains of 4, then fe_reduce_wide.
__device__ __forceinline__ fe fe_mul(const fe &a, const fe &b) {
    u32 e[16], o[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) e[k] = o[k] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) fe_mul_row(e, o, a, b.w[i], i);
    return fe_reduce_wide(e, o);
}

// a^2 = sum_i a_i W^i * (a_i W^i + 2 * sum_{j>i} a_j W^j), W = 2^32.  Row i
// multiplies a_i by itself and by the words of 2 * (a >> 32 (i + 1)): the
// word above it shifted left, the doubled words beyond, and the bit that
// falls out at the top.  43 wide multiply-adds, no separate doubling pass.
__device__ __forceinline__ fe fe_sqr(const fe &a) {
    u32 d[9];  // 2a as nine words
    d[0] = a.w[0] << 1;
#pragma unroll
    for (int k = 1; k < 8; ++k) d[k] = (a.w[k] << 1) | (a.w[k - 1] >> 31);
    d[8] = a.w[7] >> 31;
    u32 e[16], o[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) e[k] = o[k] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        // operand word j of row i, j = i .. 8 (row 7 is a_7 * a_7 alone)
        u32 m[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) m[j] = j == i ? a.w[i] : (j == i + 1 && j < 8) ? a.w[j] << 1 : d[j];
        const int last = i == 7 ? 7 : 8;
        const int j0 = i, j1 = i + 1;  // i + j0 is even, i + j1 odd
#pragma unroll
        for (int j = j0; j <= last; j += 2) mad_pair(e, i + j, a.w[i], m[j], j == j0);
        mad_chain_end(e, i + j0 + 2 * ((last - j0) / 2) + 2);
#pragma unroll
        for (int j = j1; j <= last; j += 2) mad_pair(o, i + j - 1, a.w[i], m[j], j == j1);
        if (j1 <= last) mad_chain_end(o, i + j1 + 2 * ((last - j1) / 2) + 1);
    }
    return fe_reduce_wide(e, o);
}

// ---------------------------------------------------------------------------
// Canonical form and predicates
// ---------------------------------------------------------------------------

// The representative below p.
__device__ __forceinline__ fe fe_canon(const fe &a) {
    fe r = a;
    // 2^255 == 19: fold bit 255 down; r < 2^255 + 19 afterwards.
    const u32 q = r.w[7] >> 31;
    r.w[7] &= 0x7FFFFFFFu;
    r.w[0] = add_cc(r.w[0], 19u * q);
#pragma unroll
    for (int k = 1; k < 7; ++k) r.w[k] = addc_cc(r.w[k], 0u);
    r.w[7] = addc(r.w[7], 0u);
    // r >= p exactly when r + 19 reaches 2^255, and then r - p = r + 19 - 2^255.
    fe t;
    t.w[0] = add_cc(r.w[0], 19u);
#pragma unroll
    for (int k = 1; k < 7; ++k) t.w[k] = addc_cc(r.w[k], 0u);
    t.w[7] = addc(r.w[7], 0u);
    const bool ge_p = (t.w[7] >> 31) != 0u;
    t.w[7] &= 0x7FFFFFFFu;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = ge_p ? t.w[k] : r.w[k];
    return r;
}

__device__ __forceinline__ bool fe_eq(const fe &a, const fe &b) {
    const fe ca = fe_canon(a), cb = fe_canon(b);
    u32 diff = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) diff |= ca.w[k] ^ cb.w[k];
    return diff == 0u;
}

// a == 0 mod p: the canonical form is zero (I1's test, ristretto.cu, and K3's tail, msm.cu).
__device__ __forceinline__ bool fe_is_zero(const fe &a) {
    const fe c = fe_canon(a);
    u32 any = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) any |= c.w[k];
    return any == 0u;
}

// RFC 9496 negativity: the canonical form is odd.
__device__ __forceinline__ bool fe_is_negative(const fe &a) { return (fe_canon(a).w[0] & 1u) != 0u; }

__device__ __forceinline__ fe fe_select(bool c, const fe &a, const fe &b) {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = c ? a.w[k] : b.w[k];
    return r;
}

// The canonical form of |a|.
__device__ __forceinline__ fe fe_abs(const fe &a) {
    const fe c = fe_canon(a);
    return fe_select((c.w[0] & 1u) != 0u, fe_canon(fe_neg(c)), c);
}

// ---------------------------------------------------------------------------
// Points
// ---------------------------------------------------------------------------

__device__ __forceinline__ ge ge_identity() {
    ge p;
    p.x = fe_zero();
    p.y = fe_one();
    p.z = fe_one();
    p.t = fe_zero();
    return p;
}

// Complete addition, add-2008-hwcd-3 for a = -1 (8M + 1 multiply by 2d).
__device__ __forceinline__ ge ge_add(const ge &p, const ge &q) {
    fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
    fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
    fe c = fe_mul(fe_mul(p.t, q.t), fe_d2());
    fe zz = fe_mul(p.z, q.z);
    fe d = fe_add(zz, zz);
    fe e = fe_sub(b, a);
    fe f = fe_sub(d, c);
    fe g = fe_add(d, c);
    fe h = fe_add(b, a);
    ge r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = fe_mul(e, h);
    return r;
}

// Complete mixed addition, madd-2008-hwcd-3 for a = -1 with the second
// point affine and precomputed: 7M.  (1, 1, 0) is the identity.
__device__ __forceinline__ ge ge_madd(const ge &p, const gn &q) {
    fe a = fe_mul(fe_sub(p.y, p.x), q.ym);
    fe b = fe_mul(fe_add(p.y, p.x), q.yp);
    fe c = fe_mul(p.t, q.t2d);
    fe d = fe_add(p.z, p.z);
    fe e = fe_sub(b, a);
    fe f = fe_sub(d, c);
    fe g = fe_add(d, c);
    fe h = fe_add(b, a);
    ge r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = fe_mul(e, h);
    return r;
}

// identity + q by the same formulas with the constants folded: 1M.
// (X : Y : Z : T) = (2(yp - ym) : 2(yp + ym) : 4 : (yp - ym)(yp + ym)).
__device__ __forceinline__ ge ge_from_niels(const gn &q) {
    const fe e = fe_sub(q.yp, q.ym), h = fe_add(q.yp, q.ym);
    ge r;
    r.x = fe_add(e, e);
    r.y = fe_add(h, h);
    r.z = fe_zero();
    r.z.w[0] = 4u;
    r.t = fe_mul(e, h);
    return r;
}

// dbl-2008-hwcd for a = -1 (4M + 4S); complete, the identity included.
__device__ __forceinline__ ge ge_dbl(const ge &p) {
    fe a = fe_sqr(p.x);
    fe b = fe_sqr(p.y);
    fe zz = fe_sqr(p.z);
    fe c = fe_add(zz, zz);
    fe ab = fe_add(a, b);
    fe e = fe_sub(fe_sqr(fe_add(p.x, p.y)), ab);
    fe g = fe_sub(b, a);
    fe f = fe_sub(g, c);
    fe h = fe_neg(ab);
    ge r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = fe_mul(e, h);
    return r;
}

// ---------------------------------------------------------------------------
// Point operations that four lanes of a warp share
// ---------------------------------------------------------------------------
//
// A point operation is a few field operations deep but many wide: the four
// squarings of a doubling do not depend on each other, nor do its four
// products, nor the four first and four last products of an addition.  One
// thread runs them one after another all the same (ge_dbl is 4 fe_sqr + 4
// fe_mul deep, ge_add 9 fe_mul), and where a kernel is a chain of dependent
// point operations (the Horner doublings, a fold's tree) that depth is its
// time.  ge_dbl4 and ge_add4 give one point to a group of four adjacent lanes
// (lane & 3 = c) and let lane c run a whole, different field operation of
// each phase: SIMT runs the four in one instruction slot, so a doubling is
// 1 fe_sqr + 1 fe_mul deep and an addition 3 fe_mul.  Same formulas as ge_dbl
// and ge_add, so the same projective coordinates come out.
//
// Layout: lane c holds coordinate c of (X, Y, Z, T), one fe, and not the
// whole point.  Holding all 32 words in every lane would save the exchange
// before phase 1 (16 shuffles) but would need the four results spread to all
// four lanes after the last phase (32), and a tree level would move 32 words
// between groups instead of 8; it would also hold 24 more registers a lane.
// A doubling exchanges 48 words a lane and an addition 40.
//
// Exchanges are warp shuffles of the 8 words of an fe with the full mask
// (an exchange through shared memory and __syncwarp measured 4-10% slower an
// operation on a probe): every lane of the warp must call these functions
// together, in uniform control flow.  Groups with nothing to do carry the
// identity (ge4_identity) or keep their value behind a select, and store
// nothing.
// ops/pfield.py (pdbl4, padd4) runs the same lane schedule on torch tensors.

// Lane `src` of the warp's v (each lane names its own source): 8 shuffles.
__device__ __forceinline__ fe fe_from_lane(const fe &v, int src) {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = __shfl_sync(0xFFFFFFFFu, v.w[k], src);
    return r;
}

// Coordinate c of the identity (0 : 1 : 1 : 0).
__device__ __forceinline__ fe ge4_identity(int c) {
    fe r = fe_zero();
    r.w[0] = (c == 1 || c == 2) ? 1u : 0u;
    return r;
}

// dbl-2008-hwcd for a = -1 over four lanes; v is this lane's coordinate.
__device__ __forceinline__ fe ge_dbl4(const fe &v) {
    const int lane = threadIdx.x & 31, c = lane & 3, base = lane & 28;
    // exchange 1: X from lane 0 and Y from lane 1; only lane 3 uses them, for X + Y
    const fe px = fe_from_lane(v, base), py = fe_from_lane(v, base + 1);
    // phase 1: lane 0 A = X^2, lane 1 B = Y^2, lane 2 Z^2, lane 3 (X + Y)^2
    const fe sq = fe_sqr(fe_select(c == 3, fe_add(px, py), v));
    // exchange 2: every lane takes all four squares and forms E, F, G, H as ge_dbl does
    const fe a = fe_from_lane(sq, base), b = fe_from_lane(sq, base + 1);
    const fe zz = fe_from_lane(sq, base + 2), xy2 = fe_from_lane(sq, base + 3);
    const fe cc = fe_add(zz, zz);
    const fe ab = fe_add(a, b);
    const fe e = fe_sub(xy2, ab);
    const fe g = fe_sub(b, a);
    const fe f = fe_sub(g, cc);
    const fe h = fe_neg(ab);
    // phase 2: lane 0 X3 = E F, lane 1 Y3 = G H, lane 2 Z3 = G F, lane 3 T3 = E H
    return fe_mul(fe_select(c == 0 || c == 3, e, g), fe_select((c & 1) != 0, h, f));
}

// add-2008-hwcd-3 for a = -1 over four lanes; p and q are this lane's
// coordinates of the two points.  Beside the products a lone warp pays about
// a nanosecond for every instruction, so the additions and subtractions
// (some 20 instructions each) are shared out too: four of them (sub, add,
// sub, add) on operands that differ by lane, where one thread's ge_add runs
// nine, at the price of three short exchanges more; and the factor 2 of D
// goes through the multiplier of phase 2, which every lane runs anyway.
// (The same sharing in ge_dbl4 measured no faster: it trades three of six
// chains for as many selects and a third dependent exchange.)
__device__ __forceinline__ fe ge_add4(const fe &p, const fe &q) {
    const int lane = threadIdx.x & 31, c = lane & 3, base = lane & 28;
    const bool odd = (c & 1) != 0;
    // exchange 1: lane 0 takes Y1 from lane 1, lane 1 takes X2 from lane 0 (lanes 2 and 3 mirror them and
    // ignore it), so that lane 0 holds X1 and Y1, lane 1 X2 and Y2
    const fe got = fe_from_lane(fe_select(odd, p, q), lane ^ 1);
    const fe xx = fe_select(odd, got, p), yy = fe_select(odd, q, got);
    // sub, add: lane 0 Y1 - X1 and Y1 + X1, lane 1 Y2 - X2 and Y2 + X2
    const fe diff = fe_sub(yy, xx), sum = fe_add(yy, xx);
    // exchange 2: lane 0 takes Y2 - X2 from lane 1, lane 1 takes Y1 + X1 from lane 0
    const fe other = fe_from_lane(fe_select(odd, diff, sum), lane ^ 1);
    // phase 1: lane 0 A = (Y1 - X1)(Y2 - X2), lane 1 B = (Y1 + X1)(Y2 + X2), lane 2 Z1 Z2, lane 3 T1 T2
    const fe m = fe_mul(fe_select(c == 0, diff, fe_select(c == 1, other, p)),
                        fe_select(c == 0, other, fe_select(c == 1, sum, q)));
    // phase 2: lane 2 D = 2 Z1 Z2, lane 3 C = 2d T1 T2; lanes 0 and 1 multiply by 1, which changes no word
    fe k = fe_one();
    k.w[0] = c == 2 ? 2u : 1u;
    const fe m2 = fe_mul(m, fe_select(c == 3, fe_d2(), k));
    // exchange 3: lanes 0 and 1 swap A and B, lanes 2 and 3 D and C
    const fe partner = fe_from_lane(m2, lane ^ 1);
    const bool holds_hi = c == 1 || c == 2;  // B and D are the minuends
    const fe hi = fe_select(holds_hi, m2, partner), lo = fe_select(holds_hi, partner, m2);
    // sub, add: lanes 0 and 1 E = B - A and H = B + A, lanes 2 and 3 F = D - C and G = D + C
    const fe d = fe_sub(hi, lo), s = fe_add(hi, lo);
    // exchange 4: lane 1 takes F from lane 3, lane 3 takes H from lane 1
    const fe far = fe_from_lane(fe_select(c < 2, s, d), lane ^ 2);
    // phase 3: lane 0 T3 = E H, lane 1 X3 = E F, lane 2 Z3 = F G, lane 3 Y3 = G H
    const fe r = fe_mul(fe_select(c == 3, s, d), fe_select(odd, far, s));
    // exchange 5: back to (X, Y, Z, T): lane 0 from lane 1, lane 1 from lane 3, lane 3 from lane 0
    return fe_from_lane(r, base + (c == 0 ? 1 : c == 1 ? 3 : c == 2 ? 2 : 0));
}

// The sum of the points that the warp's lane groups hold, left in every
// group: levels at distances of 1, 2 and 4 groups, as many as `n_groups` (a
// power of two) asks for.
__device__ __forceinline__ fe ge4_warp_sum(fe acc, int n_groups) {
    const int lane = threadIdx.x & 31;
#pragma unroll 1
    for (int s = 1; s < n_groups && s < 8; s <<= 1) {
        const fe other = fe_from_lane(acc, lane ^ (4 * s));
        acc = ge_add4(acc, other);
    }
    return acc;
}

// Radix-2^16 int64 limbs -> words.  Limb i of the element sits at
// base[i * limb_stride].
__device__ __forceinline__ fe fe_load(const int64_t *__restrict__ base, long limb_stride) {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        u32 lo = (u32)base[(2 * k) * limb_stride];
        u32 hi = (u32)base[(2 * k + 1) * limb_stride];
        r.w[k] = lo | (hi << 16);
    }
    return r;
}

__device__ __forceinline__ void fe_store(int64_t *__restrict__ base, long limb_stride, const fe &a) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        base[(2 * k) * limb_stride] = (int64_t)(a.w[k] & 0xFFFFu);
        base[(2 * k + 1) * limb_stride] = (int64_t)(a.w[k] >> 16);
    }
}

// Point (4, 16, ...) layout: coordinate c, limb i at base[c * coord_stride + i * limb_stride].
__device__ __forceinline__ ge ge_load(const int64_t *__restrict__ base, long coord_stride, long limb_stride) {
    ge p;
    p.x = fe_load(base, limb_stride);
    p.y = fe_load(base + coord_stride, limb_stride);
    p.z = fe_load(base + 2 * coord_stride, limb_stride);
    p.t = fe_load(base + 3 * coord_stride, limb_stride);
    return p;
}

__device__ __forceinline__ void ge_store(int64_t *__restrict__ base, long coord_stride, long limb_stride,
                                         const ge &p) {
    fe_store(base, limb_stride, p.x);
    fe_store(base + coord_stride, limb_stride, p.y);
    fe_store(base + 2 * coord_stride, limb_stride, p.z);
    fe_store(base + 3 * coord_stride, limb_stride, p.t);
}

// Eight packed words (32-byte aligned) as two 16-byte accesses.
__device__ __forceinline__ fe fe_load_words(const uint4 *__restrict__ v) {
    const uint4 lo = __ldg(v), hi = __ldg(v + 1);
    fe r;
    r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
    r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
    return r;
}

// The same from shared memory, which the read-only path of __ldg does not serve.
__device__ __forceinline__ fe fe_load_words_shared(const uint4 *v) {
    const uint4 lo = v[0], hi = v[1];
    fe r;
    r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
    r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
    return r;
}

__device__ __forceinline__ void fe_store_words(uint4 *__restrict__ v, const fe &a) {
    v[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
    v[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

// A point as 32 packed words (x, y, z, t), 128 bytes.
__device__ __forceinline__ ge ge_load_words(const u32 *__restrict__ point) {
    const uint4 *v = reinterpret_cast<const uint4 *>(point);
    ge p;
    p.x = fe_load_words(v);
    p.y = fe_load_words(v + 2);
    p.z = fe_load_words(v + 4);
    p.t = fe_load_words(v + 6);
    return p;
}

__device__ __forceinline__ void ge_store_words(u32 *__restrict__ point, const ge &p) {
    uint4 *v = reinterpret_cast<uint4 *>(point);
    fe_store_words(v, p.x);
    fe_store_words(v + 2, p.y);
    fe_store_words(v + 4, p.z);
    fe_store_words(v + 6, p.t);
}

// Points in shared memory: 32 words plus one pad word per point, so reads
// of different points by one warp fall in different banks.
#define GE_SMEM_STRIDE 33

__device__ __forceinline__ void ge_to_smem(u32 *s, const ge &p) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        s[k] = p.x.w[k];
        s[8 + k] = p.y.w[k];
        s[16 + k] = p.z.w[k];
        s[24 + k] = p.t.w[k];
    }
}

__device__ __forceinline__ ge ge_from_smem(const u32 *s) {
    ge p;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        p.x.w[k] = s[k];
        p.y.w[k] = s[8 + k];
        p.z.w[k] = s[16 + k];
        p.t.w[k] = s[24 + k];
    }
    return p;
}
