// P1-P4: the batched prover's scalar protocol and the A commitment's masked
// sum, for B proofs of one shape in lockstep.
//
// Replaces no Pallas kernel: the counterpart is the XLA program the JAX
// package jits around the fixed-base kernels K5 and K6, `_prover_fn_core`
// (bulletproofs_plus_tpu/models/prover_device.py:90): its vector prep
// (:199-221), its round body (:226-340), its final masks and responses
// (:342-405) and its A commitment's masked halving sums (:163-181).  In the
// port these were plain torch, some 40,000 launches of int64 limb arithmetic
// a 128-proof prove; the plain versions stay as the port's
// models/prover_kernels.py `*_plain`, which these kernels equal.
//
//   P1 `prove_prep_kernel`     once a prove: the vectors a and b, y^1..y^(mn+1),
//                              y^-n of each round and alpha's z-term;
//   P2 `prove_round_kernel`    once a round: the fold by the previous round's
//                              challenge (none in round 0), then c_L, c_R and
//                              the round's L/R MSM scalars;
//   P3 `prove_final_kernel`    after the last round: its fold, then a0, b0 and
//                              the A1 and B MSM scalars;
//      `prove_responses_kernel` after the final challenge: r1, s1 and d1;
//   P4 `bit_sum_kernel`        A = alpha's Pedersen point + sum_i (bit_i ? g_i : -h_i).
//
// Vectors are compact.  The JAX program keeps a and b spread over all mn
// lanes (after round r lane i holds the folded value of position i mod n)
// and folds them by rolls; here a and b hold their 2n distinct values, and
// only the generator coefficients g_coeff and h_coeff, which differ on every
// original lane, stay mn wide.  With n the round's half and lane i's bit
// log2(n) its "hi" bit (i mod 2n >= n), round r writes for lane i, p = i mod n:
//   hi: g-scalar g_i a_p y^-n  (L)   h-scalar h_i b_p      (R)
//   lo: g-scalar g_i a_(p+n) y^n (R) h-scalar h_i b_(p+n)  (L)
// straight into the order of the JAX program's lane permutation `perm`
// (L's g lanes, L's h lanes, R's g lanes, R's h lanes, each rising): lane i is
// the k-th of its kind with k = (i >> (log2 n + 1)) n + p.  Each group ends
// with the Pedersen lanes [d_1..d_deg, c], so one grouped fixed-base MSM over
// the generator tables joined with [G_1..G_deg, H] gives L and R whole.
//
// Arithmetic: GF(l) of scalar_l.cuh (`sc_mul_l`, `sc_add_l`, `sc_sub_l`),
// every value canonical, so each output equals the plain version limb for
// limb whatever order its products and sums take (c_L and c_R are sums of
// `sc_add_l` by shuffles, as `_batch_sum_l` is one exact sum and one
// reduction).
// P4 is point code on field25519.cuh: the generators are read from the fixed
// tables' window 0, digit 1 entry, the affine (y + x, y - x, 2d x y) of the
// point, and -h swaps its first two words; a point enters the sum as
// (2(y+x - (y-x)), 2(y+x + y-x), 4, (y+x - (y-x))(y+x + y-x)) = 4 (x, y, 1, x y),
// and the block sums them on fold4.cuh's four-lane adders (ge_add4), starting
// from alpha's point, so that A goes straight to the encoder C1.
//
// What bounds them on this card: latency and the launch.  A 128-proof,
// mn = 64 prove needs some 0.45 M products mod l in all, under 0.01 ms at the
// multiply rate, spread over 1 + rounds + 2 launches; each thread runs a few
// to a few dozen dependent products (P1's y^k by squaring and multiplying),
// and P4 a chain of four-lane additions.  P2 and P3 are redesigned for that
// latency: more threads a proof, so that no thread runs more than a few
// products, values handed on through shared memory, few or no barriers, one
// copy of the product and 16-byte accesses (below); P3's second entry a
// thread an output.

#include "fold4.cuh"
#include "scalar_l.cuh"

#define PR_MAX_THREADS 256  // P1: a block a proof, up to 256 threads striding over its lanes
#define PR_RESP_THREADS 32  // P3's second entry: a thread an output, a warp a block
#define PR_ENTRY_WORDS 24   // a fixed table entry: y + x, y - x, 2d x y, 8 words each
#define PR_MAX_M 1024       // P1's z^(2(j+1)) in 32 KB of shared memory

// l - 1, the a_R entry of a zero bit
__device__ __forceinline__ void set_l_minus_1(u32 *r) {
    r[0] = 0x5cf5d3ecu; r[1] = 0x5812631au; r[2] = 0xa2f79cd6u; r[3] = 0x14def9deu;
    r[4] = 0u; r[5] = 0u; r[6] = 0u; r[7] = 0x10000000u;
}

// r = x^k for k >= 1, square and multiply from k's top bit.
__device__ __forceinline__ void sc_pow_small(const u32 *x, unsigned k, u32 *r) {
    copy8(r, x);
    for (int bit = 30 - __clz(k); bit >= 0; --bit) {
        sc_sqr_l(r, r);
        if ((k >> bit) & 1u) sc_mul_l(r, x, r);
    }
}

// Element j of proof b in a (B, X, 16) limb tensor.
__device__ __forceinline__ const int64_t *at(const int64_t *p, long b, long x, long j) { return p + 16 * (b * x + j); }
__device__ __forceinline__ int64_t *at(int64_t *p, long b, long x, long j) { return p + 16 * (b * x + j); }

// P1.  y, z, y_inv: (B, 16); bits: (B, mn) in {0, 1}; r_blind: (B, m, deg, 16); alpha0: (B, deg, 16).
// Out: a, b (B, mn, 16); y_pows (B, mn + 1, 16), y^1..y^(mn+1); y_inv_n (B, rounds, 16), y^-(mn >> (r + 1));
// alpha (B, deg, 16).  Dynamic shared memory: z^(2(j+1)) for j < m, 8 words each.
__global__ void __launch_bounds__(PR_MAX_THREADS) prove_prep_kernel(
    const int64_t *__restrict__ y_in, const int64_t *__restrict__ z_in, const int64_t *__restrict__ yinv_in,
    const int64_t *__restrict__ bits, const int64_t *__restrict__ r_blind, const int64_t *__restrict__ alpha0,
    int m, int n, int deg, int rounds, int64_t *__restrict__ a_out, int64_t *__restrict__ b_out,
    int64_t *y_pows, int64_t *__restrict__ yinv_out, int64_t *__restrict__ alpha_out) {
    extern __shared__ u32 z2[];
    const long b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x, mn = m * n;
    u32 y[8], z[8], u[8], v[8], w[8];
    load_limbs(y_in + 16 * b, y);
    load_limbs(z_in + 16 * b, z);
    if (t == 0) {
        u32 zsq[8];
        sc_sqr_l(z, zsq);
        copy8(u, zsq);
        for (int j = 0; j < m; ++j) {
            copy8(z2 + 8 * j, u);
            if (j + 1 < m) sc_mul_l(u, zsq, u);
        }
        load_limbs(yinv_in + 16 * b, u);  // y^-n for n = 1, 2, 4, ..: the last round first
        for (int r = rounds - 1; r >= 0; --r) {
            store_limbs(at(yinv_out, b, rounds, r), u);
            if (r) sc_sqr_l(u, u);
        }
    }
    for (int k = t + 1; k <= mn + 1; k += T) {
        sc_pow_small(y, (unsigned)k, u);
        store_limbs(at(y_pows, b, mn + 1, k - 1), u);
    }
    __syncthreads();  // z^(2(j+1)) in shared memory, y's powers in device memory
    for (int i = t; i < mn; i += T) {
        const int j = i / n, k = i % n;
        const u32 bit = (u32)bits[b * mn + i];
        set_small(u, bit);
        sc_sub_l(u, z, u);  // a_i = bit - z
        store_limbs(at(a_out, b, mn, i), u);
        set_small(v, 0u);  // d_i = z^(2(j+1)) 2^k
        v[k >> 5] = 1u << (k & 31);
        sc_mul_l(z2 + 8 * j, v, v);
        load_limbs(at(y_pows, b, mn + 1, mn - i - 1), w);  // y^(mn - i)
        sc_mul_l(v, w, v);
        sc_add_l(v, z, v);
        if (!bit) {  // a_R = bit - 1
            set_l_minus_1(w);
            sc_add_l(w, v, v);
        }
        store_limbs(at(b_out, b, mn, i), v);
    }
    for (int k = t; k < deg; k += T) {  // alpha_k + sum_j z^(2(j+1)) y^(mn+1) r_jk
        load_limbs(at(y_pows, b, mn + 1, mn), w);
        load_limbs(at(alpha0, b, deg, k), u);
        for (int j = 0; j < m; ++j) {
            sc_mul_l(z2 + 8 * j, w, v);
            u32 r[8];
            load_limbs(r_blind + 16 * ((b * m + j) * deg + k), r);
            sc_mul_l(v, r, v);
            sc_add_l(u, v, u);
        }
        store_limbs(at(alpha_out, b, deg, k), u);
    }
}

// P2, round r of `rounds` (n = mn >> (r + 1), len = 2n the vectors' length after the fold).  a_in, b_in: (B, 2 len,
// 16) with a fold, else (B, len, 16); g_in, h_in: (B, mn, 16) with a fold, else unused; e_in, ei_in: (B, 16) the
// previous round's challenge and its inverse, null in round 0; dl_prev, dr_prev: that round's masks; dl, dr: this
// round's (B, deg, 16).  Out: a, b (B, len, 16); g, h (B, mn, 16); alpha (B, deg, 16); scalars (B, 2 (mn + deg +
// 1), 16), group L then group R, each [g lanes, h lanes, d_1..d_deg, c].
//
// A block a proof of T threads: TL = T - 32 lane threads (2 mn, from 32 to 512: ops/cuda_prover.round_threads)
// and one warp for alpha's fold and the Pedersen lanes' masks, which no lane thread waits for.  Before the one
// barrier of the values: lane item q < mn (thread q) folds lane q's g and keeps g y^(-+n), the factor its L/R
// scalar takes with a (hi lanes L's y^-n, lo lanes R's y^n); item mn + q folds h; fold item j (thread TL - 1 - j,
// so on h threads) folds a_j or b_j and, for a, keeps a'_j y^(1 + j), c_L's and c_R's factor.  The folded values
// stay in `buf` as 8-word values (shared memory; a scratch in device memory where a proof's do not fit), not the
// outputs' int64 limbs.  After it: each lane item's one product with a' or b'; c_L's terms a'_j y^(1+j) b'_(j+n)
// on threads j, c_R's a'_(n+j) y^(n+1+j) b'_j on threads TL / 2 + j; both sums by shuffles within each warp, the
// warps' partial sums by one thread after a second barrier.  Longest chain at 128 x mn 64: an h thread's h, a's
// factor e^-1 y^len, its fold and a' y^(1+j) before the barrier, a g thread's scalar and c_L's term after it, then
// the sums.  Every product is one call of one copy (`sc_mul_v`), and every value moves as 16-byte accesses
// (`load_limbs16`).  The `// P2 phase:` comments mark the phases that scripts/profile_torch_p2.py stamps.
#define P2_MAX_THREADS 544  // 512 lane threads and the alpha warp: 120 registers a thread
#define P2_MAX_SMEM 232448  // shared memory a block may use: 227 KB

// 8-word values of a proof's P2 scratch: a', b', a'_j y^(1+j) (len each), g y^(-+n) and h (mn each), the warps'
// partial sums of c_L and c_R (2 a warp).
__host__ __device__ __forceinline__ long p2_words(long mn, long r, long threads) {
    return 8 * (3 * (mn >> r) + 2 * mn + 2 * (threads / 32));
}

// r = c ? a : b word by word: a select of two register arrays that keeps both out of local memory.
__device__ __forceinline__ void select8(u32 *r, bool c, const u32 *a, const u32 *b) {
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = c ? a[k] : b[k];
}

// The sum of every lane's x over the warp, in every lane: five levels of shuffles.
__device__ __forceinline__ void warp_sum_l(u32 *x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        u32 o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = __shfl_xor_sync(0xffffffffu, x[k], off);
        sc_add_l(x, o, x);
    }
}

// A value's 16 int64 limbs as eight 16-byte accesses, half the memory instructions of load_limbs and
// store_limbs (P2's tensors are 16-byte aligned: the wrapper checks).
__device__ __forceinline__ void load_limbs16(const int64_t *p, u32 *w) {
    const longlong2 *q = reinterpret_cast<const longlong2 *>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const longlong2 v = q[k];
        w[k] = (u32)v.x | ((u32)v.y << 16);
    }
}

__device__ __forceinline__ void store_limbs16(int64_t *p, const u32 *w) {
    longlong2 *q = reinterpret_cast<longlong2 *>(p);
#pragma unroll
    for (int k = 0; k < 8; ++k) q[k] = make_longlong2((long long)(w[k] & 0xffffu), (long long)(w[k] >> 16));
}

// One copy of the product mod l for all of P2's call sites, called by value: inline, its dozen products were some
// 100 KB of straight-line code that every SM fetched once a launch, and the fetch, not the products, set the pace.
struct sc8 {
    u32 w[8];
};

__device__ __noinline__ sc8 sc_mul_v(sc8 a, sc8 b) {
    sc8 r;
    sc_mul_l(a.w, b.w, r.w);
    return r;
}

__device__ __forceinline__ void sc_mul_n(const u32 *a, const u32 *b, u32 *r) {
    sc8 x, y;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        x.w[k] = a[k];
        y.w[k] = b[k];
    }
    const sc8 z = sc_mul_v(x, y);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = z.w[k];
}

template <bool SHARED>
__device__ __forceinline__ void prove_round_body(
    const int64_t *__restrict__ a_in, const int64_t *__restrict__ b_in, const int64_t *__restrict__ g_in,
    const int64_t *__restrict__ h_in, const int64_t *__restrict__ alpha_in, const int64_t *__restrict__ e_in,
    const int64_t *__restrict__ ei_in, const int64_t *__restrict__ dl_prev, const int64_t *__restrict__ dr_prev,
    const int64_t *__restrict__ y_pows, const int64_t *__restrict__ yinv_n, const int64_t *__restrict__ dl,
    const int64_t *__restrict__ dr, int mn, int rounds, int r, int deg, int64_t *__restrict__ a_out,
    int64_t *__restrict__ b_out, int64_t *__restrict__ g_out, int64_t *__restrict__ h_out,
    int64_t *__restrict__ alpha_out, int64_t *__restrict__ scalars, u32 *buf) {
    const long b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x, TL = T - 32;
    const int hb = rounds - 1 - r, n = 1 << hb, len = 2 * n, half = mn >> 1, group = mn + deg + 1, width = 2 * group;
    const bool fold = e_in != nullptr;
    u32 *sa = buf, *sb = sa + 8 * len, *say = sb + 8 * len, *sg = say + 8 * len, *sh = sg + 8 * mn;
    u32 *parts = sh + 8 * mn;
    u32 e[8], ei[8], u[8], v[8];
    if (fold) {
        load_limbs16(e_in + 16 * b, e);
        load_limbs16(ei_in + 16 * b, ei);
    }
    // P2 phase: start
    if (t >= TL) {  // the last warp: alpha += dL e^2 + dR e^-2, the Pedersen lanes' masks
        for (int k = t - TL; k < deg; k += 32) {
            load_limbs16(at(alpha_in, b, deg, k), u);
            if (fold) {
                u32 w[8];
                sc_mul_n(e, e, w);
                load_limbs16(at(dl_prev, b, deg, k), v);
                sc_mul_n(v, w, v);
                sc_add_l(u, v, u);
                sc_mul_n(ei, ei, w);
                load_limbs16(at(dr_prev, b, deg, k), v);
                sc_mul_n(v, w, v);
                sc_add_l(u, v, u);
            }
            store_limbs16(at(alpha_out, b, deg, k), u);
            load_limbs16(at(dl, b, deg, k), u);
            store_limbs16(at(scalars, b, width, mn + k), u);
            load_limbs16(at(dr, b, deg, k), u);
            store_limbs16(at(scalars, b, width, group + mn + k), u);
        }
    } else {
        for (int q = t; q < 2 * mn; q += TL) {  // lane q's g, then mn + q's h: the coefficient folds
            const bool is_g = q < mn;
            const int i = is_g ? q : q - mn;
            const bool hi_prev = (i >> (hb + 1)) & 1, hi = (i >> hb) & 1;  // round r - 1's half, round r's
            if (fold) {
                load_limbs16(at(is_g ? g_in : h_in, b, mn, i), u);
                if (is_g) {
                    if (hi_prev) {  // e y^-len
                        load_limbs16(at(yinv_n, b, rounds, r - 1), v);
                        sc_mul_n(e, v, v);
                    } else {
                        copy8(v, ei);
                    }
                } else {
                    select8(v, hi_prev, ei, e);
                }
                sc_mul_n(u, v, u);
            } else {
                set_small(u, 1u);
            }
            store_limbs16(at(is_g ? g_out : h_out, b, mn, i), u);
            if (is_g) {  // g y^-n on a hi lane (L), g y^n on a lo lane (R)
                if (hi) load_limbs16(at(yinv_n, b, rounds, r), v);
                else load_limbs16(at(y_pows, b, mn + 1, n - 1), v);
                sc_mul_n(u, v, u);
            }
            copy8((is_g ? sg : sh) + 8 * i, u);
        }
        // fold item j < len: a'_j = a_j e + a_(j+len) e^-1 y^len and a'_j y^(1+j);
        // item len + j: b'_j = b_j e^-1 + b_(j+len) e
        for (int j = TL - 1 - t; j < 2 * len; j += TL) {
            const bool is_a = j < len;
            const int p = is_a ? j : j - len;
            const int64_t *src = is_a ? a_in : b_in;
            load_limbs16(at(src, b, fold ? 2 * len : len, p), u);
            if (fold) {
                u32 w[8];
                if (is_a) {
                    load_limbs16(at(y_pows, b, mn + 1, len - 1), w);  // y^len
                    sc_mul_n(ei, w, w);
                } else {
                    copy8(w, e);
                }
                load_limbs16(at(src, b, 2 * len, p + len), v);
                sc_mul_n(v, w, v);
                select8(w, is_a, e, ei);
                sc_mul_n(u, w, u);
                sc_add_l(u, v, u);
            }
            store_limbs16(at(is_a ? a_out : b_out, b, len, p), u);
            copy8((is_a ? sa : sb) + 8 * p, u);
            if (is_a) {
                load_limbs16(at(y_pows, b, mn + 1, p), v);  // y^(1 + p)
                sc_mul_n(u, v, u);
                copy8(say + 8 * p, u);
            }
        }
    }
    // P2 phase: fold
    __syncthreads();
    // P2 phase: barrier
    u32 cl[8], cr[8];
    set_small(cl, 0u);
    set_small(cr, 0u);
    if (t < TL) {
        for (int q = t; q < 2 * mn; q += TL) {  // each lane's L/R scalars, in the order of the JAX program's `perm`
            const bool is_g = q < mn;
            const int i = is_g ? q : q - mn, p = i & (n - 1);
            const bool hi = (i >> hb) & 1;
            const int k = ((i >> (hb + 1)) << hb) | p;  // lane i's rank among the lanes of its kind
            const int at_p = hi ? p : p + n;
            copy8(u, (is_g ? sg : sh) + 8 * i);
            copy8(v, (is_g ? sa : sb) + 8 * at_p);
            sc_mul_n(u, v, u);
            store_limbs16(at(scalars, b, width, is_g ? (hi ? k : group + k) : (hi ? group + half + k : half + k)), u);
        }
        // c_L = sum_j a'_j y^(1+j) b'_(j+n), c_R = sum_j a'_(n+j) y^(n+1+j) b'_j, j < n
        for (int j = t; j < n; j += TL) {
            copy8(u, say + 8 * j);
            copy8(v, sb + 8 * (j + n));
            sc_mul_n(u, v, u);
            sc_add_l(cl, u, cl);
        }
        for (int j = t < TL / 2 ? t + TL - TL / 2 : t - TL / 2; j < n; j += TL) {
            copy8(u, say + 8 * (n + j));
            copy8(v, sb + 8 * j);
            sc_mul_n(u, v, u);
            sc_add_l(cr, u, cr);
        }
    }
    // P2 phase: lanes
    warp_sum_l(cl);
    warp_sum_l(cr);
    const int warp = t >> 5, warps = T >> 5;
    if ((t & 31) == 0) {
        copy8(parts + 8 * warp, cl);
        copy8(parts + 8 * (warps + warp), cr);
    }
    __syncthreads();
    // P2 phase: c_sums
    if (t == 0 || t == 32) {  // c_L in warp 0, c_R in warp 1
        const u32 *from = parts + (t ? 8 * warps : 0);
        copy8(u, from);
        for (int w = 1; w < warps; ++w) sc_add_l(u, from + 8 * w, u);
        store_limbs16(at(scalars, b, width, (t ? group : 0) + mn + deg), u);
    }
    // P2 phase: store
}

__global__ void __launch_bounds__(P2_MAX_THREADS) prove_round_kernel(
    const int64_t *__restrict__ a_in, const int64_t *__restrict__ b_in, const int64_t *__restrict__ g_in,
    const int64_t *__restrict__ h_in, const int64_t *__restrict__ alpha_in, const int64_t *__restrict__ e_in,
    const int64_t *__restrict__ ei_in, const int64_t *__restrict__ dl_prev, const int64_t *__restrict__ dr_prev,
    const int64_t *__restrict__ y_pows, const int64_t *__restrict__ yinv_n, const int64_t *__restrict__ dl,
    const int64_t *__restrict__ dr, int mn, int rounds, int r, int deg, int64_t *__restrict__ a_out,
    int64_t *__restrict__ b_out, int64_t *__restrict__ g_out, int64_t *__restrict__ h_out,
    int64_t *__restrict__ alpha_out, int64_t *__restrict__ scalars) {
    extern __shared__ __align__(16) u32 p2_smem[];
    prove_round_body<true>(a_in, b_in, g_in, h_in, alpha_in, e_in, ei_in, dl_prev, dr_prev, y_pows, yinv_n, dl, dr,
                           mn, rounds, r, deg, a_out, b_out, g_out, h_out, alpha_out, scalars, p2_smem);
}

// The same where a proof's scratch exceeds a block's shared memory: `scratch` (B x p2_words) in device memory.
__global__ void __launch_bounds__(P2_MAX_THREADS) prove_round_global_kernel(
    const int64_t *__restrict__ a_in, const int64_t *__restrict__ b_in, const int64_t *__restrict__ g_in,
    const int64_t *__restrict__ h_in, const int64_t *__restrict__ alpha_in, const int64_t *__restrict__ e_in,
    const int64_t *__restrict__ ei_in, const int64_t *__restrict__ dl_prev, const int64_t *__restrict__ dr_prev,
    const int64_t *__restrict__ y_pows, const int64_t *__restrict__ yinv_n, const int64_t *__restrict__ dl,
    const int64_t *__restrict__ dr, int mn, int rounds, int r, int deg, int64_t *__restrict__ a_out,
    int64_t *__restrict__ b_out, int64_t *__restrict__ g_out, int64_t *__restrict__ h_out,
    int64_t *__restrict__ alpha_out, int64_t *__restrict__ scalars, u32 *__restrict__ scratch) {
    prove_round_body<false>(a_in, b_in, g_in, h_in, alpha_in, e_in, ei_in, dl_prev, dr_prev, y_pows, yinv_n, dl, dr,
                            mn, rounds, r, deg, a_out, b_out, g_out, h_out, alpha_out, scalars,
                            scratch + (size_t)blockIdx.x * p2_words(mn, r, blockDim.x));
}

// P3, first entry.  The last round's fold (none where rounds = 0), then ry_ar = r y b0 + s y a0, rys = r y s,
// and the final MSMs' scalars.  a_in, b_in: (B, 2, 16) with a fold, else (B, 1, 16); g_in, h_in: (B, mn, 16) with
// a fold, else unused; r_s, s_s: (B, 16); d_mask, eta: (B, deg, 16).  Out: a1 (B, 2 mn + deg + 1, 16) = [g_i r,
// h_i s interleaved, d_mask, ry_ar]; brow (B, deg + 1, 16) = [eta, rys]; a0, b0 (B, 16); alpha (B, deg, 16).
//
// A block a proof of T threads, as P2's (ops/cuda_prover.round_threads): TL = T - 32 lane threads and one closing
// warp; no barrier.  Lane item q < mn (thread q) takes g_q (hi ? e y^-1 : e^-1) r, item mn + q h_q (hi ? e^-1 :
// e) s, hi being bit 0 of q: at most three products (e y^-1 first on a hi g lane).  The closing warp runs its
// items in three steps, each lane's items side by side, the values passed on through shared memory after a
// __syncwarp: first two products an item, a_0 e, a_1 (e^-1 y), b_0 e^-1, b_1 e, r y, s y and each alpha mask's
// d_L e^2 and d_R e^-2; then a0 and b0 as sums, one product for each of r y b0, s y a0 and r y s, and alpha's
// sums; then ry_ar.  Its chain is three products, as a hi g lane's.  Every product is one call of one copy
// (`sc_mul_n`), every value moves as 16-byte accesses; the `// P3 phase:` comments mark the phases that
// scripts/profile_torch_p2.py --kernel final stamps.
#define P3_ITEMS 6  // the closing warp's first items before alpha's: a_0 e, a_1 e^-1 y, b_0 e^-1, b_1 e, r y, s y
#define P3_SLOTS (P3_ITEMS + 2 * 64 + 2)  // and two a mask (deg <= 64), then r y b0 and s y a0

__global__ void __launch_bounds__(P2_MAX_THREADS) prove_final_kernel(
    const int64_t *__restrict__ a_in, const int64_t *__restrict__ b_in, const int64_t *__restrict__ g_in,
    const int64_t *__restrict__ h_in, const int64_t *__restrict__ alpha_in, const int64_t *__restrict__ e_in,
    const int64_t *__restrict__ ei_in, const int64_t *__restrict__ dl_prev, const int64_t *__restrict__ dr_prev,
    const int64_t *__restrict__ y_pows, const int64_t *__restrict__ yinv_n, const int64_t *__restrict__ r_in,
    const int64_t *__restrict__ s_in, const int64_t *__restrict__ dmask_in, const int64_t *__restrict__ eta_in,
    int mn, int rounds, int deg, int64_t *__restrict__ a1_out, int64_t *__restrict__ brow_out,
    int64_t *__restrict__ a0_out, int64_t *__restrict__ b0_out, int64_t *__restrict__ alpha_out) {
    __shared__ __align__(16) u32 slot[8 * P3_SLOTS];
    const long b = blockIdx.x;
    const int t = threadIdx.x, TL = blockDim.x - 32, width = 2 * mn + deg + 1;
    const bool fold = e_in != nullptr;
    u32 e[8], ei[8], u[8], v[8], w[8];
    if (fold) {
        load_limbs16(e_in + 16 * b, e);
        load_limbs16(ei_in + 16 * b, ei);
    } else {
        set_small(e, 1u);
        set_small(ei, 1u);
    }
    // P3 phase: start
    if (t < TL) {
        for (int q = t; q < 2 * mn; q += TL) {  // g_i r at 2i, h_i s at 2i + 1
            const bool is_g = q < mn;
            const int i = is_g ? q : q - mn;
            const bool hi = i & 1;
            if (fold) {
                load_limbs16(at(is_g ? g_in : h_in, b, mn, i), u);
                if (is_g && hi) {  // e y^-1
                    load_limbs16(at(yinv_n, b, rounds, rounds - 1), v);
                    sc_mul_n(e, v, v);
                } else {
                    select8(v, is_g == hi, e, ei);  // g lo: e^-1; h hi: e^-1, lo: e
                }
                sc_mul_n(u, v, u);
            } else {
                set_small(u, 1u);
            }
            load_limbs16((is_g ? r_in : s_in) + 16 * b, v);
            sc_mul_n(u, v, u);
            store_limbs16(at(a1_out, b, width, 2 * i + (is_g ? 0 : 1)), u);
        }
    } else {  // the closing warp, step 1: x y z an item
        for (int j = t - TL; j < P3_ITEMS + 2 * deg; j += 32) {
            set_small(w, 1u);
            if (j < 4) {  // the fold of position 0: a_0 e, a_1 e^-1 y, b_0 e^-1, b_1 e (copies of a_0, b_0 without)
                const int64_t *src = j < 2 ? a_in : b_in;
                load_limbs16(at(src, b, fold ? 2 : 1, fold ? (j & 1) : 0), u);
                select8(v, j == 0 || j == 3, e, ei);
                if (j == 1 && fold) load_limbs16(at(y_pows, b, mn + 1, 0), w);
            } else if (j < P3_ITEMS) {  // r y, s y
                load_limbs16((j == 4 ? r_in : s_in) + 16 * b, u);
                load_limbs16(at(y_pows, b, mn + 1, 0), v);
            } else {  // alpha's mask k: d_L e^2 or d_R e^-2
                const int k = (j - P3_ITEMS) >> 1;
                const bool left = ((j - P3_ITEMS) & 1) == 0;
                select8(u, left, e, ei);
                copy8(v, u);
                if (fold) load_limbs16(at(left ? dl_prev : dr_prev, b, deg, k), w);
            }
            sc_mul_n(u, v, u);
            sc_mul_n(u, w, u);
            copy8(slot + 8 * j, u);
        }
    }
    __syncwarp();
    // P3 phase: products
    if (t >= TL) {  // step 2: a0, b0, r y b0, s y a0, r y s; alpha and the copied masks
        const int l = t - TL;
        for (int j = l; j < 5 + deg; j += 32) {
            if (j < 4) {  // a0 (items 0 and 3), b0 (1 and 2)
                const bool is_a = j == 0 || j == 3;
                if (fold) {
                    sc_add_l(slot + (is_a ? 0 : 16), slot + (is_a ? 8 : 24), u);
                } else {
                    load_limbs16(is_a ? a_in + 16 * b : b_in + 16 * b, u);
                }
                if (j < 2) store_limbs16((is_a ? a0_out : b0_out) + 16 * b, u);
            }
            if (j >= 2 && j < 5) {  // r y b0, s y a0, r y s
                if (j == 4) load_limbs16(s_in + 16 * b, u);
                copy8(v, slot + 8 * (j == 3 ? 5 : 4));
                sc_mul_n(u, v, u);
                if (j < 4) copy8(slot + 8 * (P3_ITEMS + 2 * deg + j - 2), u);
                else store_limbs16(at(brow_out, b, deg + 1, deg), u);
            }
            if (j >= 5) {  // alpha += d_L e^2 + d_R e^-2; d_mask and eta copied
                const int k = j - 5;
                load_limbs16(at(alpha_in, b, deg, k), u);
                if (fold) {
                    sc_add_l(u, slot + 8 * (P3_ITEMS + 2 * k), u);
                    sc_add_l(u, slot + 8 * (P3_ITEMS + 2 * k + 1), u);
                }
                store_limbs16(at(alpha_out, b, deg, k), u);
                load_limbs16(at(dmask_in, b, deg, k), u);
                store_limbs16(at(a1_out, b, width, 2 * mn + k), u);
                load_limbs16(at(eta_in, b, deg, k), u);
                store_limbs16(at(brow_out, b, deg + 1, k), u);
            }
        }
    }
    __syncwarp();
    // P3 phase: close
    if (t == TL) {  // ry_ar = r y b0 + s y a0
        sc_add_l(slot + 8 * (P3_ITEMS + 2 * deg), slot + 8 * (P3_ITEMS + 2 * deg + 1), u);
        store_limbs16(at(a1_out, b, width, 2 * mn + deg), u);
    }
    // P3 phase: store
}

// P3, second entry, a thread an output (2 + deg a proof, in blocks of one warp so that a prove's few outputs
// reach many SMs): r1 = r + a0 e, s1 = s + b0 e, d1_k = eta_k + (d_mask_k + alpha_k e) e, one or two products.
__global__ void __launch_bounds__(PR_RESP_THREADS) prove_responses_kernel(
    const int64_t *__restrict__ r_in, const int64_t *__restrict__ s_in, const int64_t *__restrict__ a0_in,
    const int64_t *__restrict__ b0_in, const int64_t *__restrict__ eta_in, const int64_t *__restrict__ dmask_in,
    const int64_t *__restrict__ alpha_in, const int64_t *__restrict__ e_in, long batch, int deg,
    int64_t *__restrict__ r1_out, int64_t *__restrict__ s1_out, int64_t *__restrict__ d1_out) {
    const long g = (long)blockIdx.x * blockDim.x + threadIdx.x, b = g / (2 + deg);
    const int j = (int)(g % (2 + deg));
    if (b >= batch) return;
    u32 e[8], u[8], v[8];
    load_limbs16(e_in + 16 * b, e);
    if (j < 2) {
        load_limbs16((j ? b0_in : a0_in) + 16 * b, u);
    } else {
        load_limbs16(at(alpha_in, b, deg, j - 2), u);
        sc_mul_n(u, e, u);
        load_limbs16(at(dmask_in, b, deg, j - 2), v);
        sc_add_l(v, u, u);
    }
    sc_mul_n(u, e, u);
    load_limbs16(j < 2 ? (j ? s_in : r_in) + 16 * b : at(eta_in, b, deg, j - 2), v);
    sc_add_l(v, u, u);
    store_limbs16(j < 2 ? (j ? s1_out : r1_out) + 16 * b : at(d1_out, b, deg, j - 2), u);
}

// P4, a block a proof on four-lane adders.  table: (64, 16, s_tab, 24) words, lanes 2i (g_i) and 2i + 1 (h_i)
// for i < mn; bits: (B, mn); start: coordinate c, limb k of proof b at start_c[b * row_stride + k * limb_stride]
// (K6's output, read in place); out: (4, B, 16), coordinate-major rows.
__global__ void __launch_bounds__(FOLD_MAX_THREADS, 1) bit_sum_kernel(
    const u32 *__restrict__ table, long s_tab, const int64_t *__restrict__ bits, const int64_t *__restrict__ sx,
    const int64_t *__restrict__ sy, const int64_t *__restrict__ sz, const int64_t *__restrict__ st,
    long row_stride, long limb_stride, long batch, int mn, int64_t *__restrict__ out) {
    __shared__ __align__(16) u32 sh[FOLD_SMEM_WORDS];
    const long b = blockIdx.x;
    const int c = threadIdx.x & 3;
    const int64_t *start = c == 0 ? sx : c == 1 ? sy : c == 2 ? sz : st;
    const u32 *digit1 = table + s_tab * PR_ENTRY_WORDS;  // window 0, digit 1: the point itself
    const fe acc = ge4_block_sum(
        [&](int i) {
            if (i == 0) return fe_load(start + b * row_stride, limb_stride);
            const int lane = i - 1;
            const bool bit = bits[b * mn + lane] != 0;
            const long at_lane = (long)(2 * lane + (bit ? 0 : 1)) * PR_ENTRY_WORDS;  // g_i, or h_i
            const uint4 *entry = reinterpret_cast<const uint4 *>(digit1 + at_lane);
            const fe w0 = fe_load_words(entry), w1 = fe_load_words(entry + 2);
            const fe yp = bit ? w0 : w1, ym = bit ? w1 : w0;  // -h: y - x and y + x swap
            const fe e = fe_sub(yp, ym), h = fe_add(yp, ym);
            if (c == 0) return fe_add(e, e);
            if (c == 1) return fe_add(h, h);
            if (c == 2) {
                fe four = fe_zero();
                four.w[0] = 4u;
                return four;
            }
            return fe_mul(e, h);
        },
        mn + 1, sh);
    if (threadIdx.x < 4) fe_store(out + (c * batch + b) * 16, 1, acc);
}

extern "C" const char *bppt_prover_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static bool pow2(long v) { return v > 0 && (v & (v - 1)) == 0; }

static bool shape_ok(long batch, long mn, long rounds, long deg, long threads) {
    return batch >= 1 && batch < (1L << 24) && rounds >= 0 && rounds <= 30 && mn == (1L << rounds) && deg >= 1 &&
           deg <= 64 && pow2(threads) && threads >= 32 && threads <= PR_MAX_THREADS;
}

// Every tensor int64 limbs, contiguous, on the current device.
extern "C" int bppt_prove_prep(const void *y, const void *z, const void *y_inv, const void *bits, const void *r_blind,
                               const void *alpha0, long batch, long m, long n, long deg, long threads, void *a,
                               void *b, void *y_pows, void *y_inv_n, void *alpha, void *stream) {
    const long mn = m * n;
    const long rounds = mn > 0 ? 63 - __builtin_clzl((unsigned long)mn) : -1;
    if (!pow2(m) || !pow2(n) || m > PR_MAX_M || !shape_ok(batch, mn, rounds, deg, threads))
        return (int)cudaErrorInvalidValue;
    prove_prep_kernel<<<(unsigned)batch, (unsigned)threads, (size_t)(32 * m), (cudaStream_t)stream>>>(
        (const int64_t *)y, (const int64_t *)z, (const int64_t *)y_inv, (const int64_t *)bits,
        (const int64_t *)r_blind, (const int64_t *)alpha0, (int)m, (int)n, (int)deg, (int)rounds, (int64_t *)a,
        (int64_t *)b, (int64_t *)y_pows, (int64_t *)y_inv_n, (int64_t *)alpha);
    return (int)cudaGetLastError();
}

// e, e_inv, dl_prev, dr_prev, g, h: null in round 0 (no fold).  threads: a multiple of 32 from 64 to 544.  scratch:
// null where a proof's p2_words fit in a block's shared memory, else B x p2_words 32-bit words.
extern "C" int bppt_prove_round(const void *a, const void *b, const void *g, const void *h, const void *alpha,
                                const void *e, const void *e_inv, const void *dl_prev, const void *dr_prev,
                                const void *y_pows, const void *y_inv_n, const void *dl, const void *dr, long batch,
                                long mn, long rounds, long r, long deg, long threads, void *a_out, void *b_out,
                                void *g_out, void *h_out, void *alpha_out, void *scalars, void *scratch, void *stream) {
    if (!shape_ok(batch, mn, rounds, deg, 32) || r < 0 || r >= rounds || (r > 0) != (e != nullptr) ||
        threads < 64 || threads > P2_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const long smem = p2_words(mn, r, threads) * (long)sizeof(u32);
    const bool shared = smem <= P2_MAX_SMEM;
    if (shared == (scratch != nullptr)) return (int)cudaErrorInvalidValue;
    if (shared && smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(prove_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (shared) {
        prove_round_kernel<<<(unsigned)batch, (unsigned)threads, (size_t)smem, st>>>(
            (const int64_t *)a, (const int64_t *)b, (const int64_t *)g, (const int64_t *)h, (const int64_t *)alpha,
            (const int64_t *)e, (const int64_t *)e_inv, (const int64_t *)dl_prev, (const int64_t *)dr_prev,
            (const int64_t *)y_pows, (const int64_t *)y_inv_n, (const int64_t *)dl, (const int64_t *)dr, (int)mn,
            (int)rounds, (int)r, (int)deg, (int64_t *)a_out, (int64_t *)b_out, (int64_t *)g_out, (int64_t *)h_out,
            (int64_t *)alpha_out, (int64_t *)scalars);
    } else {
        prove_round_global_kernel<<<(unsigned)batch, (unsigned)threads, 0, st>>>(
            (const int64_t *)a, (const int64_t *)b, (const int64_t *)g, (const int64_t *)h, (const int64_t *)alpha,
            (const int64_t *)e, (const int64_t *)e_inv, (const int64_t *)dl_prev, (const int64_t *)dr_prev,
            (const int64_t *)y_pows, (const int64_t *)y_inv_n, (const int64_t *)dl, (const int64_t *)dr, (int)mn,
            (int)rounds, (int)r, (int)deg, (int64_t *)a_out, (int64_t *)b_out, (int64_t *)g_out, (int64_t *)h_out,
            (int64_t *)alpha_out, (int64_t *)scalars, (u32 *)scratch);
    }
    return (int)cudaGetLastError();
}

// e, e_inv, dl_prev, dr_prev, g, h: null where rounds = 0 (no fold).  threads: P2's, a multiple of 32 from 64 to
// 544.  Every tensor 16-byte aligned (the wrapper checks).
extern "C" int bppt_prove_final(const void *a, const void *b, const void *g, const void *h, const void *alpha,
                                const void *e, const void *e_inv, const void *dl_prev, const void *dr_prev,
                                const void *y_pows, const void *y_inv_n, const void *r_s, const void *s_s,
                                const void *d_mask, const void *eta, long batch, long mn, long rounds, long deg,
                                long threads, void *a1, void *brow, void *a0, void *b0, void *alpha_out,
                                void *stream) {
    if (!shape_ok(batch, mn, rounds, deg, 32) || (rounds > 0) != (e != nullptr) || threads < 64 ||
        threads > P2_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    prove_final_kernel<<<(unsigned)batch, (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const int64_t *)a, (const int64_t *)b, (const int64_t *)g, (const int64_t *)h, (const int64_t *)alpha,
        (const int64_t *)e, (const int64_t *)e_inv, (const int64_t *)dl_prev, (const int64_t *)dr_prev,
        (const int64_t *)y_pows, (const int64_t *)y_inv_n, (const int64_t *)r_s, (const int64_t *)s_s,
        (const int64_t *)d_mask, (const int64_t *)eta, (int)mn, (int)rounds, (int)deg, (int64_t *)a1,
        (int64_t *)brow, (int64_t *)a0, (int64_t *)b0, (int64_t *)alpha_out);
    return (int)cudaGetLastError();
}

extern "C" int bppt_prove_responses(const void *r_s, const void *s_s, const void *a0, const void *b0, const void *eta,
                                    const void *d_mask, const void *alpha, const void *e, long batch, long deg,
                                    void *r1, void *s1, void *d1, void *stream) {
    if (batch < 1 || batch >= (1L << 24) || deg < 1 || deg > 64) return (int)cudaErrorInvalidValue;
    prove_responses_kernel<<<(unsigned)((batch * (2 + deg) + PR_RESP_THREADS - 1) / PR_RESP_THREADS), PR_RESP_THREADS, 0,
                             (cudaStream_t)stream>>>(
        (const int64_t *)r_s, (const int64_t *)s_s, (const int64_t *)a0, (const int64_t *)b0, (const int64_t *)eta,
        (const int64_t *)d_mask, (const int64_t *)alpha, (const int64_t *)e, batch, (int)deg, (int64_t *)r1,
        (int64_t *)s1, (int64_t *)d1);
    return (int)cudaGetLastError();
}

// table: int32 words (64, 16, s_tab, 24) with s_tab >= 2 mn; bits: int64 (B, mn); x, y, z, t: the start
// points' coordinates, int64 limbs with the strides given; out: int64 (4, B, 16).  threads: a power of two
// from 32 to 512 (fold4.cuh's tree).
extern "C" int bppt_bit_sum(const void *table, long s_tab, const void *bits, const void *x, const void *y,
                            const void *z, const void *t, long row_stride, long limb_stride, long batch, long mn,
                            long threads, void *out, void *stream) {
    if (batch < 1 || batch >= (1L << 24) || !pow2(mn) || s_tab < 2 * mn || threads < 32 ||
        threads > FOLD_MAX_THREADS || !pow2(threads))
        return (int)cudaErrorInvalidValue;
    bit_sum_kernel<<<(unsigned)batch, (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const u32 *)table, s_tab, (const int64_t *)bits, (const int64_t *)x, (const int64_t *)y,
        (const int64_t *)z, (const int64_t *)t, row_stride, limb_stride, batch, (int)mn, (int64_t *)out);
    return (int)cudaGetLastError();
}
