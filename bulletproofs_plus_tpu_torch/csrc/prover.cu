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
// point, and -h swaps its first two words and negates the third; each point
// enters the sum by a four-lane mixed addition on that entry, and the block
// sums its adders on four-lane additions, starting from alpha's point, so
// that A goes straight to the encoder C1.
//
// What bounds them on this card: latency and the launch.  A 128-proof,
// mn = 64 prove needs some 0.45 M products mod l in all, under 0.01 ms at the
// multiply rate, spread over 1 + rounds + 2 launches; each thread runs a few
// dependent products, and P4 a chain of four-lane additions.  Every kernel is
// designed for that latency: more threads a proof, so that no thread runs more
// than a few products (P1's powers of y by a ladder spread over the block),
// values handed on through shared memory, few barriers, one copy of the
// product mod l (`sc_mul_n`; P4 keeps its field products inline, which
// measured faster) and 16-byte accesses; P3's second entry a thread an
// output.

#include "field25519.cuh"
#include "scalar_l.cuh"

#define P1_MAX_THREADS 512  // P1: a block a proof, its ladder threads and the alpha warp
#define PR_RESP_THREADS 32  // P3's second entry: a thread an output, a warp a block
#define PR_ENTRY_WORDS 24   // a fixed table entry: y + x, y - x, 2d x y, 8 words each
#define PR_MAX_M 1024       // P1's commitments a proof at most (the C entry's check)
#define PR_MAX_SMEM 232448  // shared memory a block may use: 227 KB

// l - 1, the a_R entry of a zero bit
__device__ __forceinline__ void set_l_minus_1(u32 *r) {
    r[0] = 0x5cf5d3ecu; r[1] = 0x5812631au; r[2] = 0xa2f79cd6u; r[3] = 0x14def9deu;
    r[4] = 0u; r[5] = 0u; r[6] = 0u; r[7] = 0x10000000u;
}

// Element j of proof b in a (B, X, 16) limb tensor.
__device__ __forceinline__ const int64_t *at(const int64_t *p, long b, long x, long j) { return p + 16 * (b * x + j); }
__device__ __forceinline__ int64_t *at(int64_t *p, long b, long x, long j) { return p + 16 * (b * x + j); }

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
// store_limbs (P1-P3's tensors are 16-byte aligned: the wrappers check).
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

// An 8-word slot of a block's scratch (shared memory, or device memory past a block's) as two 16-byte accesses.
__device__ __forceinline__ void ld_slot(const u32 *s, u32 *w) {
    const uint4 lo = reinterpret_cast<const uint4 *>(s)[0], hi = reinterpret_cast<const uint4 *>(s)[1];
    w[0] = lo.x; w[1] = lo.y; w[2] = lo.z; w[3] = lo.w;
    w[4] = hi.x; w[5] = hi.y; w[6] = hi.z; w[7] = hi.w;
}

__device__ __forceinline__ void st_slot(u32 *s, const u32 *w) {
    reinterpret_cast<uint4 *>(s)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4 *>(s)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One copy of the product mod l for all of P1-P3's call sites, called by value: inline, P2's dozen products were
// some 100 KB of straight-line code that every SM fetched once a launch, and the fetch, not the products, set the
// pace.
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

// P1.  y, z, y_inv: (B, 16); bits: (B, mn) in {0, 1}; r_blind: (B, m, deg, 16); alpha0: (B, deg, 16).
// Out: a, b (B, mn, 16); y_pows (B, mn + 1, 16), y^1..y^(mn+1); y_inv_n (B, rounds, 16), y^-(mn >> (r + 1));
// alpha (B, deg, 16).
//
// A block a proof of T threads (ops/cuda_prover.prep_threads): TL = T - 32 ladder threads and one warp for
// alpha's z-term.  The ladder threads run `p1_levels` levels, log2(mn) where n >= 2, each closed by a barrier of
// their own (bar.sync 1, which the alpha warp never joins).  A level's items, one product each, are strided over
// them in this order (ops/cuda_prover.prep_levels counts them):
//   y's ladder: at level t, h = 2^(t-1), y^(h+1+j) = y^h y^(1+j) for j < h, up to y^mn, so that after level t
//     every power up to 2^t is in the slots (each thread takes y^k by its own square and multiply no more);
//   y^-n: one squaring a level, y^-1 before level 1 and y^-(2^t) at level t;
//   z: z^2 at level 1, then its ladder over m, z^(2(h+1+j)) = z^(2h) z^(2(1+j)) at level t >= 2, h = 2^(t-2);
//   the lanes' factors d_i = z^(2(j+1)) 2^k (i = jn + k) at level log2(m) + 2, once z's powers are in.
// Meanwhile the alpha warp takes S_k = y sum_j z^(2(j+1)) r_jk, G = min(m, 32) lanes a k and 32 / G values of k
// a pass: lane g its own y z^(2(g+1)) by a ladder over its group's lanes (shuffles), its terms j = g mod G, their
// sum over the group by shuffles.  Then the block's one barrier, and every thread takes its items of the last step,
// one product each: b_i = d_i y^(mn-i) + z (+ l - 1 for a zero bit) and a_i = bit_i - z, y^(mn+1) = y^mn y,
// alpha_k = alpha0_k + S_k y^mn.  Longest chain: log2(mn) + 1 products (7 at mn 64; the alpha warp's 3 at m = 1
// beside it).  The values live in `buf` as 8-word slots (shared memory; a scratch in device memory where a
// proof's do not fit, prove_prep_global_kernel): y^1..y^mn, d_0..d_(mn-1), z^2..z^(2m), S_1..S_deg and the y^-n
// chain.  Every product is one call of one copy (`sc_mul_n`), every value moves as 16-byte accesses; the
// `// P1 phase:` comments mark the phases that scripts/profile_torch_p2.py --kernel prep stamps.

// 8-word values of a proof's P1 scratch: y^1..y^mn, d_0..d_(mn-1), z^2..z^(2m), S_1..S_deg, the y^-n chain.
__host__ __device__ __forceinline__ long p1_words(long mn, long m, long deg) { return 8 * (2 * mn + m + deg + 1); }

// The ladder threads' levels: y's ladder to y^mn, and z's (z^2, then log2(m)) before the lanes' factors.
__host__ __device__ __forceinline__ int p1_levels(int lmn, int lm) { return lmn > lm + 2 ? lmn : lm + 2; }

// bar.sync 1 for the first `count` threads, a multiple of 32: the ladder threads' barrier.
__device__ __forceinline__ void sync_ladder(int count) { asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory"); }

__device__ __forceinline__ void prove_prep_body(
    const int64_t *__restrict__ y_in, const int64_t *__restrict__ z_in, const int64_t *__restrict__ yinv_in,
    const int64_t *__restrict__ bits, const int64_t *__restrict__ r_blind, const int64_t *__restrict__ alpha0,
    int m, int n, int deg, int rounds, int64_t *__restrict__ a_out, int64_t *__restrict__ b_out,
    int64_t *__restrict__ y_pows, int64_t *__restrict__ yinv_out, int64_t *__restrict__ alpha_out, u32 *buf) {
    const long b = blockIdx.x;
    const int t = threadIdx.x, T = blockDim.x, TL = T - 32, mn = m * n;
    const int lm = 31 - __clz(m), ln = 31 - __clz(n);
    u32 *ys = buf, *ds = ys + 8 * mn, *zs = ds + 8 * mn, *sk = zs + 8 * m, *yi = sk + 8 * deg;
    u32 u[8], v[8], w[8], zv[8], first[8];
    // P1 phase: start
    // z, and what this thread's first item of the last step reads from device memory (its bit, or alpha0_k), in
    // flight while the levels run: without the second, P1 read 0.0128-0.0131 ms against 0.0114-0.0116 (128 x
    // mn 64, NVIDIA H100 80GB HBM3, 700.00 W)
    load_limbs16(z_in + 16 * b, zv);
    const u32 first_bit = t < mn ? (u32)bits[b * mn + t] : 0u;
    if (t > mn && t <= mn + deg) load_limbs16(at(alpha0, b, deg, t - mn - 1), first);
    if (t < TL) {
        if (t == 0) {
            load_limbs16(y_in + 16 * b, u);
            st_slot(ys, u);
            store_limbs16(at(y_pows, b, mn + 1, 0), u);
        } else if (t == 1 && rounds > 0) {
            load_limbs16(yinv_in + 16 * b, u);
            st_slot(yi, u);
            store_limbs16(at(yinv_out, b, rounds, rounds - 1), u);
        }
        sync_ladder(TL);
        const int levels = p1_levels(lm + ln, lm);
        for (int lv = 1; lv <= levels; ++lv) {
            const int h = 1 << (lv - 1), hz = h >> 1;
            const int ny = lv <= lm + ln ? h : 0, ni = lv < rounds ? 1 : 0;
            const int nz = lv == 1 ? 1 : lv <= lm + 1 ? hz : 0, nd = lv == lm + 2 ? mn : 0;
            for (int q = t; q < ny + ni + nz + nd; q += TL) {
                u32 *slot;
                int64_t *out = nullptr;
                if (q < ny) {  // y^(h+1+q) = y^h y^(1+q)
                    ld_slot(ys + 8 * (h - 1), u);
                    ld_slot(ys + 8 * q, v);
                    slot = ys + 8 * (h + q);
                    out = at(y_pows, b, mn + 1, h + q);
                } else if (q < ny + ni) {  // y^-(2^lv), round rounds - 1 - lv's
                    ld_slot(yi, u);
                    copy8(v, u);
                    slot = yi;
                    out = at(yinv_out, b, rounds, rounds - 1 - lv);
                } else if (q < ny + ni + nz) {
                    const int j = q - ny - ni;
                    if (lv == 1) {  // z^2
                        copy8(u, zv);
                        copy8(v, zv);
                    } else {  // z^(2(hz+1+j)) = z^(2hz) z^(2(1+j))
                        ld_slot(zs + 8 * (hz - 1), u);
                        ld_slot(zs + 8 * j, v);
                    }
                    slot = zs + 8 * (lv == 1 ? 0 : hz + j);
                } else {  // d_i = z^(2(j+1)) 2^k, i = jn + k: a product by the one-word power of two
                    const int i = q - ny - ni - nz, k = i & (n - 1);
                    ld_slot(zs + 8 * (i >> ln), u);
#pragma unroll
                    for (int s = 0; s < 8; ++s) v[s] = s == (k >> 5) ? 1u << (k & 31) : 0u;
                    slot = ds + 8 * i;
                }
                sc_mul_n(u, v, w);
                st_slot(slot, w);
                if (out) store_limbs16(out, w);
            }
            sync_ladder(TL);
        }
    } else {  // the alpha warp: S_k = y sum_j z^(2(j+1)) r_jk
        const int lane = t - TL, G = m < 32 ? m : 32, lg = 31 - __clz(G), g = lane & (G - 1), base = lane - g;
        u32 zg[8];
        sc_mul_n(zv, zv, v);  // z^2
        for (int h = 1; h < G; h <<= 1) {  // lanes g in [h, 2h): z^(2(g+1)) = z^(2h) z^(2(g-h+1))
#pragma unroll
            for (int s = 0; s < 8; ++s) {
                u[s] = __shfl_sync(0xffffffffu, v[s], base + h - 1);
                w[s] = __shfl_sync(0xffffffffu, v[s], base + ((g - h) & (G - 1)));
            }
            if (g >= h && g < 2 * h) sc_mul_n(u, w, v);
        }
#pragma unroll
        for (int s = 0; s < 8; ++s) zg[s] = __shfl_sync(0xffffffffu, v[s], base + G - 1);  // z^(2G)
        load_limbs16(y_in + 16 * b, u);
        sc_mul_n(v, u, v);  // y z^(2(g+1))
        for (int k0 = 0; k0 < deg; k0 += 32 >> lg) {
            const int k = k0 + (lane >> lg);
            u32 acc[8];
            set_small(acc, 0u);
            copy8(u, v);
            for (int j = g; j < m; j += G) {  // y z^(2(j+1)) r_jk for j = g, g + G, ..: m / G terms in every lane
                if (j > g) sc_mul_n(u, zg, u);
                if (k < deg) {
                    load_limbs16(r_blind + 16 * ((b * m + j) * deg + k), w);
                    sc_mul_n(u, w, w);
                    sc_add_l(acc, w, acc);
                }
            }
            for (int off = G >> 1; off > 0; off >>= 1) {  // the group's sum
#pragma unroll
                for (int s = 0; s < 8; ++s) w[s] = __shfl_xor_sync(0xffffffffu, acc[s], off);
                sc_add_l(acc, w, acc);
            }
            if (g == 0 && k < deg) st_slot(sk + 8 * k, acc);
        }
    }
    // P1 phase: levels
    __syncthreads();
    // P1 phase: barrier
    for (int q = t; q < mn + 1 + deg; q += T) {
        u32 bit = 0u;
        if (q < mn) {  // lane q: d_q y^(mn-q)
            bit = q == t ? first_bit : (u32)bits[b * mn + q];
            ld_slot(ds + 8 * q, u);
            ld_slot(ys + 8 * (mn - 1 - q), v);
        } else if (q == mn) {  // y^(mn+1) = y^mn y
            ld_slot(ys + 8 * (mn - 1), u);
            ld_slot(ys, v);
        } else {  // S_k y^mn
            ld_slot(sk + 8 * (q - mn - 1), u);
            ld_slot(ys + 8 * (mn - 1), v);
        }
        sc_mul_n(u, v, w);
        if (q < mn) {
            sc_add_l(w, zv, w);  // b_q = d_q y^(mn-q) + z (+ l - 1, the a_R entry of a zero bit)
            if (!bit) {
                set_l_minus_1(u);
                sc_add_l(u, w, w);
            }
            store_limbs16(at(b_out, b, mn, q), w);
            set_small(u, bit);
            sc_sub_l(u, zv, u);  // a_q = bit - z
            store_limbs16(at(a_out, b, mn, q), u);
        } else if (q == mn) {
            store_limbs16(at(y_pows, b, mn + 1, mn), w);
        } else {
            if (q == t) {
                copy8(u, first);
            } else {
                load_limbs16(at(alpha0, b, deg, q - mn - 1), u);
            }
            sc_add_l(u, w, w);
            store_limbs16(at(alpha_out, b, deg, q - mn - 1), w);
        }
    }
    // P1 phase: store
}

__global__ void __launch_bounds__(P1_MAX_THREADS) prove_prep_kernel(
    const int64_t *__restrict__ y_in, const int64_t *__restrict__ z_in, const int64_t *__restrict__ yinv_in,
    const int64_t *__restrict__ bits, const int64_t *__restrict__ r_blind, const int64_t *__restrict__ alpha0,
    int m, int n, int deg, int rounds, int64_t *__restrict__ a_out, int64_t *__restrict__ b_out,
    int64_t *__restrict__ y_pows, int64_t *__restrict__ yinv_out, int64_t *__restrict__ alpha_out) {
    extern __shared__ __align__(16) u32 p1_smem[];
    prove_prep_body(y_in, z_in, yinv_in, bits, r_blind, alpha0, m, n, deg, rounds, a_out, b_out, y_pows, yinv_out,
                    alpha_out, p1_smem);
}

// The same where a proof's slots exceed a block's shared memory: `scratch` (B x p1_words) in device memory.
__global__ void __launch_bounds__(P1_MAX_THREADS) prove_prep_global_kernel(
    const int64_t *__restrict__ y_in, const int64_t *__restrict__ z_in, const int64_t *__restrict__ yinv_in,
    const int64_t *__restrict__ bits, const int64_t *__restrict__ r_blind, const int64_t *__restrict__ alpha0,
    int m, int n, int deg, int rounds, int64_t *__restrict__ a_out, int64_t *__restrict__ b_out,
    int64_t *__restrict__ y_pows, int64_t *__restrict__ yinv_out, int64_t *__restrict__ alpha_out, u32 *scratch) {
    prove_prep_body(y_in, z_in, yinv_in, bits, r_blind, alpha0, m, n, deg, rounds, a_out, b_out, y_pows, yinv_out,
                    alpha_out, scratch + (size_t)blockIdx.x * p1_words((long)m * n, m, deg));
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

// 8-word values of a proof's P2 scratch: a', b', a'_j y^(1+j) (len each), g y^(-+n) and h (mn each), the warps'
// partial sums of c_L and c_R (2 a warp).
__host__ __device__ __forceinline__ long p2_words(long mn, long r, long threads) {
    return 8 * (3 * (mn >> r) + 2 * mn + 2 * (threads / 32));
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

// P4, a block a proof of T threads, T / 4 four-lane adders (ops/cuda_prover.bit_sum_threads).  table: (64, 16,
// s_tab, 24) words, lanes 2i (g_i) and 2i + 1 (h_i) for i < mn; bits: (B, mn); start: coordinate c, limb k of
// proof b at start_c[b * row_stride + k * limb_stride] (K6's output, read in place); out: (4, B, 16),
// coordinate-major rows.
//
// Adder a starts from alpha's point (a = 0) or the identity and adds lanes a, a + T / 4, .. by a four-lane mixed
// addition (`p4_madd4`, 2 products deep) on the affine entry the table holds, the next lane's words in flight while
// an addition runs: each lane of a group loads its one operand of g_i and of h_i at once, and the bit only selects
// (-h_i swaps y + x and y - x and negates 2d x y).  Then a tree sums the adders on four-lane additions (`p4_add4`,
// 3 products deep), first across the warps through shared memory, then three levels inside warp 0 by shuffles, as
// fold4.cuh's `ge4_block_sum` does (K2 and K6 keep that one).  Longest chain: 2 mn / (T / 4) products for the
// leaves and 3 a level of the tree, 19 at mn 64 and 128 threads (the design before: 22).  The products are
// inline: one copy of the product called from every site (`sc_mul_n`'s way) measured 0.0109-0.0110 ms at 128 x
// mn 64 against 0.0100 inline (NVIDIA H100 80GB HBM3, 700.00 W; scripts/profile_torch_p2.py --kernel bit_sum
// --source on a copy).  The `// P4 phase:` comments mark the phases that scripts/profile_torch_p2.py --kernel
// bit_sum stamps.
#define P4_MAX_THREADS 512  // 128 adders: 128 registers a thread at most

// The tail that both of P4's additions share, field25519.cuh's ge_add4 from its exchange 3: lanes 0-3 of a group
// hold A, B, D and C; E = B - A, H = B + A, F = D - C, G = D + C, then (EF, GH, FG, EH) back in (X, Y, Z, T) order.
__device__ __forceinline__ fe p4_tail(const fe &m) {
    const int lane = threadIdx.x & 31, c = lane & 3, base = lane & 28;
    const bool odd = (c & 1) != 0;
    const fe partner = fe_from_lane(m, lane ^ 1);
    const bool holds_hi = c == 1 || c == 2;  // B and D are the minuends
    const fe hi = fe_select(holds_hi, m, partner), lo = fe_select(holds_hi, partner, m);
    const fe d = fe_sub(hi, lo), s = fe_add(hi, lo);
    // lane 1 takes F from lane 3, lane 3 takes H from lane 1
    const fe far = fe_from_lane(fe_select(c < 2, s, d), lane ^ 2);
    // lane 0 T3 = E H, lane 1 X3 = E F, lane 2 Z3 = F G, lane 3 Y3 = G H
    const fe r = fe_mul(fe_select(c == 3, s, d), fe_select(odd, far, s));
    return fe_from_lane(r, base + (c == 0 ? 1 : c == 1 ? 3 : c == 2 ? 2 : 0));
}

// madd-2008-hwcd-3 for a = -1 over four lanes: p this lane's coordinate of the sum so far, w its operand of the
// affine point: lane 0 y - x, lane 1 y + x, lane 2 one, lane 3 2d x y.  2 products deep.
__device__ __forceinline__ fe p4_madd4(const fe &p, const fe &w) {
    const int lane = threadIdx.x & 31, c = lane & 3;
    // lane 0 takes Y1 from lane 1, lane 1 X1 from lane 0 (lanes 2 and 3 swap Z1 and T1 and ignore it)
    const fe got = fe_from_lane(p, lane ^ 1);
    const fe o = fe_select(c == 2, p, got);
    const fe sum = fe_add(p, o), diff = fe_sub(o, p);  // lane 0 Y1 - X1; lane 1 Y1 + X1, lane 2 D = 2 Z1
    // lane 0 A = (Y1 - X1)(y - x), lane 1 B = (Y1 + X1)(y + x), lane 2 D, lane 3 C = T1 2d x y
    return p4_tail(fe_mul(fe_select(c == 0, diff, fe_select(c == 3, p, sum)), w));
}

// field25519.cuh's ge_add4 (add-2008-hwcd-3) over p4_tail: 3 products deep.
__device__ __forceinline__ fe p4_add4(const fe &p, const fe &q) {
    const int lane = threadIdx.x & 31, c = lane & 3;
    const bool odd = (c & 1) != 0;
    const fe got = fe_from_lane(fe_select(odd, p, q), lane ^ 1);
    const fe xx = fe_select(odd, got, p), yy = fe_select(odd, q, got);
    const fe diff = fe_sub(yy, xx), sum = fe_add(yy, xx);
    const fe other = fe_from_lane(fe_select(odd, diff, sum), lane ^ 1);
    // lane 0 (Y1 - X1)(Y2 - X2), lane 1 (Y1 + X1)(Y2 + X2), lane 2 Z1 Z2, lane 3 T1 T2; then D = 2 Z1 Z2, C = 2d T1 T2
    const fe m = fe_mul(fe_select(c == 0, diff, fe_select(c == 1, other, p)),
                        fe_select(c == 0, other, fe_select(c == 1, sum, q)));
    fe k = fe_one();
    k.w[0] = c == 2 ? 2u : 1u;
    return p4_tail(fe_mul(m, fe_select(c == 3, fe_d2(), k)));
}

__global__ void __launch_bounds__(P4_MAX_THREADS, 1) bit_sum_kernel(
    const u32 *__restrict__ table, long s_tab, const int64_t *__restrict__ bits, const int64_t *__restrict__ sx,
    const int64_t *__restrict__ sy, const int64_t *__restrict__ sz, const int64_t *__restrict__ st,
    long row_stride, long limb_stride, long batch, int mn, int64_t *__restrict__ out) {
    __shared__ __align__(16) u32 sh[(P4_MAX_THREADS / 32) * 32 * 8];  // a coordinate a lane
    const long b = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, c = tid & 3, warp = tid >> 5, a = tid >> 2, A = blockDim.x >> 2;
    const uint4 *digit1 = reinterpret_cast<const uint4 *>(table + s_tab * PR_ENTRY_WORDS);  // window 0, digit 1
    const int wg = c == 0 ? 2 : c == 1 ? 0 : 4, wh = c == 0 ? 0 : c == 1 ? 2 : 4;  // 16-byte words of y - x, ..
    // lane i's operand: g_i's, or -h_i's; the identity's (1, 1, one, 0) past the last lane
    auto leaf = [&](int i) {
        fe w = fe_one();
        if (i < mn) {
            const bool bit = bits[b * mn + i] != 0;
            const uint4 *g = digit1 + (long)i * (2 * PR_ENTRY_WORDS / 4), *h = g + PR_ENTRY_WORDS / 4;
            if (c != 2) {
                const fe wg_ = fe_load_words(g + wg), wh_ = fe_load_words(h + wh);
                w = bit ? wg_ : c == 3 ? fe_neg(wh_) : wh_;
            }
        } else if (c == 3) {
            w = fe_zero();
        }
        return w;
    };
    // P4 phase: start
    fe acc = ge4_identity(c);
    if (a == 0) acc = fe_load((c == 0 ? sx : c == 1 ? sy : c == 2 ? sz : st) + b * row_stride, limb_stride);
    fe w = leaf(a);
#pragma unroll 1
    for (int i0 = 0; i0 < mn; i0 += A) {  // the same count for every adder: mn and A are powers of two
        const fe next = leaf(i0 + A < mn ? i0 + A + a : mn);
        acc = p4_madd4(acc, w);
        w = next;
    }
    // P4 phase: leaves
    const int n = mn < A ? mn : A;  // adders that hold a point
    for (int wv = n >> 4; wv >= 1; wv >>= 1) {  // n / 8 warps hold points; the upper half hands its sums down
        if (warp >= wv && warp < 2 * wv) fe_store_words(reinterpret_cast<uint4 *>(sh + (warp * 32 + lane) * 8), acc);
        __syncthreads();
        if (warp < wv) acc = p4_add4(acc, fe_load_words_shared(reinterpret_cast<const uint4 *>(sh + ((warp + wv) * 32 + lane) * 8)));
    }
    // P4 phase: warps
    if (warp == 0) {
#pragma unroll 1
        for (int s = 1; s < n && s < 8; s <<= 1) acc = p4_add4(acc, fe_from_lane(acc, lane ^ (4 * s)));
    }
    // P4 phase: lanes
    if (tid < 4) fe_store(out + (c * batch + b) * 16, 1, acc);
    // P4 phase: store
}

extern "C" const char *bppt_prover_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static bool pow2(long v) { return v > 0 && (v & (v - 1)) == 0; }

static bool shape_ok(long batch, long mn, long rounds, long deg) {
    return batch >= 1 && batch < (1L << 24) && rounds >= 0 && rounds <= 30 && mn == (1L << rounds) && deg >= 1 &&
           deg <= 64;
}

// Every tensor int64 limbs, contiguous, 16-byte aligned (the wrapper checks), on the current device.  threads: a
// multiple of 32 from 64 to 512.  scratch: null where a proof's p1_words fit in a block's shared memory, else B x
// p1_words 32-bit words.
extern "C" int bppt_prove_prep(const void *y, const void *z, const void *y_inv, const void *bits, const void *r_blind,
                               const void *alpha0, long batch, long m, long n, long deg, long threads, void *a,
                               void *b, void *y_pows, void *y_inv_n, void *alpha, void *scratch, void *stream) {
    const long mn = m * n;
    const long rounds = mn > 0 ? 63 - __builtin_clzl((unsigned long)mn) : -1;
    if (!pow2(m) || !pow2(n) || m > PR_MAX_M || !shape_ok(batch, mn, rounds, deg) || threads < 64 ||
        threads > P1_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const long smem = p1_words(mn, m, deg) * (long)sizeof(u32);
    const bool shared = smem <= PR_MAX_SMEM;
    if (shared == (scratch != nullptr)) return (int)cudaErrorInvalidValue;
    if (shared && smem > 48 * 1024) {
        const cudaError_t err =
            cudaFuncSetAttribute(prove_prep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    if (shared) {
        prove_prep_kernel<<<(unsigned)batch, (unsigned)threads, (size_t)smem, st>>>(
            (const int64_t *)y, (const int64_t *)z, (const int64_t *)y_inv, (const int64_t *)bits,
            (const int64_t *)r_blind, (const int64_t *)alpha0, (int)m, (int)n, (int)deg, (int)rounds, (int64_t *)a,
            (int64_t *)b, (int64_t *)y_pows, (int64_t *)y_inv_n, (int64_t *)alpha);
    } else {
        prove_prep_global_kernel<<<(unsigned)batch, (unsigned)threads, 0, st>>>(
            (const int64_t *)y, (const int64_t *)z, (const int64_t *)y_inv, (const int64_t *)bits,
            (const int64_t *)r_blind, (const int64_t *)alpha0, (int)m, (int)n, (int)deg, (int)rounds, (int64_t *)a,
            (int64_t *)b, (int64_t *)y_pows, (int64_t *)y_inv_n, (int64_t *)alpha, (u32 *)scratch);
    }
    return (int)cudaGetLastError();
}

// e, e_inv, dl_prev, dr_prev, g, h: null in round 0 (no fold).  threads: a multiple of 32 from 64 to 544.  scratch:
// null where a proof's p2_words fit in a block's shared memory, else B x p2_words 32-bit words.
extern "C" int bppt_prove_round(const void *a, const void *b, const void *g, const void *h, const void *alpha,
                                const void *e, const void *e_inv, const void *dl_prev, const void *dr_prev,
                                const void *y_pows, const void *y_inv_n, const void *dl, const void *dr, long batch,
                                long mn, long rounds, long r, long deg, long threads, void *a_out, void *b_out,
                                void *g_out, void *h_out, void *alpha_out, void *scalars, void *scratch, void *stream) {
    if (!shape_ok(batch, mn, rounds, deg) || r < 0 || r >= rounds || (r > 0) != (e != nullptr) ||
        threads < 64 || threads > P2_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const long smem = p2_words(mn, r, threads) * (long)sizeof(u32);
    const bool shared = smem <= PR_MAX_SMEM;
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
    if (!shape_ok(batch, mn, rounds, deg) || (rounds > 0) != (e != nullptr) || threads < 64 ||
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
// from 32 to 512 (the tree halves the adders).
extern "C" int bppt_bit_sum(const void *table, long s_tab, const void *bits, const void *x, const void *y,
                            const void *z, const void *t, long row_stride, long limb_stride, long batch, long mn,
                            long threads, void *out, void *stream) {
    if (batch < 1 || batch >= (1L << 24) || !pow2(mn) || s_tab < 2 * mn || threads < 32 ||
        threads > P4_MAX_THREADS || !pow2(threads))
        return (int)cudaErrorInvalidValue;
    bit_sum_kernel<<<(unsigned)batch, (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const u32 *)table, s_tab, (const int64_t *)bits, (const int64_t *)x, (const int64_t *)y,
        (const int64_t *)z, (const int64_t *)t, row_stride, limb_stride, batch, (int)mn, (int64_t *)out);
    return (int)cudaGetLastError();
}
