// S1: the batch verifier's scalar pass for one shape group of proofs, in
// two kernels on GF(l) (scalar_l.cuh).
//
// Replaces no Pallas kernel: its counterpart is the XLA program
// `scalar_pass` (bulletproofs_plus_tpu/models/verifier_kernels.py:130), one
// jitted program a proof shape.  From each proof's challenges y, z, e_1..e_k,
// e, its batch weight w, its r1, s1, d1 and its minimum values, it computes
// what that program returns (reference src/range_proof.rs:856-1062):
//   gi[i], hi[i]   the generator lanes' scalars, summed over the batch mod l,
//                  for i < mn, and zero for mn <= i < max_mn;
//   gb[k], hb      the base points' scalars, summed over the batch;
//   commit[j], a1_s, b_s, a_s, li[j], ri[j]   each proof's dynamic scalars.
// Inputs and outputs are int64 radix-2^16 limbs (ops/field.py's layout, each
// limb below 2^16); every output is canonical, so it equals the plain torch
// version (ops/field.py) limb for limb, whatever order the sums take.
//
// The algebra is the JAX program's, regrouped so that a lane's term needs
// few products.  With P(i) = prod over the bits b set in i of e_(k-b)^2 (so
// s_i = e_inv_prod P(i), the s-vector's bit-product form), y^-i, and
// d_i = z^(2(j+1)) 2^(i mod n) for j = i / n:
//   w g_i = A y^-i P(i) + C,                 A = w r1 e e_inv_prod, C = w e^2 z,
//   w h_i = D P(mn-1-i) - G_j 2^(i mod n) y^-i - C,
//                                            D = w s1 e e_inv_prod,
//                                            G_j = w e^2 y^mn z^(2(j+1)).
//
// S1a (`scalar_proof_kernel`), a thread a proof: the Montgomery batch
// inversion over [e_1..e_k, y, y - 1] with one Fermat inversion (a zero
// among them poisons the whole proof, every inverse 0, as in
// `_batch_invert` and dalek), y^mn and y^-(2^b) by squarings, the
// z^(2(j+1)) ladder, y_sum, d_sum, the proof's h_base term with its
// minimum values, and the dynamic scalars, written out; then A, D, C, the
// h_base term, e_j^2, y^-(2^b), G_j and w d1 as one column each of a
// scratch table (column, proof, 8 words), so that S1b's threads read
// neighbouring words.  Its prefix products sit in local memory.
//
// S1b (`scalar_lane_kernel`), a block a lane i < max_mn, then a block for
// each base point: its threads stride over the proofs, each summing its
// proofs' terms mod l (y^-i and P(i) as products of the table's squarings
// picked by i's bits: at most k + popcount(i) products, uniform across the
// block), then a tree of modular sums over the block in shared memory.
// Canonical terms make every sum order-free.  A lane at or past mn writes
// zeros; a base block sums its column.
//
// What bounds it on this card: latency.  S1a's thread runs its products
// one after another: 252 squarings and 72 products for the inversion, then
// 27 + 9k + 4m + deg (410 in all for a 64-bit proof with m = 1), in a few
// warps; S1b's threads k + popcount(i) + 2 products a proof and lane.  The card's multiply rate would do the work a few hundred times
// sooner (PERF.md).  A simple, exact kernel first: cutting S1a's chain
// (several threads a proof, a shorter addition chain for l - 2) is later
// work.
//
// `scalar_latency_kernel` is the probe behind S1's `chain_ms`: one warp, a
// chain of dependent `sc_mul_l` (`sc_mul_ns`).

#include <cstdint>
#include <cuda_runtime.h>

#include "scalar_l.cuh"

#define S1_MAX_ROUNDS 30       // mn = 2^rounds
#define S1_PROOF_THREADS 32    // S1a: a warp a block, one proof a thread
#define S1_MAX_LANE_THREADS 256

// Scratch columns (column, proof, 8 words); those after COL_CHSQ start at offsets that follow from the shape.
#define COL_A 0
#define COL_D 1
#define COL_C 2
#define COL_H 3
#define COL_CHSQ 4  // e_j^2, j < rounds; then y^-(2^b), b < rounds; G_j, j < m; w d1_k, k < deg

__device__ __forceinline__ u32 *col_at(u32 *scratch, int col, long b, long batch) {
    return scratch + ((long)col * batch + b) * 8;
}

__device__ __forceinline__ const u32 *col_at(const u32 *scratch, int col, long b, long batch) {
    return scratch + ((long)col * batch + b) * 8;
}

__global__ void __launch_bounds__(S1_PROOF_THREADS) scalar_proof_kernel(
    const int64_t *__restrict__ y_in, const int64_t *__restrict__ z_in, const int64_t *__restrict__ es_in,
    const int64_t *__restrict__ e_in, const int64_t *__restrict__ w_in, const int64_t *__restrict__ r1_in,
    const int64_t *__restrict__ s1_in, const int64_t *__restrict__ d1_in, const int64_t *__restrict__ min_in,
    long batch, int rounds, int m, int n, int deg, int64_t *__restrict__ commit_out, int64_t *__restrict__ a1_out,
    int64_t *__restrict__ b_out, int64_t *__restrict__ a_out, int64_t *__restrict__ li_out,
    int64_t *__restrict__ ri_out, u32 *__restrict__ scratch) {
    const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= batch) return;
    const int col_yinv = COL_CHSQ + rounds, col_g = col_yinv + rounds, col_w = col_g + m;
    u32 zero[8], one[8], y[8], w[8], e_sq[8], a_s[8], t[8], u[8], acc[8];
    set_small(zero, 0u);
    set_small(one, 1u);
    load_limbs(y_in + 16 * b, y);
    load_limbs(w_in + 16 * b, w);

    // the proof's own scalars: a_s = -(w e^2), a1_s = -(w e), b_s = -w
    load_limbs(e_in + 16 * b, t);
    sc_sqr_l(t, e_sq);
    sc_mul_l(w, t, u);
    sc_sub_l(zero, u, u);
    store_limbs(a1_out + 16 * b, u);
    sc_sub_l(zero, w, u);
    store_limbs(b_out + 16 * b, u);
    sc_mul_l(w, e_sq, u);
    sc_sub_l(zero, u, a_s);
    store_limbs(a_out + 16 * b, a_s);

    // forward: prefix products of [e_1..e_k, y, y - 1]; each e_j^2 to the scratch and li_j = a_s e_j^2 out
    u32 prefix[S1_MAX_ROUNDS + 1][8];
    for (int j = 0; j < rounds; ++j) {
        load_limbs(es_in + 16 * (b * rounds + j), t);
        sc_sqr_l(t, u);
        copy8(col_at(scratch, COL_CHSQ + j, b, batch), u);
        sc_mul_l(a_s, u, u);
        store_limbs(li_out + 16 * (b * rounds + j), u);
        if (j == 0)
            copy8(acc, t);
        else
            sc_mul_l(acc, t, acc);
        copy8(prefix[j], acc);
    }
    if (rounds == 0)
        copy8(acc, y);
    else
        sc_mul_l(acc, y, acc);
    copy8(prefix[rounds], acc);
    u32 ym1[8];
    sc_sub_l(y, one, ym1);
    sc_mul_l(acc, ym1, acc);
    sc_inv_l(acc, acc);

    // back-substitution: (y - 1)^-1, y^-1, then e_inv_prod = (e_1 .. e_k)^-1 and each e_j^-1 (ri_j = a_s e_j^-2)
    u32 y1_inv[8], y_inv[8], chinv[8];
    sc_mul_l(acc, prefix[rounds], y1_inv);
    sc_mul_l(acc, ym1, acc);
    if (rounds == 0) {
        copy8(y_inv, acc);
        copy8(chinv, one);
    } else {
        sc_mul_l(acc, prefix[rounds - 1], y_inv);
        sc_mul_l(acc, y, acc);
        copy8(chinv, acc);
        for (int j = rounds - 1; j >= 1; --j) {
            sc_mul_l(acc, prefix[j - 1], t);
            sc_sqr_l(t, t);
            sc_mul_l(a_s, t, t);
            store_limbs(ri_out + 16 * (b * rounds + j), t);
            load_limbs(es_in + 16 * (b * rounds + j), t);
            sc_mul_l(acc, t, acc);
        }
        sc_sqr_l(acc, t);
        sc_mul_l(a_s, t, t);
        store_limbs(ri_out + 16 * (b * rounds), t);
    }

    // y^mn = y^(2^k) and y^-(2^b), b < k, to the scratch
    u32 ynm[8];
    copy8(ynm, y);
    copy8(t, y_inv);
    for (int j = 0; j < rounds; ++j) {
        copy8(col_at(scratch, col_yinv + j, b, batch), t);
        if (j + 1 < rounds) sc_sqr_l(t, t);
        sc_sqr_l(ynm, ynm);
    }
    // y_sum = y (y^mn - 1) / (y - 1), through the batch-inverted (y - 1)^-1
    u32 ysum[8];
    sc_sub_l(ynm, one, t);
    sc_mul_l(y, t, t);
    sc_mul_l(t, y1_inv, ysum);

    // the z^(2(j+1)) ladder: commitment scalars -(e^2 y^(mn+1) w) z^(2(j+1)), G_j, their sum, and the sum of
    // the commitment scalars times the minimum values
    u32 z[8], zsq[8], q[8], gq[8], zp[8], zsum[8], mins[8];
    load_limbs(z_in + 16 * b, z);
    sc_sqr_l(z, zsq);
    sc_mul_l(ynm, y, q);
    sc_mul_l(e_sq, q, q);
    sc_mul_l(q, w, q);
    sc_mul_l(w, e_sq, gq);
    sc_mul_l(gq, ynm, gq);
    copy8(zp, zsq);
    copy8(zsum, zero);
    copy8(mins, zero);
    for (int j = 0; j < m; ++j) {
        sc_add_l(zsum, zp, zsum);
        sc_mul_l(q, zp, t);
        sc_sub_l(zero, t, t);
        store_limbs(commit_out + 16 * (b * m + j), t);
        load_limbs(min_in + 16 * (b * m + j), u);
        sc_mul_l(t, u, u);
        sc_add_l(mins, u, mins);
        sc_mul_l(gq, zp, u);
        copy8(col_at(scratch, col_g + j, b, batch), u);
        if (j + 1 < m) sc_mul_l(zp, zsq, zp);
    }

    // h_base's term: w (r1 y s1 + e^2 (y^(mn+1) z d_sum + (z^2 - z) y_sum)) - sum_j commit_j min_j, with
    // d_sum = (sum_j z^(2(j+1))) (2^n - 1)
    const uint64_t two_n_1 = n >= 64 ? ~0ull : (1ull << n) - 1;
    set_small(u, (u32)two_n_1);
    u[1] = (u32)(two_n_1 >> 32);
    sc_mul_l(zsum, u, zsum);
    sc_mul_l(ynm, y, t);
    sc_mul_l(t, z, t);
    sc_mul_l(t, zsum, t);
    sc_sub_l(zsq, z, u);
    sc_mul_l(u, ysum, u);
    sc_add_l(t, u, t);
    sc_mul_l(e_sq, t, t);
    u32 r1[8], s1[8];
    load_limbs(r1_in + 16 * b, r1);
    load_limbs(s1_in + 16 * b, s1);
    sc_mul_l(r1, y, u);
    sc_mul_l(u, s1, u);
    sc_add_l(u, t, t);
    sc_mul_l(w, t, t);
    sc_sub_l(t, mins, t);
    copy8(col_at(scratch, COL_H, b, batch), t);

    // the lanes' factors: A = w r1 e e_inv_prod, D = w s1 e e_inv_prod, C = w e^2 z; then w d1_k
    load_limbs(e_in + 16 * b, u);
    sc_mul_l(w, u, u);
    sc_mul_l(u, chinv, u);
    sc_mul_l(u, r1, t);
    copy8(col_at(scratch, COL_A, b, batch), t);
    sc_mul_l(u, s1, t);
    copy8(col_at(scratch, COL_D, b, batch), t);
    sc_mul_l(w, e_sq, t);
    sc_mul_l(t, z, t);
    copy8(col_at(scratch, COL_C, b, batch), t);
    for (int k = 0; k < deg; ++k) {
        load_limbs(d1_in + 16 * (b * deg + k), t);
        sc_mul_l(w, t, t);
        copy8(col_at(scratch, col_w + k, b, batch), t);
    }
}

// acc = src where there is no factor yet, else acc * src
__device__ __forceinline__ void mul_into(u32 *acc, bool &have, const u32 *src) {
    if (have) {
        u32 v[8];
        copy8(v, src);
        sc_mul_l(acc, v, acc);
    } else {
        copy8(acc, src);
        have = true;
    }
}

__global__ void __launch_bounds__(S1_MAX_LANE_THREADS) scalar_lane_kernel(
    const u32 *__restrict__ scratch, long batch, int rounds, int m, int n, int deg, int max_mn,
    int64_t *__restrict__ gi_out, int64_t *__restrict__ hi_out, int64_t *__restrict__ gb_out,
    int64_t *__restrict__ hb_out) {
    __shared__ u32 sg[S1_MAX_LANE_THREADS][8], sh[S1_MAX_LANE_THREADS][8];
    const int t = threadIdx.x, T = blockDim.x;
    const long blk = blockIdx.x;
    const int mn = 1 << rounds;
    const int col_yinv = COL_CHSQ + rounds, col_g = col_yinv + rounds, col_w = col_g + m;
    u32 g[8], h[8], u[8], v[8];
    set_small(g, 0u);
    set_small(h, 0u);
    if (blk < max_mn) {
        const int i = (int)blk;
        if (i >= mn) {  // padding up to the batch's widest group: zeros
            if (t < 16) gi_out[16 * i + t] = hi_out[16 * i + t] = 0;
            return;
        }
        u32 two_k[8];  // 2^(i mod n)
        set_small(two_k, 0u);
        const int k2 = i & (n - 1);
        two_k[k2 >> 5] = 1u << (k2 & 31);
        const int j = i / n;
        for (long b = t; b < batch; b += T) {
            u32 yi[8], pi[8], pr[8];
            bool has_yi = false, has_pi = false, has_pr = false;
            for (int k = 0; k < rounds; ++k) {
                const u32 *chsq = col_at(scratch, COL_CHSQ + rounds - 1 - k, b, batch);
                if ((i >> k) & 1) {
                    mul_into(yi, has_yi, col_at(scratch, col_yinv + k, b, batch));
                    mul_into(pi, has_pi, chsq);
                } else {
                    mul_into(pr, has_pr, chsq);
                }
            }
            // w g_i = A y^-i P(i) + C
            copy8(u, col_at(scratch, COL_A, b, batch));
            if (has_yi) sc_mul_l(u, yi, u);
            if (has_pi) sc_mul_l(u, pi, u);
            copy8(v, col_at(scratch, COL_C, b, batch));
            sc_add_l(u, v, u);
            sc_add_l(g, u, g);
            // w h_i = D P(mn-1-i) - G_j 2^(i mod n) y^-i - C
            sc_sub_l(h, v, h);
            copy8(u, col_at(scratch, COL_D, b, batch));
            if (has_pr) sc_mul_l(u, pr, u);
            sc_add_l(h, u, h);
            copy8(u, col_at(scratch, col_g + j, b, batch));
            sc_mul_l(u, two_k, u);
            if (has_yi) sc_mul_l(u, yi, u);
            sc_sub_l(h, u, h);
        }
    } else {  // a base point's column: w d1_k for G_k, the h_base term for H
        const int c = (int)(blk - max_mn);
        const int col = c < deg ? col_w + c : COL_H;
        for (long b = t; b < batch; b += T) {
            copy8(u, col_at(scratch, col, b, batch));
            sc_add_l(g, u, g);
        }
    }
    copy8(sg[t], g);
    copy8(sh[t], h);
    __syncthreads();
    for (int s = T >> 1; s > 0; s >>= 1) {
        if (t < s) {
            copy8(u, sg[t + s]);
            sc_add_l(g, u, g);
            copy8(sg[t], g);
            copy8(u, sh[t + s]);
            sc_add_l(h, u, h);
            copy8(sh[t], h);
        }
        __syncthreads();
    }
    if (t == 0) {
        if (blk < max_mn) {
            store_limbs(gi_out + 16 * blk, g);
            store_limbs(hi_out + 16 * blk, h);
        } else if (blk - max_mn < deg) {
            store_limbs(gb_out + 16 * (blk - max_mn), g);
        } else {
            store_limbs(hb_out, g);
        }
    }
}

// One warp, each lane a chain of `iters` dependent products acc = acc * x from acc = x: x^(iters + 1).
__global__ void scalar_latency_kernel(const int64_t *in, int64_t *out, int iters) {
    u32 x[8], acc[8];
    load_limbs(in + 16 * threadIdx.x, x);
    copy8(acc, x);
    for (int k = 0; k < iters; ++k) sc_mul_l(acc, x, acc);
    store_limbs(out + 16 * threadIdx.x, acc);
}

extern "C" const char *bppt_scalar_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static bool pow2(long v) { return v > 0 && (v & (v - 1)) == 0; }

static bool scalar_args_ok(long batch, long rounds, long m, long n, long deg, long max_mn, long lane_threads) {
    return batch >= 1 && batch < (1L << 24) && rounds >= 0 && rounds <= S1_MAX_ROUNDS && pow2(m) && pow2(n) &&
           n <= 64 && m * n == (1L << rounds) && deg >= 1 && deg <= 64 && max_mn >= m * n &&
           max_mn < (1L << 30) && pow2(lane_threads) && lane_threads >= 32 &&
           lane_threads <= S1_MAX_LANE_THREADS;
}

// y, z, e, w, r1, s1: (batch, 16) int64 limbs; es: (batch, rounds, 16); d1: (batch, deg, 16); mins:
// (batch, m, 16); each contiguous.  Outputs: commit (batch, m, 16), a1, b, a (batch, 16), li, ri (batch, rounds,
// 16), gi, hi (max_mn, 16), gb (deg, 16), hb (16).  scratch: (4 + 2 rounds + m + deg) x batch x 8 words.  All on
// the current device; S1a then S1b on `stream`.
extern "C" int bppt_scalar_pass(const void *y, const void *z, const void *es, const void *e, const void *w,
                                const void *r1, const void *s1, const void *d1, const void *mins, long batch,
                                long rounds, long m, long n, long deg, long max_mn, void *commit, void *a1, void *b,
                                void *a, void *li, void *ri, void *gi, void *hi, void *gb, void *hb, void *scratch,
                                long lane_threads, void *stream) {
    if (!scalar_args_ok(batch, rounds, m, n, deg, max_mn, lane_threads)) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    scalar_proof_kernel<<<(unsigned)((batch + S1_PROOF_THREADS - 1) / S1_PROOF_THREADS), S1_PROOF_THREADS, 0, st>>>(
        (const int64_t *)y, (const int64_t *)z, (const int64_t *)es, (const int64_t *)e, (const int64_t *)w,
        (const int64_t *)r1, (const int64_t *)s1, (const int64_t *)d1, (const int64_t *)mins, batch, (int)rounds,
        (int)m, (int)n, (int)deg, (int64_t *)commit, (int64_t *)a1, (int64_t *)b, (int64_t *)a, (int64_t *)li,
        (int64_t *)ri, (u32 *)scratch);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    scalar_lane_kernel<<<(unsigned)(max_mn + deg + 1), (unsigned)lane_threads, 0, st>>>(
        (const u32 *)scratch, batch, (int)rounds, (int)m, (int)n, (int)deg, (int)max_mn, (int64_t *)gi,
        (int64_t *)hi, (int64_t *)gb, (int64_t *)hb);
    return (int)cudaGetLastError();
}

// in, out: (32, 16) int64 limbs.
extern "C" int bppt_scalar_latency(const void *in, void *out, long iters, void *stream) {
    scalar_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int64_t *)in, (int64_t *)out, (int)iters);
    return (int)cudaGetLastError();
}
