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
// S1a (`scalar_proof_kernel`): a warp a block, `lanes` lanes a proof (8 up to
// 6 rounds, 16 up to 14, 32 up to 30), running the proof's program
// (ops/cuda_scalar.py `proof_program`, built on the host for the shape and
// copied into shared memory first): its values sit in slots of shared
// memory, and each step every lane loads two slots, computes one product,
// sum or difference mod l and stores one slot.  A shape whose program and
// slots a block's 227 KB cannot hold (m above 1,024 at 64 bits) reads its
// program in place and keeps each proof's slots in global memory
// (`scalar_proof_global_kernel`, the same steps on another pointer).  In one step each of
// [e_1..e_k, y, y - 1] is inverted on a lane of its own (`sc_inv_l_warp`:
// divsteps, not Fermat); a zero among them poisons the proof, every inverse
// 0, as in `_batch_invert` and dalek, by a vote of the proof's lanes.  The
// other steps spread the proof's products over its lanes: y^mn and
// y^-(2^b) by squarings, the z^(2(j+1)) ladder, the h_base term, A, D, C,
// G_j and w d1_k, the dynamic scalars.  The lanes load the inputs a row
// each, at each input's own row stride (the replay's views are read in
// place), and at the end store the dynamic scalars and a scratch table
// (column, proof, 8 words) of A, D, C, the h_base term, e_j^2, y^-(2^b), G_j
// and w d1_k, so that S1b's threads read neighbouring words.
//
// S1b (`scalar_lane_kernel`), a block a lane i < max_mn, then a block for
// each base point: its threads stride over the proofs, each summing its
// proofs' terms mod l (y^-i and P(i) as products of the table's squarings
// picked by i's bits: at most k + popcount(i) products, uniform across the
// block), then a tree of modular sums over the block in shared memory.
// Canonical terms make every sum order-free.  A lane at or past mn writes
// zeros; a base block sums its column.
//
// What bounds it on this card: latency.  S1a's first form ran a thread a proof
// through 410 dependent products mod l, 324 of them a Fermat inversion, on 8
// of 132 SMs.  Now a proof's chain is one inversion (17 or 18 batches of 30
// divsteps, each batch some 1,200 instructions that one warp issues one
// after another) and the program's product steps (9 at 64 bits and m = 1:
// y^mn's six squarings and the two products after them), each product on
// the three-fold reduction; 256 proofs take 64 warps on 64 SMs.  S1b's
// threads run k + popcount(i) + 2 products a proof and lane, a block of 256
// threads a lane on 66 of the SMs.  The card's multiply rate would do the
// work tens of times sooner (PERF.md).
//
// `scalar_latency_kernel` and `scalar_inv_latency_kernel` are the probes
// behind S1's `chain_ms`: one warp, a chain of dependent `sc_mul_l`
// (`sc_mul_ns`) or `sc_inv_l_warp` (`sc_inv_ns`).

#include <cstdint>
#include <cuda_runtime.h>

#include "scalar_l.cuh"

#define S1_MAX_ROUNDS 30       // mn = 2^rounds
#define S1_WARP 32             // S1a: a warp a block, 32 / lanes proofs
#define S1_MAX_SLOTS 1073741824  // an operation's slot indices have 30 bits
#define S1_MAX_SMEM 232448     // shared memory a block may use: 227 KB
#define S1_MAX_LANE_THREADS 256

// An operation: three words, slots a, b, then dst | op << 30.
#define OP_WORDS 3
#define OP_SHIFT 30
#define SLOT_MASK 0x3fffffffu
#define OP_NOP 0u
#define OP_MUL 1u  // in the inversion step: invert slot a
#define OP_ADD 2u
#define OP_SUB 3u

// Slots 0-2 hold 0, 1 and 2^n - 1, then y, z, e, w, r1, s1, e_1..e_k, d1, the minimum values.
#define SLOT_FIXED 9

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

// The program's words in shared memory, rounded up to 16 bytes so that the slots after them stay aligned.
__host__ __device__ __forceinline__ int s1_prog_words_aligned(int words) { return (words + 3) & ~3; }

// S1a's inputs in slot order, y, z, e, w, r1, s1, e_1..e_k, d1, the minimum values: each a (batch, [items,] 16)
// int64 tensor whose rows lie `stride` limbs apart, its items contiguous within a row (the replay hands y, z, the
// round challenges and e over as views of one tensor).
#define S1_INPUTS 9
struct S1Inputs {
    const int64_t *p[S1_INPUTS];
    long stride[S1_INPUTS];
};

#define S1A_PARAMS                                                                                                 \
    const S1Inputs in, long batch, int rounds, int m, int n, int deg, int64_t *__restrict__ commit_out,              \
        int64_t *__restrict__ a1_out, int64_t *__restrict__ b_out, int64_t *__restrict__ a_out,                      \
        int64_t *__restrict__ li_out, int64_t *__restrict__ ri_out, u32 *__restrict__ scratch, u32 *global_slots,    \
        const u32 *__restrict__ prog, int steps, int inv_step, int slots, int lanes
#define S1A_ARGS                                                                                                   \
    in, batch, rounds, m, n, deg, commit_out, a1_out, b_out, a_out, li_out, ri_out, scratch, global_slots, prog,    \
        steps, inv_step, slots, lanes

// prog: (steps, lanes) operations of three words, then the output slots in store order: commit_j, a1, b, a, li_j,
// ri_j, then the scratch columns.  kGlobal false (`scalar_proof_kernel`): shared memory holds the program, copied
// in first, then (32 / lanes) proofs x slots x 8 words.  kGlobal true (`scalar_proof_global_kernel`, a shape whose
// slots a block's shared memory cannot hold): the program is read in place and each proof's slots lie in
// global_slots, slots x 8 words a proof of the grid.  The same steps either way, on another pointer.
template <bool kGlobal>
__device__ __forceinline__ void scalar_proof(S1A_PARAMS) {
    extern __shared__ u32 s1_smem[];
    const int t = threadIdx.x % lanes, p = threadIdx.x / lanes;
    const long b = (long)blockIdx.x * (S1_WARP / lanes) + p;
    const bool live = b < batch;  // a proof past the batch runs on zeros and stores nothing
    const int n_dyn = m + 3 + 2 * rounds, n_out = n_dyn + COL_CHSQ + 2 * rounds + m + deg;
    const long op_words = (long)OP_WORDS * steps * lanes;
    const u32 *words = prog;
    u32 *S;
    if constexpr (!kGlobal) {
        for (long i = threadIdx.x; i < op_words + n_out; i += S1_WARP) s1_smem[i] = prog[i];
        words = s1_smem;
        S = s1_smem + s1_prog_words_aligned((int)op_words + n_out) + (size_t)p * slots * 8;
    } else {
        S = global_slots + (size_t)b * slots * 8;
    }
    const int *outs = (const int *)(words + op_words);

    // the inputs, a row a lane: slots 0-2 the constants, then y, z, e, w, r1, s1, e_1..e_k, d1, the minimum values
    const int n_in = SLOT_FIXED + rounds + deg + m;
    for (int i = t; i < n_in; i += lanes) {
        u32 v[8];
        set_small(v, 0u);
        if (i == 1) {
            v[0] = 1u;
        } else if (i == 2) {
            const uint64_t two_n_1 = n >= 64 ? ~0ull : (1ull << n) - 1;
            v[0] = (u32)two_n_1;
            v[1] = (u32)(two_n_1 >> 32);
        } else if (live && i >= 3) {
            int k = i - 3, item = 0;  // the input and its item
            if (i >= SLOT_FIXED + rounds + deg) {
                k = 8;
                item = i - SLOT_FIXED - rounds - deg;
            } else if (i >= SLOT_FIXED + rounds) {
                k = 7;
                item = i - SLOT_FIXED - rounds;
            } else if (i >= SLOT_FIXED) {
                k = 6;
                item = i - SLOT_FIXED;
            }
            load_limbs(in.p[k] + in.stride[k] * b + 16 * item, v);
        }
        copy8(S + 8 * (size_t)i, v);
    }
    __syncwarp();

    const u32 group = (lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u) << (p * lanes);
    for (int s = 0; s < steps; ++s) {
        const u32 *word = words + OP_WORDS * ((long)s * lanes + t);
        const u32 op = word[2] >> OP_SHIFT, dst = word[2] & SLOT_MASK;
        u32 x[8], y[8], r[8];
        copy8(x, S + 8 * (size_t)word[0]);
        copy8(y, S + 8 * (size_t)word[1]);
        __syncwarp();
        if (s == inv_step) {  // every lane of the warp: the batches of divsteps end by a vote
            u32 any = 0u;
#pragma unroll
            for (int k = 0; k < 8; ++k) any |= x[k];
            const u32 zeros = __ballot_sync(0xffffffffu, op == OP_MUL && any == 0u);
            sc_inv_l_warp(x, r, 0xffffffffu);
            if (zeros & group) set_small(r, 0u);
        } else if (op == OP_MUL) {
            sc_mul_l(x, y, r);
        } else if (op == OP_ADD) {
            sc_add_l(x, y, r);
        } else if (op == OP_SUB) {
            sc_sub_l(x, y, r);
        }
        if (op != OP_NOP) copy8(S + 8 * (size_t)dst, r);
        __syncwarp();
    }

    // the outputs, a value a lane
    if (!live) return;
    for (int i = t; i < n_out; i += lanes) {
        const u32 *v = S + 8 * (size_t)outs[i];
        if (i < m) {
            store_limbs(commit_out + 16 * (b * m + i), v);
        } else if (i < m + 3) {
            store_limbs((i == m ? a1_out : i == m + 1 ? b_out : a_out) + 16 * b, v);
        } else if (i < m + 3 + rounds) {
            store_limbs(li_out + 16 * (b * rounds + (i - m - 3)), v);
        } else if (i < n_dyn) {
            store_limbs(ri_out + 16 * (b * rounds + (i - m - 3 - rounds)), v);
        } else {
            copy8(col_at(scratch, i - n_dyn, b, batch), v);
        }
    }
}

__global__ void __launch_bounds__(S1_WARP) scalar_proof_kernel(S1A_PARAMS) { scalar_proof<false>(S1A_ARGS); }

__global__ void __launch_bounds__(S1_WARP) scalar_proof_global_kernel(S1A_PARAMS) { scalar_proof<true>(S1A_ARGS); }

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

// One warp, each lane a chain of `iters` dependent inversions of x: x^((-1)^iters).
__global__ void scalar_inv_latency_kernel(const int64_t *in, int64_t *out, int iters) {
    u32 acc[8];
    load_limbs(in + 16 * threadIdx.x, acc);
    for (int k = 0; k < iters; ++k) sc_inv_l_warp(acc, acc, 0xffffffffu);
    store_limbs(out + 16 * threadIdx.x, acc);
}

extern "C" const char *bppt_scalar_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static bool pow2(long v) { return v > 0 && (v & (v - 1)) == 0; }

static bool scalar_args_ok(long batch, long rounds, long m, long n, long deg, long max_mn, long steps, long inv_step,
                           long slots, long lanes, long lane_threads) {
    return batch >= 1 && batch < (1L << 24) && rounds >= 0 && rounds <= S1_MAX_ROUNDS && pow2(m) && pow2(n) &&
           n <= 64 && m * n == (1L << rounds) && deg >= 1 && deg <= 64 && max_mn >= m * n &&
           max_mn < (1L << 30) && steps >= 1 && inv_step >= 0 && inv_step < steps &&
           slots >= SLOT_FIXED + rounds + deg + m && slots <= S1_MAX_SLOTS && pow2(lanes) && lanes >= rounds + 2 &&
           lanes <= S1_WARP && pow2(lane_threads) && lane_threads >= 32 && lane_threads <= S1_MAX_LANE_THREADS;
}

// y, z, e, w, r1, s1: (batch, 16) int64 limbs; es: (batch, rounds, 16); d1: (batch, deg, 16); mins:
// (batch, m, 16); each with its rows `s*` limbs apart and its items contiguous.  Outputs, contiguous: commit
// (batch, m, 16), a1, b, a (batch, 16), li, ri (batch, rounds, 16), gi, hi (max_mn, 16), gb (deg, 16), hb (16).
// scratch: (4 + 2 rounds + m + deg) x batch x 8 words.  global_slots: null where a block's shared memory holds
// its proofs' slots, else (blocks x 32 / lanes) x slots x 8 words.  prog: S1a's program for this shape (steps x
// lanes x 3 words, then its output slots).  All on the current device; S1a then S1b on `stream`.
extern "C" int bppt_scalar_pass(const void *y, const void *z, const void *es, const void *e, const void *w,
                                const void *r1, const void *s1, const void *d1, const void *mins, long sy, long sz,
                                long ses, long se, long sw, long sr1, long ss1, long sd1, long smins, long batch,
                                long rounds, long m, long n, long deg, long max_mn, void *commit, void *a1, void *b,
                                void *a, void *li, void *ri, void *gi, void *hi, void *gb, void *hb, void *scratch,
                                void *global_slots, const void *prog, long steps, long inv_step, long slots, long lanes,
                                long lane_threads, void *stream) {
    if (!scalar_args_ok(batch, rounds, m, n, deg, max_mn, steps, inv_step, slots, lanes, lane_threads))
        return (int)cudaErrorInvalidValue;
    const S1Inputs in = {{(const int64_t *)y, (const int64_t *)z, (const int64_t *)e, (const int64_t *)w,
                          (const int64_t *)r1, (const int64_t *)s1, (const int64_t *)es, (const int64_t *)d1,
                          (const int64_t *)mins},
                         {sy, sz, se, sw, sr1, ss1, ses, sd1, smins}};
    for (int k = 0; k < S1_INPUTS; ++k)
        if (in.stride[k] < 16) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const long per_block = S1_WARP / lanes;
    const int n_out = (int)(m + 3 + 2 * rounds + COL_CHSQ + 2 * rounds + m + deg);
    const size_t smem = global_slots ? 0 : ((size_t)s1_prog_words_aligned((int)(OP_WORDS * steps * lanes) + n_out) +
                                            per_block * slots * 8) * sizeof(u32);
    if (smem > S1_MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(scalar_proof_kernel,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    auto *const proof_kernel = global_slots ? scalar_proof_global_kernel : scalar_proof_kernel;
    proof_kernel<<<(unsigned)((batch + per_block - 1) / per_block), S1_WARP, smem, st>>>(
        in, batch, (int)rounds, (int)m, (int)n, (int)deg, (int64_t *)commit, (int64_t *)a1, (int64_t *)b,
        (int64_t *)a, (int64_t *)li, (int64_t *)ri, (u32 *)scratch, (u32 *)global_slots, (const u32 *)prog,
        (int)steps, (int)inv_step, (int)slots, (int)lanes);
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

// in, out: (32, 16) int64 limbs, canonical.
extern "C" int bppt_scalar_inv_latency(const void *in, void *out, long iters, void *stream) {
    scalar_inv_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int64_t *)in, (int64_t *)out, (int)iters);
    return (int)cudaGetLastError();
}
