// K5-K6: the batched fixed-base multiscalar multiplication over precomputed
// 4-bit digit tables, the prover's workhorse (every round's L/R and the
// final A1 are sums over the original generators).
//
// Replaces the TPU kernels of bulletproofs_plus_tpu/ops/pallas_msm.py:
//   K5 _fixed_acc_kernel  (:536)  for each batch row f and lane s the sum
//                                 over the 64 windows of T[w, digit, s]
//   K6 _fixed_fold_kernel (:567)  fold the lane axis to one point per row
//                                 (and per lane group)
// They compute the same function; the split differs.  On the TPU the window
// axis was the innermost, sequential grid axis and one accumulator block was
// revisited 64 times; the lane chunks that remained were summed afterwards
// outside the kernels.  Here blocks run in no order, so a K5 thread owns one
// (row, lane, window range), walks its 16 windows in a loop with the
// accumulator in registers and writes one partial; K6 gives each (row,
// group) a block that sums that group's partials with a shared-memory tree,
// which also takes over the sum across lane chunks.
//
// Table: T[w, d, lane] = d * 16^w * P_lane as 32 packed 32-bit words (x, y,
// z, t; 128 bytes, one cache line), layout (64, 16, S_tab, 32).  That is a
// quarter of the int64-limb form (16.8 MB instead of 67 MB for the 128
// generator lanes of a 64-bit proof), so a whole table stays in the 50 MB
// L2.  Entry d = 0 is the identity: zero digits, the padding of every ragged
// shape, add nothing.  `lane_idx` maps scalar position -> table lane, so the
// prover's per-round lane permutation reads the table in place instead of
// copying it.
//
// Bound on this card: operations.  Each (row, lane, window) is one complete
// addition, 9 field multiplications of about 128 multiply-adds, against a
// 128-byte table read that mostly hits L2.  Design: thread g = (q, f, s)
// with s fastest, so a warp reads neighbouring scalar limbs and writes
// neighbouring partials; splitting the 64 windows four ways gives F*S*4
// threads (65,536 for 128 proofs x 128 lanes) and chains of 16 additions.

#include "field25519.cuh"

#define N_WINDOWS 64
#define N_DIGITS 16
#define WSPLIT 4                       // window ranges per (row, lane)
#define WPT (N_WINDOWS / WSPLIT)       // windows per thread: 16 = 64 scalar bits = 4 limbs
#define ACC_THREADS 128
#define FOLD_THREADS 128

// Eight words of a table entry (32-byte aligned) as two 16-byte loads.
__device__ __forceinline__ fe fe_load_words(const uint4 *__restrict__ v) {
    const uint4 lo = __ldg(v), hi = __ldg(v + 1);
    fe r;
    r.w[0] = lo.x; r.w[1] = lo.y; r.w[2] = lo.z; r.w[3] = lo.w;
    r.w[4] = hi.x; r.w[5] = hi.y; r.w[6] = hi.z; r.w[7] = hi.w;
    return r;
}

__device__ __forceinline__ ge ge_load_words(const u32 *__restrict__ entry) {
    const uint4 *v = reinterpret_cast<const uint4 *>(entry);
    ge p;
    p.x = fe_load_words(v);
    p.y = fe_load_words(v + 2);
    p.z = fe_load_words(v + 4);
    p.t = fe_load_words(v + 6);
    return p;
}

// table: (64, 16, s_tab, 32) words; lane_idx: (s,) table lane of each scalar
// position; scalars: (16, f, s) limb-major; out: (4, 16, f, WSPLIT * s),
// partial [., ., row, q * s + pos] = sum over windows 16q..16q+15.
__global__ void __launch_bounds__(ACC_THREADS) fixed_acc_kernel(const u32 *__restrict__ table,
                                                                const int64_t *__restrict__ lane_idx,
                                                                const int64_t *__restrict__ scalars,
                                                                int64_t *__restrict__ out, long f, long s,
                                                                long s_tab) {
    const long g = (long)blockIdx.x * ACC_THREADS + threadIdx.x;
    if (g >= WSPLIT * f * s) return;
    const long pos = g % s;
    const long row = (g / s) % f;
    const int q = (int)(g / (s * f));
    const long lane = lane_idx[pos];
    const long fs = f * s;
    const int64_t *sp = scalars + row * s + pos;
    u64 bits = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) bits |= ((u64)sp[(4 * q + k) * fs] & 0xFFFFu) << (16 * k);
    const long digit_stride = s_tab * 32;
    const u32 *base = table + ((long)(WPT * q) * N_DIGITS * s_tab + lane) * 32;
    ge acc = ge_load_words(base + (long)(bits & 15) * digit_stride);
#pragma unroll 1
    for (int j = 1; j < WPT; ++j) {
        const long d = (long)((bits >> (4 * j)) & 15);
        acc = ge_add(acc, ge_load_words(base + ((long)j * N_DIGITS + d) * digit_stride));
    }
    const long p = (long)WSPLIT * s;
    ge_store(out + row * p + q * s + pos, 16 * f * p, f * p, acc);
}

// parts: (4, 16, f, WSPLIT * s) -> out: (4, 16, f, groups); block (row,
// group) sums the partials of lanes [group * s / groups, (group + 1) * s /
// groups) over all window ranges.
__global__ void __launch_bounds__(FOLD_THREADS) fixed_fold_kernel(const int64_t *__restrict__ parts,
                                                                  int64_t *__restrict__ out, long f, long s,
                                                                  long groups) {
    __shared__ u32 sh[FOLD_THREADS * GE_SMEM_STRIDE];
    const int tid = threadIdx.x;
    const long row = blockIdx.x / groups;
    const long grp = blockIdx.x % groups;
    const long per = s / groups;
    const long count = WSPLIT * per;
    const long p = (long)WSPLIT * s;
    const long limb_stride = f * p;
    ge acc = ge_identity();  // threads past `count` contribute the identity
#pragma unroll 1
    for (long i = tid; i < count; i += FOLD_THREADS) {
        const long at = (i / per) * s + grp * per + (i % per);
        acc = ge_add(acc, ge_load(parts + row * p + at, 16 * limb_stride, limb_stride));
    }
    int width = 1;  // tree width: the power of two covering the threads that hold a partial
    while (width < count && width < FOLD_THREADS) width <<= 1;
    ge_to_smem(&sh[tid * GE_SMEM_STRIDE], acc);
    __syncthreads();
#pragma unroll 1
    for (int h = width / 2; h > 0; h >>= 1) {
        if (tid < h) {
            acc = ge_add(acc, ge_from_smem(&sh[(tid + h) * GE_SMEM_STRIDE]));
            ge_to_smem(&sh[tid * GE_SMEM_STRIDE], acc);
        }
        __syncthreads();
    }
    if (tid == 0) ge_store(out + row * groups + grp, 16 * f * groups, f * groups, acc);
}

extern "C" const char *bppt_fixed_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// table: int32 words; lane_idx, scalars, out: int64; all contiguous, on the current device.
extern "C" int bppt_fixed_acc(const void *table, const void *lane_idx, const void *scalars, void *out, long f,
                              long s, long s_tab, void *stream) {
    const long threads = WSPLIT * f * s;
    const unsigned blocks = (unsigned)((threads + ACC_THREADS - 1) / ACC_THREADS);
    fixed_acc_kernel<<<blocks, ACC_THREADS, 0, (cudaStream_t)stream>>>(
        (const u32 *)table, (const int64_t *)lane_idx, (const int64_t *)scalars, (int64_t *)out, f, s, s_tab);
    return (int)cudaGetLastError();
}

extern "C" int bppt_fixed_fold(const void *parts, void *out, long f, long s, long groups, void *stream) {
    fixed_fold_kernel<<<(unsigned)(f * groups), FOLD_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)parts, (int64_t *)out, f, s, groups);
    return (int)cudaGetLastError();
}
