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
// (row, lane, window range), walks its windows in a loop with the
// accumulator in registers and writes one partial; K6 gives each (row,
// group) a block that sums that group's partials with a tree of four-lane
// additions, which also takes over the sum across lane chunks.
//
// Table: T[w, d, lane] = d * 16^w * P_lane, stored as the affine point in
// the form the addition consumes: (y + x, y - x, 2d x y), canonical, 24
// packed 32-bit words (96 bytes, six 16-byte loads), layout (64, 16, S_tab,
// 24): 12.6 MB for the 128 generator lanes of a 64-bit proof, well inside
// the 50 MB L2.  Entry d = 0 is (1, 1, 0), the identity, which the complete
// formulas take: zero digits, the padding of every ragged shape, add
// nothing.  `lane_idx` maps scalar position -> table lane, so the prover's
// per-round lane permutation reads the table in place instead of copying it.
//
// What bounds K5 on this card, and the design.
//   Wide shapes (128 rows x 128 lanes): operations.  A window is one mixed
//   addition, 7 field multiplications (ge_madd; a complete addition of two
//   extended points was 9), and a range's first window is 1 (ge_from_niels
//   instead of an addition to the identity).  The kernel is capped at 128
//   registers (__launch_bounds__(128, 4)), so four blocks of 128 threads
//   fit an SM and the 512 blocks of 128 x 128 x 4 ranges are resident at
//   once: one wave, where 134 registers gave three blocks an SM and a
//   second wave a third full.
//   Narrow shapes (256 rows x 2 lanes, the Pedersen MSMs): latency.  There
//   are too few (row, lane) pairs to fill the card, so the time is the
//   length of one thread's chain of additions.  The window split is a launch
//   parameter: the wrapper picks more and shorter ranges where rows x lanes
//   is small (16 ranges of 4 windows: 8192 threads, chains of 1 + 3), and
//   K6's tree, which is sized to the partials it finds, sums them.
// Thread g = (q, f, s) with s fastest, so a warp reads neighbouring scalar
// limbs.  Partials go to K6 as 32 packed words a point (128 bytes, one line
// a thread) instead of 64 int64 limbs (512 bytes): K6 is bound by bytes.

#include "fold4.cuh"

#define N_WINDOWS 64
#define N_DIGITS 16
#define ENTRY_WORDS 24
#define POINT_WORDS 32
#define ACC_THREADS 128
#define ACC_MIN_BLOCKS 4  // blocks an SM: caps the kernel at 65536 / (4 * 128) = 128 registers

__device__ __forceinline__ gn gn_load_words(const u32 *__restrict__ entry) {
    const uint4 *v = reinterpret_cast<const uint4 *>(entry);
    gn q;
    q.yp = fe_load_words(v);
    q.ym = fe_load_words(v + 2);
    q.t2d = fe_load_words(v + 4);
    return q;
}

// table: (64, 16, s_tab, 24) words; lane_idx: (s,) table lane of each scalar
// position; scalars: (16, f, s) limb-major; out: (f, wsplit * s, 32) words,
// partial [row, q * s + pos] = sum over windows q * 64 / wsplit .. (q + 1) *
// 64 / wsplit - 1.  wsplit is a power of two from 1 to 64.
__global__ void __launch_bounds__(ACC_THREADS, ACC_MIN_BLOCKS)
    fixed_acc_kernel(const u32 *__restrict__ table, const int64_t *__restrict__ lane_idx,
                     const int64_t *__restrict__ scalars, u32 *__restrict__ out, long f, long s, long s_tab,
                     int wsplit) {
    const long g = (long)blockIdx.x * ACC_THREADS + threadIdx.x;
    if (g >= wsplit * f * s) return;
    const long pos = g % s;
    const long row = (g / s) % f;
    const int q = (int)(g / (s * f));
    const int wpt = N_WINDOWS / wsplit;  // windows per thread
    const int w0 = q * wpt;
    const long lane = lane_idx[pos];
    const long fs = f * s;
    const int64_t *sp = scalars + row * s + pos;
    const long digit_stride = s_tab * ENTRY_WORDS;
    const u32 *base = table + ((long)w0 * N_DIGITS * s_tab + lane) * ENTRY_WORDS;
    u32 limb = (u32)sp[(w0 >> 2) * fs];  // four windows a 16-bit limb
    ge acc = ge_from_niels(gn_load_words(base + (long)((limb >> (4 * (w0 & 3))) & 15u) * digit_stride));
#pragma unroll 1
    for (int j = 1; j < wpt; ++j) {
        const int w = w0 + j;
        if ((w & 3) == 0) limb = (u32)sp[(w >> 2) * fs];
        const long d = (long)((limb >> (4 * (w & 3))) & 15u);
        acc = ge_madd(acc, gn_load_words(base + ((long)j * N_DIGITS + d) * digit_stride));
    }
    ge_store_words(out + ((row * wsplit + q) * s + pos) * POINT_WORDS, acc);
}

// parts: (f, wsplit * s, 32) words -> out: (4, 16, f, groups) int64 limbs;
// block (row, group) sums the partials of lanes [group * s / groups,
// (group + 1) * s / groups) over all window ranges, on the four-lane adders
// of fold4.cuh.  The wrapper sizes the block from the count of partials a
// block sums and the number of blocks.
__global__ void __launch_bounds__(FOLD_MAX_THREADS, 1) fixed_fold_kernel(const u32 *__restrict__ parts,
                                                                         int64_t *__restrict__ out, long f, long s,
                                                                         long groups, int wsplit) {
    __shared__ __align__(16) u32 sh[FOLD_SMEM_WORDS];
    const int c = threadIdx.x & 3;
    const long row = blockIdx.x / groups;
    const int grp = (int)(blockIdx.x % groups);
    const int per = (int)(s / groups);
    const int lane0 = grp * per, si = (int)s;
    const u32 *mine = parts + row * wsplit * s * POINT_WORDS + c * 8;  // coordinate c of the row's partials
    // partial i of the block: range i / per, lane i % per of the group
    const fe acc = ge4_block_sum(
        [&](int i) {
            const long at = (long)(i / per) * si + lane0 + i % per;
            return fe_load_words(reinterpret_cast<const uint4 *>(mine + at * POINT_WORDS));
        },
        wsplit * per, sh);
    if (threadIdx.x < 4) fe_store(out + c * 16 * f * groups + row * groups + grp, f * groups, acc);
}

extern "C" const char *bppt_fixed_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// table, out: int32 words; lane_idx, scalars: int64; all contiguous, on the current device.
extern "C" int bppt_fixed_acc(const void *table, const void *lane_idx, const void *scalars, void *out, long f,
                              long s, long s_tab, long wsplit, void *stream) {
    const long threads = wsplit * f * s;
    const unsigned blocks = (unsigned)((threads + ACC_THREADS - 1) / ACC_THREADS);
    fixed_acc_kernel<<<blocks, ACC_THREADS, 0, (cudaStream_t)stream>>>(
        (const u32 *)table, (const int64_t *)lane_idx, (const int64_t *)scalars, (u32 *)out, f, s, s_tab,
        (int)wsplit);
    return (int)cudaGetLastError();
}

// parts: int32 words; out: int64.  threads: the block size, a power of two from 32 to 512 (four lanes an
// adder; the tree halves the adders, so no other size sums right); any other is refused.
extern "C" int bppt_fixed_fold(const void *parts, void *out, long f, long s, long groups, long wsplit,
                               long threads, void *stream) {
    if (threads < 32 || threads > FOLD_MAX_THREADS || (threads & (threads - 1))) return (int)cudaErrorInvalidValue;
    fixed_fold_kernel<<<(unsigned)(f * groups), (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const u32 *)parts, (int64_t *)out, f, s, groups, (int)wsplit);
    return (int)cudaGetLastError();
}
