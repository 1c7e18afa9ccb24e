// K1-K3 and K7: the dynamic multiscalar multiplication sum_i s_i * P_i with
// 4-bit windows, the final check of batch verification.
//
// Replaces the TPU kernels of bulletproofs_plus_tpu/ops/pallas_msm.py:
//   K1 _dyn_acc_kernel   (:336)  per-tile table T[d] = d*P, select T[digit]
//                                for each of 64 windows, accumulate
//   K2 _lane_fold_kernel (:422)  fold the lane axis to one point per window
//   K3 _horner_kernel    (:432)  sum_j 16^j * W_j over the 64 window sums
//   K7 _dyn_acc_signed_kernel (:340)  K1 with digits in [-8, 7]; see below
// They compute the same function; the split differs.  On the TPU the grid
// ran in order and K1 carried one (window, lane-slot) accumulator across
// tiles.  Here blocks run in parallel and in no order, so each K1 block
// writes its own 64 window partials and K2 reduces them, with no atomics.
// Windows stay in natural order (LSB first): the TPU's bit-reversed order
// only made its Horner fold contiguous.
//
// Bound on this card: operations.  A complete point addition is 9 field
// multiplications of about 128 32-bit multiply-adds each, and per lane K1
// does 14 of them for the table and 64 for the windows, against 640 bytes
// of scalar and point limbs read.  Design: a K1 block takes a tile of 16
// lanes.  Its 64 threads first build the 16 lanes' tables in shared memory,
// four threads per lane (T[1..4] by doublings, then T[d+4] = T[d] + T[4], a
// chain of 5 point operations instead of 14); then thread w owns window w
// and adds the 16 selected entries.  Table entries are padded to 33 words,
// so threads reading different digits hit different banks.  K2 gives each
// window a block that sums the K1 partials with a shared-memory tree.  K3 is
// one block on the four-lane point operations of field25519.cuh: a group of
// four lanes doubles its windows' term up to 252 times (the chain Horner
// needs anyway), then a tree sums the groups; see horner_kernel.

#include "field25519.cuh"

#define N_WINDOWS 64
#define N_DIGITS 16
#define TILE 16  // lanes per K1 block; K1 blocks have N_WINDOWS = 4 * TILE threads

// scalars: (16, n) limb-major; pts: (4, 16, n); out: (4, 16, 64, nb), nb = ceil(n / TILE).
__global__ void __launch_bounds__(N_WINDOWS) dyn_acc_kernel(const int64_t *__restrict__ scalars,
                                                            const int64_t *__restrict__ pts,
                                                            int64_t *__restrict__ out, long n, long nb) {
    __shared__ u32 tab[TILE * N_DIGITS * GE_SMEM_STRIDE];
    __shared__ u32 sc[TILE][8];
    const int tid = threadIdx.x;
    const long blk = blockIdx.x;

    // Phase 1: tables.  Thread (lane l, part k) makes T[k+1], then T[k+5],
    // T[k+9], T[k+13] by adding T[4].
    const int l = tid & (TILE - 1);
    const int k = tid / TILE;
    const long lane = blk * TILE + l;
    const bool live = lane < n;  // lanes past n: zero scalar, identity point
    ge p = live ? ge_load(pts + lane, 16 * n, n) : ge_identity();
    if (k == 0) {
        for (int q = 0; q < 8; ++q) {
            u32 lo = live ? (u32)scalars[(2 * q) * n + lane] : 0u;
            u32 hi = live ? (u32)scalars[(2 * q + 1) * n + lane] : 0u;
            sc[l][q] = lo | (hi << 16);
        }
        ge_to_smem(&tab[(l * N_DIGITS + 0) * GE_SMEM_STRIDE], ge_identity());
    }
    ge d2 = ge_dbl(p);
    ge tk;
    if (k == 0) {
        tk = p;
    } else if (k == 1) {
        tk = d2;
    } else if (k == 2) {
        tk = ge_add(d2, p);
    } else {
        tk = ge_dbl(d2);
    }
    ge_to_smem(&tab[(l * N_DIGITS + k + 1) * GE_SMEM_STRIDE], tk);
    __syncthreads();
    const ge t4 = ge_from_smem(&tab[(l * N_DIGITS + 4) * GE_SMEM_STRIDE]);
#pragma unroll 1
    for (int d = k + 5; d < N_DIGITS; d += 4) {
        tk = ge_add(tk, t4);
        ge_to_smem(&tab[(l * N_DIGITS + d) * GE_SMEM_STRIDE], tk);
    }
    __syncthreads();

    // Phase 2: thread w sums T_l[digit_w(s_l)] over the tile's lanes.
    const int w = tid;
    const int word = w >> 3, shift = 4 * (w & 7);
    ge acc = ge_from_smem(&tab[((sc[0][word] >> shift) & 15) * GE_SMEM_STRIDE]);
#pragma unroll 1
    for (int j = 1; j < TILE; ++j) {
        int digit = (sc[j][word] >> shift) & 15;
        acc = ge_add(acc, ge_from_smem(&tab[(j * N_DIGITS + digit) * GE_SMEM_STRIDE]));
    }
    ge_store(out + (long)w * nb + blk, 16L * N_WINDOWS * nb, (long)N_WINDOWS * nb, acc);
}

#define N_SIGNED 9  // signed-digit table: identity, P .. 8P

// Entry for signed digit d = nibble - 8 in [-8, 7]: |d| * P from the lane's
// table, with x and t negated where d < 0 (fe_neg returns a value below
// 2^256, which is all the complete addition asks of its inputs).
__device__ __forceinline__ ge signed_select(const u32 *tab_lane, u32 nibble) {
    const int d = (int)nibble - 8;
    ge e = ge_from_smem(&tab_lane[(d < 0 ? -d : d) * GE_SMEM_STRIDE]);
    if (d < 0) {
        e.x = fe_neg(e.x);
        e.t = fe_neg(e.t);
    }
    return e;
}

// K7, replacing _dyn_acc_signed_kernel (:340): dyn_acc_kernel with the
// scalar recoded to signed digits d_j in [-8, 7], sum_j d_j 16^j = s.  The
// recoding is the constant-add of ops/msm.signed_digits4, done here in the
// prologue: nibble j of s + 0x88..8 is d_j + 8, and a scalar below 2^253
// (every canonical scalar) cannot carry out of the top nibble.  The table
// per lane shrinks to 8 multiples (19 KB of shared memory instead of 34),
// built by a chain of depth 3 (2P; 3P, 4P; then T[d + 4] = T[d] + 4P).
// Same arguments and output as dyn_acc_kernel.
__global__ void __launch_bounds__(N_WINDOWS) dyn_acc_signed_kernel(const int64_t *__restrict__ scalars,
                                                                   const int64_t *__restrict__ pts,
                                                                   int64_t *__restrict__ out, long n, long nb) {
    __shared__ u32 tab[TILE * N_SIGNED * GE_SMEM_STRIDE];
    __shared__ u32 sc[TILE][8];
    const int tid = threadIdx.x;
    const long blk = blockIdx.x;

    const int l = tid & (TILE - 1);
    const int k = tid / TILE;
    const long lane = blk * TILE + l;
    const bool live = lane < n;  // lanes past n: zero scalar (all digits 0), identity point
    ge p = live ? ge_load(pts + lane, 16 * n, n) : ge_identity();
    if (k == 0) {
        u64 c = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            u32 lo = live ? (u32)scalars[(2 * q) * n + lane] : 0u;
            u32 hi = live ? (u32)scalars[(2 * q + 1) * n + lane] : 0u;
            c += (u64)(lo | (hi << 16)) + 0x88888888u;
            sc[l][q] = (u32)c;
            c >>= 32;
        }
        ge_to_smem(&tab[(l * N_SIGNED + 0) * GE_SMEM_STRIDE], ge_identity());
    }
    ge d2 = ge_dbl(p);
    ge tk;
    if (k == 0) {
        tk = p;
    } else if (k == 1) {
        tk = d2;
    } else if (k == 2) {
        tk = ge_add(d2, p);
    } else {
        tk = ge_dbl(d2);
    }
    ge_to_smem(&tab[(l * N_SIGNED + k + 1) * GE_SMEM_STRIDE], tk);
    __syncthreads();
    tk = ge_add(tk, ge_from_smem(&tab[(l * N_SIGNED + 4) * GE_SMEM_STRIDE]));
    ge_to_smem(&tab[(l * N_SIGNED + k + 5) * GE_SMEM_STRIDE], tk);
    __syncthreads();

    const int w = tid;
    const int word = w >> 3, shift = 4 * (w & 7);
    ge acc = signed_select(&tab[0], (sc[0][word] >> shift) & 15);
#pragma unroll 1
    for (int j = 1; j < TILE; ++j) {
        acc = ge_add(acc, signed_select(&tab[j * N_SIGNED * GE_SMEM_STRIDE], (sc[j][word] >> shift) & 15));
    }
    ge_store(out + (long)w * nb + blk, 16L * N_WINDOWS * nb, (long)N_WINDOWS * nb, acc);
}

#define FOLD_THREADS 128

// parts: (4, 16, 64, nb) -> out: (4, 16, 64); one block per window.
__global__ void __launch_bounds__(FOLD_THREADS) lane_fold_kernel(const int64_t *__restrict__ parts,
                                                                 int64_t *__restrict__ out, long nb) {
    __shared__ u32 sh[FOLD_THREADS * GE_SMEM_STRIDE];
    const int tid = threadIdx.x;
    const long w = blockIdx.x;
    const long limb_stride = (long)N_WINDOWS * nb;
    ge acc = ge_identity();
#pragma unroll 1
    for (long b = tid; b < nb; b += FOLD_THREADS) {
        acc = ge_add(acc, ge_load(parts + w * nb + b, 16 * limb_stride, limb_stride));
    }
    ge_to_smem(&sh[tid * GE_SMEM_STRIDE], acc);
    __syncthreads();
#pragma unroll 1
    for (int s = FOLD_THREADS / 2; s > 0; s >>= 1) {
        if (tid < s) {
            acc = ge_add(acc, ge_from_smem(&sh[(tid + s) * GE_SMEM_STRIDE]));
            ge_to_smem(&sh[tid * GE_SMEM_STRIDE], acc);
        }
        __syncthreads();
    }
    if (tid == 0) ge_store(out + w, 16 * N_WINDOWS, N_WINDOWS, acc);
}

#define HORNER_CHUNK 8                              // neighbouring windows a lane group
#define HORNER_GROUPS (N_WINDOWS / HORNER_CHUNK)    // eight groups of four lanes: one warp

// wsum: (4, 16, 64) window sums W_j, LSB window first -> out: (4, 16, 1) = sum_j 16^j W_j.
//
// What bounds it: the 252 doublings that 16^63 W_63 needs from a point known
// only at run time, one after another; beside them the work is nothing (its
// rate bound is some 16 ns).  So the design shortens each doubling and keeps
// everything else off its path.  One warp: the 64 windows are cut into eight
// chunks of eight neighbours, a chunk to a group of four lanes (ge_dbl4,
// ge_add4: a doubling 1 fe_sqr + 1 fe_mul deep instead of 4 + 4).  Group g
// runs Horner's rule over its own windows from the top (seven times four
// doublings and an addition), doubles the result 32 g times, and three tree
// levels by shuffles sum the groups: 28 + 224 doublings and 7 + 3 additions
// deep.  Every group loops to the longest count and the shorter ones keep
// their value behind a select, so that the shuffles always find the whole
// warp.  More warps shorten the additions (four warps: 1 + 5 deep) but read
// no faster: they need shared memory and a barrier, and the compiler guards
// every shuffle of a block whose warps part ways with a WARPSYNC.
__global__ void __launch_bounds__(4 * HORNER_GROUPS, 1)
    horner_kernel(const int64_t *__restrict__ wsum, int64_t *__restrict__ out) {
    const int tid = threadIdx.x, c = tid & 3;
    const int g = tid >> 2;  // this group's chunk
    const int64_t *mine = wsum + c * 16 * N_WINDOWS + g * HORNER_CHUNK;  // coordinate c of the chunk's windows
    fe acc = fe_load(mine + HORNER_CHUNK - 1, N_WINDOWS);
#pragma unroll 1
    for (int i = HORNER_CHUNK - 2; i >= 0; --i) {
#pragma unroll 1
        for (int k = 0; k < 4; ++k) acc = ge_dbl4(acc);
        acc = ge_add4(acc, fe_load(mine + i, N_WINDOWS));
    }
    const int own = 4 * HORNER_CHUNK * g;
#pragma unroll 1
    for (int i = 0; i < 4 * HORNER_CHUNK * (HORNER_GROUPS - 1); ++i) acc = fe_select(i < own, ge_dbl4(acc), acc);
    acc = ge4_warp_sum(acc, HORNER_GROUPS);
    if (tid < 4) fe_store(out + c * 16, 1, acc);
}

extern "C" const char *bppt_msm_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// All arrays int64, contiguous, on the current device.
extern "C" int bppt_dyn_acc(const void *scalars, const void *pts, void *out, long n, long nb, void *stream) {
    dyn_acc_kernel<<<(unsigned)nb, N_WINDOWS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)scalars, (const int64_t *)pts, (int64_t *)out, n, nb);
    return (int)cudaGetLastError();
}

extern "C" int bppt_dyn_acc_signed(const void *scalars, const void *pts, void *out, long n, long nb, void *stream) {
    dyn_acc_signed_kernel<<<(unsigned)nb, N_WINDOWS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)scalars, (const int64_t *)pts, (int64_t *)out, n, nb);
    return (int)cudaGetLastError();
}

extern "C" int bppt_lane_fold(const void *parts, void *out, long nb, void *stream) {
    lane_fold_kernel<<<N_WINDOWS, FOLD_THREADS, 0, (cudaStream_t)stream>>>((const int64_t *)parts,
                                                                          (int64_t *)out, nb);
    return (int)cudaGetLastError();
}

extern "C" int bppt_horner(const void *wsum, void *out, void *stream) {
    horner_kernel<<<1, 4 * HORNER_GROUPS, 0, (cudaStream_t)stream>>>((const int64_t *)wsum, (int64_t *)out);
    return (int)cudaGetLastError();
}
