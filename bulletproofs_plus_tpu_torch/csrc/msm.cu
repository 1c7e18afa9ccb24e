// K1-K3: the dynamic multiscalar multiplication sum_i s_i * P_i with 4-bit
// windows, the final check of batch verification.
//
// Replaces the TPU kernels of bulletproofs_plus_tpu/ops/pallas_msm.py:
//   K1 _dyn_acc_kernel   (:336)  per-tile table T[d] = d*P, select T[digit]
//                                for each of 64 windows, accumulate
//   K2 _lane_fold_kernel (:422)  fold the lane axis to one point per window
//   K3 _horner_kernel    (:432)  sum_j 16^j * W_j over the 64 window sums
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
// one block: thread j doubles W_j 4j times (at most 252 doublings, the
// chain Horner needs anyway), then a 6-level tree sums the 64 terms.

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

// wsum: (4, 16, 64) window sums W_j, LSB window first -> out: (4, 16, 1) = sum_j 16^j W_j.
__global__ void __launch_bounds__(N_WINDOWS) horner_kernel(const int64_t *__restrict__ wsum,
                                                           int64_t *__restrict__ out) {
    __shared__ u32 sh[N_WINDOWS * GE_SMEM_STRIDE];
    const int j = threadIdx.x;
    ge acc = ge_load(wsum + j, 16 * N_WINDOWS, N_WINDOWS);
#pragma unroll 1
    for (int i = 0; i < 4 * j; ++i) acc = ge_dbl(acc);
    ge_to_smem(&sh[j * GE_SMEM_STRIDE], acc);
    __syncthreads();
#pragma unroll 1
    for (int s = N_WINDOWS / 2; s > 0; s >>= 1) {
        if (j < s) {
            acc = ge_add(acc, ge_from_smem(&sh[(j + s) * GE_SMEM_STRIDE]));
            ge_to_smem(&sh[j * GE_SMEM_STRIDE], acc);
        }
        __syncthreads();
    }
    if (j == 0) ge_store(out, 16, 1, acc);
}

extern "C" const char *bppt_msm_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// All arrays int64, contiguous, on the current device.
extern "C" int bppt_dyn_acc(const void *scalars, const void *pts, void *out, long n, long nb, void *stream) {
    dyn_acc_kernel<<<(unsigned)nb, N_WINDOWS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)scalars, (const int64_t *)pts, (int64_t *)out, n, nb);
    return (int)cudaGetLastError();
}

extern "C" int bppt_lane_fold(const void *parts, void *out, long nb, void *stream) {
    lane_fold_kernel<<<N_WINDOWS, FOLD_THREADS, 0, (cudaStream_t)stream>>>((const int64_t *)parts,
                                                                          (int64_t *)out, nb);
    return (int)cudaGetLastError();
}

extern "C" int bppt_horner(const void *wsum, void *out, void *stream) {
    horner_kernel<<<1, N_WINDOWS, 0, (cudaStream_t)stream>>>((const int64_t *)wsum, (int64_t *)out);
    return (int)cudaGetLastError();
}
