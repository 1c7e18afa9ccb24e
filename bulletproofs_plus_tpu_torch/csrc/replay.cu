// R1: the batch verifier's Fiat-Shamir replay, a warp a proof, with the wide
// reduction of its challenges inside.
//
// Replaces no Pallas kernel: its counterpart is the XLA program `replay_fn`
// (bulletproofs_plus_tpu/models/replay_device.py:101), the Merlin/STROBE-128
// transcript of one proof shape traced over the sponge of utils/jkeccak.py
// and utils/jstrobe.py, and its reduction of each 64-byte challenge mod l.
// It computes the same function in one launch: from each proof's transcript
// state and its packed row of bytes (commitments, minimum values, A, A1, B,
// L, R, r1, s1, d1), the challenges y, z, e_1..e_k, e as canonical scalars
// (16 radix-2^16 limbs each), the 32-byte seed of the batch-weight
// transcript, whether an appended A, L, R, A1 or B was the identity's
// encoding (all zeroes), and whether a challenge reduced to zero.
//
// What is static.  For a fixed proof shape the transcript's op sequence --
// labels, lengths, framing, and so every sponge position, begin marker and
// flag -- is the same on every proof; only the data bytes differ.  The host
// (ops/cuda_replay.py) runs that sequence once through a recording STROBE
// and hands the kernel a span program: an op is two 32-bit words,
//   kind << 16 | position in the state << 8 | length,   argument
// one op for each run of bytes that STROBE absorbs, overwrites or squeezes
// between two permutations (the argument is its offset in the row, in the
// pool of constant bytes uploaded with the program, or in the output row),
// and single ops for a permutation and for an identity check.  Every warp
// runs the same program, so control flow is uniform.
//
// What bounds it on this card: latency, not rate.  A 64-bit, m=1 proof runs
// 14 Keccak-f[1600] permutations and some 70 spans one after another, and a
// 256-proof batch is 256 warps, two an SM: the card's integer rate would do
// the same work a few hundred times sooner (PERF.md).  So the design cuts the
// chain.  A warp holds one proof's state, and runs its span program, as
// sponge.cuh sets out (the sponge, the span ops and the shuffled permutation
// are T1's too, transcript.cu).  After the last op, lane c reduces challenge c mod
// l (scalar_l.cuh `sc_reduce_fold`), all of a proof's challenges side by side.  The row, the
// program and the pool are copied into shared memory once, coalesced; the
// block is as many warps as the wrapper asks (one, for a batch that the
// card holds in one wave of one-warp blocks).
//
// `perm_latency_kernel` is the probe behind R1's `chain_ms`: one warp, a
// chain of dependent permutations (`perm_ns`).  `keccak_latency_kernel` is
// the one-thread permutation of the design before this one, kept as its
// reference (`keccak_ns`).  `reduce_wide_kernel` runs only the epilogue on
// given 64-byte inputs.

#include "sponge.cuh"

// Keccak-f[1600] on 25 lanes a[x + 5y] held in one thread's registers (the one-thread reference).
__device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll 1
    for (int r = 0; r < 24; ++r) {
        uint64_t c[5], d[5], b[25];
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
        for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
        // rho and pi: lane x + 5y, rotated by its offset, moves to y + 5 ((2x + 3y) % 5)
        b[0] = a[0];
        b[1] = rotl64(a[6], 44);
        b[2] = rotl64(a[12], 43);
        b[3] = rotl64(a[18], 21);
        b[4] = rotl64(a[24], 14);
        b[5] = rotl64(a[3], 28);
        b[6] = rotl64(a[9], 20);
        b[7] = rotl64(a[10], 3);
        b[8] = rotl64(a[16], 45);
        b[9] = rotl64(a[22], 61);
        b[10] = rotl64(a[1], 1);
        b[11] = rotl64(a[7], 6);
        b[12] = rotl64(a[13], 25);
        b[13] = rotl64(a[19], 8);
        b[14] = rotl64(a[20], 18);
        b[15] = rotl64(a[4], 27);
        b[16] = rotl64(a[5], 36);
        b[17] = rotl64(a[11], 10);
        b[18] = rotl64(a[17], 15);
        b[19] = rotl64(a[23], 56);
        b[20] = rotl64(a[2], 62);
        b[21] = rotl64(a[8], 55);
        b[22] = rotl64(a[14], 39);
        b[23] = rotl64(a[15], 41);
        b[24] = rotl64(a[21], 2);
        // chi, within each row
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x) a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
        }
        a[0] ^= KECCAK_RC[r];
    }
}

// ---------------------------------------------------------------------------
// Shared memory: the program and the pool for the block, then a row and an
// output row for each warp.  Every piece starts on 8 bytes.
// ---------------------------------------------------------------------------

struct ReplayLayout {
    long prog, pool, warp0, row, out, warp_bytes, total;
};

__host__ __device__ __forceinline__ ReplayLayout replay_layout(long n_ops, long pool_words, long stride, long n_out,
                                                               long warps) {
    ReplayLayout s;
    s.prog = 0;
    s.pool = 8 * n_ops;
    s.warp0 = s.pool + PAD_FRONT + 8 * pool_words + PAD_BACK;
    s.row = 0;
    s.out = PAD_FRONT + round8(stride) + PAD_BACK;
    s.warp_bytes = s.out + round8(n_out);
    s.total = s.warp0 + warps * s.warp_bytes;
    return s;
}

// state: (batch, 25) words; buf: (batch, stride) bytes, 8-byte aligned rows; blob: the program's n_ops ops
// (two int32 each) then pool_words words of constant bytes; scalars: (batch, n_ch, 16) int64; seeds: (batch,
// n_seed) bytes; bad_identity, bad_zero: batch bytes.
__global__ void replay_kernel(const uint64_t *__restrict__ state, const uint8_t *__restrict__ buf, long stride,
                              const uint64_t *__restrict__ blob, int n_ops, int pool_words, int n_ch, int n_seed,
                              int64_t *__restrict__ scalars, uint8_t *__restrict__ seeds,
                              uint8_t *__restrict__ bad_identity, uint8_t *__restrict__ bad_zero, long batch) {
    extern __shared__ __align__(16) uint8_t smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int n_out = WIDE_BYTES * n_ch + n_seed;
    const ReplayLayout lay = replay_layout(n_ops, pool_words, stride, n_out, warps);
    // the program and the pool, once for the block
    uint64_t *prog_words = reinterpret_cast<uint64_t *>(smem + lay.prog);
    uint64_t *pool_words_s = reinterpret_cast<uint64_t *>(smem + lay.pool + PAD_FRONT);
    for (int k = threadIdx.x; k < n_ops + pool_words; k += blockDim.x) {
        const uint64_t word = __ldg(blob + k);
        if (k < n_ops)
            prog_words[k] = word;
        else
            pool_words_s[k - n_ops] = word;
    }
    const long proof = (long)blockIdx.x * warps + warp;
    uint8_t *wsm = smem + lay.warp0 + warp * lay.warp_bytes;
    uint8_t *row = wsm + lay.row;  // padded: the row's byte i at row[PAD_FRONT + i]
    uint8_t *out = wsm + lay.out;
    if (proof < batch) {
        const uint64_t *src = reinterpret_cast<const uint64_t *>(buf + proof * stride);
        uint64_t *dst = reinterpret_cast<uint64_t *>(row + PAD_FRONT);
        for (int k = lane; k < stride / 8; k += 32) dst[k] = __ldg(src + k);
    }
    __syncthreads();
    if (proof >= batch) return;  // a whole warp: the ragged last block's spare warps

    const uint8_t *pool = smem + lay.pool;
    const int2 *ops = reinterpret_cast<const int2 *>(prog_words);
    const WarpKeccak k = warp_keccak_lane(lane);
    uint64_t a = lane < STATE_WORDS ? __ldg(state + proof * STATE_WORDS + lane) : 0ull, unused = 0ull;
    bool bad = false;
    sponge_run<false>(ops, n_ops, a, unused, row, pool, out, bad, k, lane);
    __syncwarp();

    // the epilogue: lane c reduces challenge c mod l
    bool zero = false;
    for (int c = lane; c < n_ch; c += 32) {
        const u32 *x = reinterpret_cast<const u32 *>(out + WIDE_BYTES * c);
        u32 wide[16], r[8];
#pragma unroll
        for (int j = 0; j < 16; ++j) wide[j] = x[j];
        sc_reduce_fold(wide, r);
        int64_t *dst = scalars + (proof * n_ch + c) * 16;
        u32 any = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            dst[2 * j] = r[j] & 0xFFFFu;
            dst[2 * j + 1] = r[j] >> 16;
            any |= r[j];
        }
        zero |= any == 0u;
    }
    zero = __any_sync(FULL_MASK, zero);
    for (int j = lane; j < n_seed; j += 32) seeds[proof * n_seed + j] = out[WIDE_BYTES * n_ch + j];
    if (lane == 0) {
        bad_identity[proof] = bad;
        bad_zero[proof] = zero;
    }
}

// One warp, a chain of `iters` dependent permutations of in's 25 words, lane w holding word w.
__global__ void perm_latency_kernel(const uint64_t *in, uint64_t *out, int iters) {
    const int lane = threadIdx.x;
    const WarpKeccak k = warp_keccak_lane(lane);
    uint64_t a = lane < STATE_WORDS ? in[lane] : 0ull;
    for (int i = 0; i < iters; ++i) keccak_warp(a, k, lane);
    if (lane < STATE_WORDS) out[lane] = a;
}

// One warp, every thread the same chain of `iters` dependent permutations of in's 25 words.
__global__ void keccak_latency_kernel(const uint64_t *in, uint64_t *out, int iters) {
    uint64_t a[25];
#pragma unroll
    for (int w = 0; w < 25; ++w) a[w] = in[w];
    for (int i = 0; i < iters; ++i) keccak_f1600(a);
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 0; w < 25; ++w) out[w] = a[w];
    }
}

// A thread an input: in (n, 64) bytes -> out (n, 16) int64 limbs, zero n bytes.
__global__ void reduce_wide_kernel(const u32 *in, int64_t *out, uint8_t *zero, long n) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u32 wide[16], r[8], any = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) wide[j] = in[i * 16 + j];
    sc_reduce_fold(wide, r);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        out[i * 16 + 2 * j] = r[j] & 0xFFFFu;
        out[i * 16 + 2 * j + 1] = r[j] >> 16;
        any |= r[j];
    }
    zero[i] = any == 0u;
}

extern "C" const char *bppt_replay_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static cudaError_t replay_allow_smem(long bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool replay_args_ok(long n_ops, long pool_words, long stride, long n_ch, long n_seed, long warps) {
    return n_ops > 0 && n_ops < (1L << 20) && pool_words >= 0 && pool_words < (1L << 20) && stride > 0 &&
           stride % 8 == 0 && stride < (1L << 20) && n_ch >= 0 && n_seed >= 0 && n_ch + n_seed > 0 &&
           WIDE_BYTES * n_ch + n_seed < (1L << 20) && warps >= 1 && warps <= MAX_WARPS;
}

// Blocks of `warps` warps that one SM holds at once, for a program of this size.
extern "C" int bppt_replay_occupancy(long n_ops, long pool_words, long stride, long n_ch, long n_seed, long warps,
                                     int *blocks) {
    if (!replay_args_ok(n_ops, pool_words, stride, n_ch, n_seed, warps)) return (int)cudaErrorInvalidValue;
    const long smem = replay_layout(n_ops, pool_words, stride, WIDE_BYTES * n_ch + n_seed, warps).total;
    const cudaError_t st = replay_allow_smem(smem);
    if (st != cudaSuccess) return (int)st;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, replay_kernel, 32 * (int)warps, smem);
}

// state: (batch, 200) bytes, 8-byte aligned; buf: (batch, stride) bytes, 8-byte aligned; blob: the program
// (n_ops ops, pool_words words of pool); scalars: (batch, n_ch, 16) int64; seeds: (batch, n_seed) bytes;
// bad_identity, bad_zero: batch bytes.  All on the current device.
extern "C" int bppt_replay(const void *state, const void *buf, long stride, const void *blob, long n_ops,
                           long pool_words, long n_ch, long n_seed, void *scalars, void *seeds, void *bad_identity,
                           void *bad_zero, long batch, long warps, void *stream) {
    if (batch <= 0 || !replay_args_ok(n_ops, pool_words, stride, n_ch, n_seed, warps))
        return (int)cudaErrorInvalidValue;
    const long smem = replay_layout(n_ops, pool_words, stride, WIDE_BYTES * n_ch + n_seed, warps).total;
    const cudaError_t st = replay_allow_smem(smem);
    if (st != cudaSuccess) return (int)st;
    replay_kernel<<<(unsigned)((batch + warps - 1) / warps), 32 * (unsigned)warps, smem, (cudaStream_t)stream>>>(
        (const uint64_t *)state, (const uint8_t *)buf, stride, (const uint64_t *)blob, (int)n_ops, (int)pool_words,
        (int)n_ch, (int)n_seed, (int64_t *)scalars, (uint8_t *)seeds, (uint8_t *)bad_identity, (uint8_t *)bad_zero,
        batch);
    return (int)cudaGetLastError();
}

// in, out: 25 64-bit words.
extern "C" int bppt_perm_latency(const void *in, void *out, long iters, void *stream) {
    perm_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint64_t *)in, (uint64_t *)out, (int)iters);
    return (int)cudaGetLastError();
}

// in, out: 25 64-bit words.
extern "C" int bppt_keccak_latency(const void *in, void *out, long iters, void *stream) {
    keccak_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint64_t *)in, (uint64_t *)out, (int)iters);
    return (int)cudaGetLastError();
}

// in: (n, 64) bytes, 4-byte aligned; out: (n, 16) int64; zero: n bytes.
extern "C" int bppt_reduce_wide(const void *in, void *out, void *zero, long n, void *stream) {
    if (n <= 0) return (int)cudaErrorInvalidValue;
    reduce_wide_kernel<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        (const u32 *)in, (int64_t *)out, (uint8_t *)zero, n);
    return (int)cudaGetLastError();
}
