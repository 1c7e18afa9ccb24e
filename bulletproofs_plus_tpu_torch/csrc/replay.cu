// R1: the batch verifier's Fiat-Shamir replay, one thread a proof.
//
// Replaces no Pallas kernel: its counterpart is the XLA program `replay_fn`
// (bulletproofs_plus_tpu/models/replay_device.py:101), the Merlin/STROBE-128
// transcript of one proof shape traced over the sponge of utils/jkeccak.py
// and utils/jstrobe.py.  It computes the same function: from each proof's
// transcript state and its packed row of bytes (commitments, minimum values,
// A, A1, B, L, R, r1, s1, d1), the 64-byte wide challenges y, z, e_1..e_k, e,
// the 32-byte seed of the batch-weight transcript, and whether an appended
// A, L, R, A1 or B was the identity's encoding (all zeroes).
//
// What is static.  For a fixed proof shape the transcript's op sequence --
// labels, lengths, framing, and so every sponge position, begin marker and
// flag -- is the same on every lane; only the data bytes differ.  The host
// (ops/cuda_replay.py) runs that sequence once through a recording STROBE
// and hands the kernel the result: a byte program of packed 32-bit ops
//   kind << 24 | position in the state << 16 | argument
// with the kinds below.  Every lane executes the same program, so control
// flow is uniform across the warp and no lane waits on another.
//
// What bounds it on this card: latency, not rate.  A 64-bit, m=1 proof runs
// 14 Keccak-f[1600] permutations of 24 rounds and 1,641 byte operations, all
// one after another in one thread, and a 256-proof batch is 8 warps, one on
// each of 8 SMs: the card's integer rate would finish the same work some
// three hundred times sooner (PERF.md).  Two chains add up: the
// permutations (a one-warp probe times each), and the byte program's loop,
// whose every op waits on its program word, a row byte and a shared-memory
// byte.  Design: the 25-word state lives in shared memory while the byte
// operations edit it (a thread's words at stride 32, so a warp touches
// consecutive words), and in registers as 64-bit lanes for each
// permutation, which is the unrolled textbook round.  Later work: a warp a
// proof (lanes holding state words, theta by shuffles), and byte ops merged
// into word ops where a message fills whole words.
//
// `keccak_latency_kernel` is the probe behind R1's `chain_ms`: one warp, a
// chain of dependent permutations.

#include <cstdint>
#include <cuda_runtime.h>

#define REPLAY_THREADS 32

enum ReplayOp { OP_PERMUTE = 0, OP_XOR_CONST = 1, OP_XOR_DATA = 2, OP_SET_CONST = 3, OP_TAKE = 4, OP_CHECK_ZERO = 5 };

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL, 0x8000000080008000ULL,
    0x000000000000808BULL, 0x0000000080000001ULL, 0x8000000080008081ULL, 0x8000000000008009ULL,
    0x000000000000008AULL, 0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
    0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800AULL, 0x800000008000000AULL,
    0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

// Keccak-f[1600] on 25 lanes a[x + 5y] held in registers.
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

// state_in: (B, 25) 64-bit words (the (B, 200) byte states); buf: (B, stride) bytes; prog: n_ops packed ops;
// out: (B, n_out) bytes, every TAKE's byte at its argument; bad_identity: B bytes.
__global__ void __launch_bounds__(REPLAY_THREADS) replay_kernel(
    const uint64_t *__restrict__ state_in, const uint8_t *__restrict__ buf, long stride,
    const int32_t *__restrict__ prog, int n_ops, uint8_t *__restrict__ out, long n_out,
    uint8_t *__restrict__ bad_identity, long batch) {
    __shared__ uint64_t st[25][REPLAY_THREADS];
    const long lane = (long)blockIdx.x * REPLAY_THREADS + threadIdx.x;
    if (lane >= batch) return;  // no lane reads another's state: the rest of the warp goes on alone
    const int t = threadIdx.x;
#pragma unroll
    for (int w = 0; w < 25; ++w) st[w][t] = state_in[lane * 25 + w];
    const uint8_t *row = buf + lane * stride;
    uint8_t *o = out + lane * n_out;
    bool bad = false;
    for (int i = 0; i < n_ops; ++i) {
        const int32_t op = __ldg(prog + i);
        const int kind = op >> 24, pos = (op >> 16) & 0xFF, arg = op & 0xFFFF;
        uint8_t *sb = reinterpret_cast<uint8_t *>(&st[pos >> 3][t]) + (pos & 7);
        switch (kind) {
            case OP_XOR_CONST: *sb ^= (uint8_t)arg; break;
            case OP_XOR_DATA: *sb ^= row[arg]; break;
            case OP_SET_CONST: *sb = (uint8_t)arg; break;
            case OP_TAKE:
                o[arg] = *sb;
                *sb = 0;
                break;
            case OP_CHECK_ZERO: {
                uint8_t any = 0;
#pragma unroll
                for (int k = 0; k < 32; ++k) any |= row[arg + k];
                bad |= any == 0;
                break;
            }
            default: {  // OP_PERMUTE
                uint64_t a[25];
#pragma unroll
                for (int w = 0; w < 25; ++w) a[w] = st[w][t];
                keccak_f1600(a);
#pragma unroll
                for (int w = 0; w < 25; ++w) st[w][t] = a[w];
            }
        }
    }
    bad_identity[lane] = bad;
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

extern "C" const char *bppt_replay_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// state: (batch, 200) bytes, 8-byte aligned; buf: (batch, stride) bytes; prog: n_ops int32; out: (batch, n_out)
// bytes; bad: batch bytes.  All on the current device.
extern "C" int bppt_replay(const void *state, const void *buf, long stride, const void *prog, long n_ops, void *out,
                           long n_out, void *bad, long batch, void *stream) {
    if (batch <= 0 || n_ops <= 0 || n_ops > (1L << 30)) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((batch + REPLAY_THREADS - 1) / REPLAY_THREADS);
    replay_kernel<<<blocks, REPLAY_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint64_t *)state, (const uint8_t *)buf, stride, (const int32_t *)prog, (int)n_ops, (uint8_t *)out,
        n_out, (uint8_t *)bad, batch);
    return (int)cudaGetLastError();
}

// in, out: 25 64-bit words.
extern "C" int bppt_keccak_latency(const void *in, void *out, long iters, void *stream) {
    keccak_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint64_t *)in, (uint64_t *)out, (int)iters);
    return (int)cudaGetLastError();
}
