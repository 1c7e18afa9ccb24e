// The STROBE-128 sponge of a Merlin transcript across one warp, and the span
// programs that drive it: the device code of R1 (replay.cu, the verifier's
// Fiat-Shamir replay) and T1 (transcript.cu, the batched prover's).
//
// A warp holds one proof's 200-byte state, lane w < 25 its 64-bit word w, in
// registers; lanes 25-31 follow the same control flow, hold junk and write
// nothing.  The host (ops/cuda_replay.py, ops/cuda_transcript.py) runs a
// transcript's op sequence once through a recording STROBE and hands the
// kernel a span program: an op is two 32-bit words,
//   kind << 16 | position in the state << 8 | length,   argument
// one op for each run of bytes that STROBE absorbs, overwrites or squeezes
// between two permutations (the argument is its offset in the warp's row, in
// the pool of constant bytes uploaded with the program, or in the output
// row), and single ops for a permutation, an identity check and, in T1's
// programs, the second state.  Every warp runs the same program, so control
// flow is uniform.
//
// A span op is a few instructions a lane: each lane whose word the span
// overlaps takes its bytes as one 8-byte window of the source (two aligned
// shared-memory words and a funnel shift, from a padded copy of the row or of
// the pool) under a byte mask; a squeeze writes its bytes to the warp's output
// row in shared memory and zeroes them; an identity check is a ballot over 32
// row bytes.  The permutation runs across the lanes: theta's column parities
// and D by shuffles, rho as a rotation by the lane's own offset, pi and chi as
// three shuffles of the rotated words (a lane's own and its row neighbours'
// sources), iota on lane 0.
//
// T1's programs keep a second state in a second register of each lane, the
// transcript RNG's: SAVE copies the state there (the RNG builder's clone)
// and SWAP exchanges the two, so the clone's rekeying, finalization and draws
// and the transcript's own squeezes interleave as the recording ran them.
// ops/cuda_replay.py `run_ops_model` repeats every op in numpy, word for word.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "scalar_l.cuh"

#define FULL_MASK 0xffffffffu
#define STATE_WORDS 25
#define PAD_FRONT 8   // bytes before each source copy in shared memory: a window may start 7 bytes early
#define PAD_BACK 16   // bytes after it: a window's second aligned word
#define WIDE_BYTES 64
#define MAX_WARPS 32

enum SpanOp {
    OP_PERMUTE = 0,
    OP_XOR_CONST = 1,
    OP_XOR_DATA = 2,
    OP_SET_CONST = 3,
    OP_TAKE = 4,
    OP_CHECK_ZERO = 5,
    OP_SET_DATA = 6,  // T1 only: state[pos : pos + len] = row[arg : arg + len]
    OP_SAVE = 7,      // T1 only: the second state = the state
    OP_SWAP = 8,      // T1 only: exchange the state and the second state
};

__constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL, 0x8000000080008000ULL,
    0x000000000000808BULL, 0x0000000080000001ULL, 0x8000000080008081ULL, 0x8000000000008009ULL,
    0x000000000000008AULL, 0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL, 0x8000000000008003ULL,
    0x8000000000008002ULL, 0x8000000000000080ULL, 0x000000000000800AULL, 0x800000008000000AULL,
    0x8000000080008081ULL, 0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rho's rotation of word x + 5y
__constant__ uint8_t KECCAK_RHO[STATE_WORDS] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                                                25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

// ---------------------------------------------------------------------------
// The permutation across a warp: lane w < 25 holds word w = x + 5y.
// ---------------------------------------------------------------------------

struct WarpKeccak {
    int x;         // the lane's column (lanes 25-31: lane % 5, so they read real lanes and write nothing)
    int d_minus;   // lane holding column x - 1's parity
    int d_plus;    // lane holding column x + 1's parity
    int pi_src;    // pi: the lane whose rotated word lands on this lane
    int pi_chi1;   // pi then chi: the lanes whose rotated words land on words x + 1 and x + 2 of this
    int pi_chi2;   // lane's row, read straight from the rotated words (one shuffle level, not two)
    int rot_swap;  // rho: the rotation as a swap of the 32-bit halves and a funnel shift
    int rot_shift;
};

// pi: the lane whose word, rotated, lands on lane l (lanes 25-31: themselves)
__device__ __forceinline__ int pi_source(int l) { return l < STATE_WORDS ? (l % 5 + 3 * (l / 5)) % 5 + 5 * (l % 5) : l; }

__device__ __forceinline__ WarpKeccak warp_keccak_lane(int lane) {
    WarpKeccak k;
    const int x = lane % 5, y = lane / 5;
    const bool live = lane < STATE_WORDS;
    const int rot = live ? KECCAK_RHO[lane] : 0;
    k.x = x;
    k.d_minus = (x + 4) % 5;
    k.d_plus = (x + 1) % 5;
    k.pi_src = pi_source(lane);
    k.pi_chi1 = pi_source(live ? (x + 1) % 5 + 5 * y : lane);
    k.pi_chi2 = pi_source(live ? (x + 2) % 5 + 5 * y : lane);
    k.rot_swap = rot >= 32;
    k.rot_shift = rot & 31;
    return k;
}

__device__ __forceinline__ uint64_t rotl_lane(uint64_t v, const WarpKeccak &k) {
    const u32 lo = (u32)v, hi = (u32)(v >> 32);
    const u32 l = k.rot_swap ? hi : lo, h = k.rot_swap ? lo : hi;
    return ((uint64_t)__funnelshift_l(l, h, k.rot_shift) << 32) | __funnelshift_l(h, l, k.rot_shift);
}

__device__ __forceinline__ uint64_t shfl(uint64_t v, int src) { return __shfl_sync(FULL_MASK, v, src); }

// Keccak-f[1600] across the warp, every exchange a shuffle of 64-bit words:
// five for theta's column parity, two for D, and three of the rotated words
// for pi and chi at once, 20 SHFL a round in three dependent levels.  A
// one-warp probe timed the shuffles 3% below the same rounds through a slab
// of shared memory (PERF.md).
__device__ __forceinline__ void keccak_warp(uint64_t &a, const WarpKeccak &k, int lane) {
#pragma unroll 1
    for (int r = 0; r < 24; ++r) {
        const uint64_t c = shfl(a, k.x) ^ shfl(a, k.x + 5) ^ shfl(a, k.x + 10) ^ shfl(a, k.x + 15) ^
                           shfl(a, k.x + 20);
        a ^= shfl(c, k.d_minus) ^ rotl64(shfl(c, k.d_plus), 1);
        const uint64_t rotated = rotl_lane(a, k);
        const uint64_t b = shfl(rotated, k.pi_src), b1 = shfl(rotated, k.pi_chi1), b2 = shfl(rotated, k.pi_chi2);
        a = b ^ (~b1 & b2) ^ (lane == 0 ? KECCAK_RC[r] : 0ull);
    }
}

// ---------------------------------------------------------------------------
// The span ops
// ---------------------------------------------------------------------------

__host__ __device__ __forceinline__ long round8(long n) { return (n + 7) & ~7L; }

// The bytes [lo, hi) of word w's 8 (lo < hi, both within the word) as a mask.
__device__ __forceinline__ uint64_t byte_mask(int lo, int hi, int w) {
    const int nb = hi - lo;
    return (nb == 8 ? ~0ull : ((1ull << (8 * nb)) - 1)) << (8 * (lo - 8 * w));
}

// The 8 bytes of a padded source that would land on word w if the span
// [pos, pos + len) started at `arg` in the source: two aligned words and a shift.
__device__ __forceinline__ uint64_t window(const uint8_t *padded, int arg, int pos, int w) {
    const int p = PAD_FRONT + arg - pos + 8 * w;  // >= 1 where the span overlaps word w
    const uint64_t *words = reinterpret_cast<const uint64_t *>(padded);
    const int q = p >> 3, sh = 8 * (p & 7);
    return sh ? (words[q] >> sh) | (words[q + 1] << (64 - sh)) : words[q];
}

// Runs a span program on the warp's state `a` (lane w < 25 word w).  `row` and
// `pool` are padded copies in shared memory (byte i at [PAD_FRONT + i]), `out`
// the warp's output row; `bad` gathers the identity checks.  TWO_STATES (T1)
// adds the row-keyed overwrite and the second state `s`; R1's programs have
// neither, and its loop is the same code without them.
template <bool TWO_STATES>
__device__ __forceinline__ void sponge_run(const int2 *ops, int n_ops, uint64_t &a, uint64_t &s, const uint8_t *row,
                                           const uint8_t *pool, uint8_t *out, bool &bad, const WarpKeccak &k,
                                           int lane) {
    const int w = lane;  // the state word this lane holds, if below 25
    int2 next = ops[0];
    for (int i = 0; i < n_ops; ++i) {
        const int2 op = next;
        if (i + 1 < n_ops) next = ops[i + 1];
        const int kind = op.x >> 16, pos = (op.x >> 8) & 0xFF, len = op.x & 0xFF, arg = op.y;
        if (kind == OP_PERMUTE) {
            keccak_warp(a, k, lane);
            continue;
        }
        if (kind == OP_CHECK_ZERO) {
            bad |= __ballot_sync(FULL_MASK, row[PAD_FRONT + arg + lane] != 0) == 0u;
            continue;
        }
        if (TWO_STATES && kind == OP_SAVE) {
            s = a;
            continue;
        }
        if (TWO_STATES && kind == OP_SWAP) {
            const uint64_t t = a;
            a = s;
            s = t;
            continue;
        }
        const int lo = max(8 * w, pos), hi = min(8 * w + 8, pos + len);
        if (w >= STATE_WORDS || lo >= hi) continue;
        const uint64_t mask = byte_mask(lo, hi, w);
        if (kind == OP_TAKE) {
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int at = 8 * w + b;
                if (at >= lo && at < hi) out[arg + at - pos] = (uint8_t)(a >> (8 * b));
            }
            a &= ~mask;
        } else if (TWO_STATES) {
            const bool data = kind == OP_XOR_DATA || kind == OP_SET_DATA;
            const uint64_t v = window(data ? row : pool, arg, pos, w) & mask;
            a = kind == OP_SET_CONST || kind == OP_SET_DATA ? (a & ~mask) | v : a ^ v;
        } else {
            const uint64_t v = window(kind == OP_XOR_DATA ? row : pool, arg, pos, w) & mask;
            a = kind == OP_SET_CONST ? (a & ~mask) | v : a ^ v;
        }
    }
}

// A canonical scalar's 8 words -> 16 radix-2^16 int64 limbs at p.
__device__ __forceinline__ void sponge_store_limbs(int64_t *p, const u32 *r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        p[2 * j] = r[j] & 0xFFFFu;
        p[2 * j + 1] = r[j] >> 16;
    }
}
