// T1: the batched prover's Fiat-Shamir on the card, one launch a phase, a
// warp a proof.
//
// Replaces no Pallas kernel: its counterpart is the traced sponge inside the
// JAX package's fused prover `_prover_fn_core`
// (bulletproofs_plus_tpu/models/prover_device.py:134-160: `validate_append`,
// `challenge`, `build_rng`, `draw_not_zero`, and `F.inv_l` of y and each
// e).  A prove runs rounds + 2 phases: after A, after each round's L and R,
// after A1 and B.  A phase appends its points with the identity check,
// rebuilds the transcript RNG from the pre-squeeze state (a clone, rekeyed
// with the lane's witness bytes, finalized with the phase's pre-drawn
// external block), draws the masks the prover needs before the next
// challenge, squeezes the challenges (y and z, or e), reduces every draw
// and challenge mod l, inverts y or e, and writes each scalar straight into
// the limb tensor that P1-P3 read (prover.cu), the state back in place and
// the phase's flags: 1 an appended point was all zeroes, 2 a challenge
// reduced to zero, 4 a draw did.
//
// The sponge is R1's (sponge.cuh): the host (ops/cuda_transcript.py) records
// each phase's op sequence once a shape and sponge position with the same
// recording STROBE, and the RNG's clone lives in a second register of each
// lane (SAVE, SWAP).  The warp's row in shared memory is the phase's points
// as bytes (from the canonical limbs the double-and-encode wrote), the
// lane's witness bytes and its external block.
//
// What bounds it on this card: latency, not rate.  A 64-bit, degree-1 prove
// is some 50 permutations over 8 phases and 7 inversions, one warp a proof:
// the card's integer rate would do the work some thousand times sooner.  A
// phase's chain is its permutations (`perm_ns` each) and its inversion
// (`sc_inv_var_ns`).  After the last op lane c reduces output c (scalar_l.cuh
// `sc_reduce_fold`), all of a phase's draws and challenges side by side; then
// the warp inverts y or e together, in variable time (scalar_l.cuh
// `sc_inv_l_var`: divsteps four at a time from a table in shared memory, each
// batch's update a limb a lane): the challenges are public, so the time their
// inversion takes tells nothing.  S1 keeps `sc_inv_l_warp`, a value a lane.
//
// `// T1 phase:` comments mark the parts that scripts/profile_torch_p2.py
// --kernel transcript stamps.

#include "sponge.cuh"

#define T1_MAX_OUTS 32

// Output j of a proof: 16 int64 limbs at ptr[j] + proof * stride[j].  Outputs 0 .. n_wide - 1 are the reduced
// draws and challenges in the program's order; then the inverses, in the order of inv_mask's bits.
struct T1Outs {
    int64_t *ptr[T1_MAX_OUTS];
    long stride[T1_MAX_OUTS];
};

struct T1Layout {
    long jump, prog, pool, warp0, row, out, warp_bytes, total;
};

// Shared memory: DS_JUMP4 where the phase inverts (8 KB), the program, its pool, then each warp's row and outputs.
__host__ __device__ __forceinline__ T1Layout t1_layout(long n_ops, long pool_words, long stride, long n_out,
                                                       long warps, bool inverts) {
    T1Layout s;
    s.jump = 0;
    s.prog = inverts ? (long)sizeof(DsJump4) : 0;
    s.pool = s.prog + 8 * n_ops;
    s.warp0 = s.pool + PAD_FRONT + 8 * pool_words + PAD_BACK;
    s.row = 0;
    s.out = PAD_FRONT + round8(stride) + PAD_BACK;
    s.warp_bytes = s.out + round8(n_out);
    s.total = s.warp0 + warps * s.warp_bytes;
    return s;
}

// state: (batch, 25) words, read and written in place; points: (batch, n_points, 16) int64 canonical limbs;
// witness: (batch, witness_len) bytes; block: (batch, 32) bytes or null (a phase without an RNG); blob: the
// program's n_ops ops then pool_words words of pool; flags: a byte a proof, flags_stride apart.
__global__ void prove_transcript_kernel(uint64_t *__restrict__ state, const int64_t *__restrict__ points,
                                        int n_points, const uint8_t *__restrict__ witness, int witness_len,
                                        const uint8_t *__restrict__ block, long stride,
                                        const uint64_t *__restrict__ blob, int n_ops, int pool_words, int n_wide,
                                        int n_draws, u32 inv_mask, const __grid_constant__ T1Outs outs, uint8_t *__restrict__ flags,
                                        long flags_stride, long batch) {
    extern __shared__ __align__(16) uint8_t smem[];
    // T1 phase: start
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const T1Layout lay = t1_layout(n_ops, pool_words, stride, WIDE_BYTES * n_wide, warps, inv_mask != 0u);
    unsigned long long *jump = reinterpret_cast<unsigned long long *>(smem + lay.jump);
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
        if (inv_mask != 0u) ds_jump4_copy(jump);  // in flight through the sponge
        uint8_t *dst = row + PAD_FRONT;
        const int64_t *pts = points + proof * n_points * 16;
        for (int j = lane; j < 16 * n_points; j += 32) {  // limb j of a point is its bytes 2j and 2j + 1
            const int64_t v = __ldg(pts + j);
            dst[2 * j] = (uint8_t)v;
            dst[2 * j + 1] = (uint8_t)(v >> 8);
        }
        dst += 32 * n_points;
        for (int j = lane; j < witness_len; j += 32) dst[j] = __ldg(witness + proof * witness_len + j);
        if (block != nullptr) dst[witness_len + lane] = __ldg(block + proof * 32 + lane);
    }
    __syncthreads();
    if (proof >= batch) return;  // a whole warp: the ragged last block's spare warps
    // T1 phase: prologue

    const WarpKeccak k = warp_keccak_lane(lane);
    uint64_t a = lane < STATE_WORDS ? state[proof * STATE_WORDS + lane] : 0ull, s = 0ull;
    bool bad = false;
    sponge_run<true>(reinterpret_cast<const int2 *>(prog_words), n_ops, a, s, row, smem + lay.pool, out, bad, k,
                     lane);
    if (lane < STATE_WORDS) state[proof * STATE_WORDS + lane] = a;
    __syncwarp();
    // T1 phase: sponge

    // the epilogue: lane c reduces output c mod l; then the warp inverts the outputs of inv_mask, one at a time
    u32 r[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    bool zero_draw = false, zero_challenge = false;
    if (lane < n_wide) {
        const u32 *x = reinterpret_cast<const u32 *>(out + WIDE_BYTES * lane);
        u32 wide[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) wide[j] = x[j];
        sc_reduce_fold(wide, r);
        u32 any = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) any |= r[j];
        zero_draw = lane < n_draws && any == 0u;
        zero_challenge = lane >= n_draws && any == 0u;
        sponge_store_limbs(outs.ptr[lane] + proof * outs.stride[lane], r);
    }
    // T1 phase: reduce
    if (inv_mask != 0u) ds_jump4_wait();
    for (u32 left = inv_mask; left != 0u; left &= left - 1u) {  // y or e, the warp together for each
        const int c = __ffs(left) - 1;
        u32 inv[8];
        sc_inv_l_var(r, c, inv, jump);
        if (lane == c) {
            const int j = n_wide + __popc(inv_mask & ((1u << c) - 1u));
            sponge_store_limbs(outs.ptr[j] + proof * outs.stride[j], inv);
        }
    }
    // T1 phase: invert
    zero_draw = __any_sync(FULL_MASK, zero_draw);
    zero_challenge = __any_sync(FULL_MASK, zero_challenge);
    if (lane == 0) flags[proof * flags_stride] = (bad ? 1 : 0) | (zero_challenge ? 2 : 0) | (zero_draw ? 4 : 0);
    // T1 phase: flags
}

// `sc_inv_var_ns`'s probe: a warp a value (block i, value i), `iters` dependent inversions by sc_inv_l_var, each
// but the first of the value plus the last inverse (mod l): acc = x, then acc = inv(acc) and, between two
// inversions, acc = acc + x.  One value is one warp, as T1 inverts.
__global__ void transcript_inv_latency_kernel(const int64_t *in, int64_t *out, int iters) {
    __shared__ __align__(16) unsigned long long jump[1024];
    ds_jump4_copy(jump);
    ds_jump4_wait();
    u32 x[8], acc[8];
    load_limbs(in + 16 * blockIdx.x, x);
    copy8(acc, x);
    for (int k = 0; k < iters; ++k) {
        if (k) sc_add_l(acc, x, acc);
        sc_inv_l_var(acc, 0, acc, jump);
    }
    if (threadIdx.x == 0) store_limbs(out + 16 * blockIdx.x, acc);
}

extern "C" const char *bppt_transcript_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static cudaError_t transcript_allow_smem(long bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(prove_transcript_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool transcript_args_ok(long n_ops, long pool_words, long stride, long n_wide, long warps) {
    return n_ops > 0 && n_ops < (1L << 20) && pool_words >= 0 && pool_words < (1L << 20) && stride > 0 &&
           stride < (1L << 20) && n_wide > 0 && n_wide <= 32 && warps >= 1 && warps <= MAX_WARPS;
}

// Blocks of `warps` warps that one SM holds at once, for a phase program of this size (its jump table counted).
extern "C" int bppt_transcript_occupancy(long n_ops, long pool_words, long stride, long n_wide, long warps,
                                         int *blocks) {
    if (!transcript_args_ok(n_ops, pool_words, stride, n_wide, warps)) return (int)cudaErrorInvalidValue;
    const long smem = t1_layout(n_ops, pool_words, stride, WIDE_BYTES * n_wide, warps, true).total;
    const cudaError_t st = transcript_allow_smem(smem);
    if (st != cudaSuccess) return (int)st;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, prove_transcript_kernel, 32 * (int)warps, smem);
}

// state: (batch, 200) bytes, 8-byte aligned, in place; points: (batch, n_points, 16) int64; witness: (batch,
// witness_len) bytes; block: (batch, 32) bytes or null; blob: the program; out_ptrs, out_strides: n_outs host
// values (n_wide scalars, then one inverse for each bit of inv_mask); flags: a byte a proof, flags_stride apart.
// All tensors on the current device.
extern "C" int bppt_prove_transcript(void *state, const void *points, long n_points, const void *witness,
                                     long witness_len, const void *block, const void *blob, long n_ops,
                                     long pool_words, long n_wide, long n_draws, long inv_mask,
                                     const void *const *out_ptrs, const long *out_strides, long n_outs, void *flags,
                                     long flags_stride, long batch, long warps, void *stream) {
    const long stride = 32 * n_points + witness_len + 32;
    if (batch <= 0 || n_points < 0 || witness_len < 0 || !transcript_args_ok(n_ops, pool_words, stride, n_wide, warps) ||
        n_draws < 0 || n_draws > n_wide || inv_mask < 0 || inv_mask >= (1L << n_wide) ||
        (inv_mask & ((1L << n_draws) - 1)) != 0 ||  // a draw is a secret mask: only challenges take sc_inv_l_var
        n_outs != n_wide + __builtin_popcountl(inv_mask) || n_outs > T1_MAX_OUTS)
        return (int)cudaErrorInvalidValue;
    T1Outs outs;
    for (long j = 0; j < T1_MAX_OUTS; ++j) {
        outs.ptr[j] = j < n_outs ? (int64_t *)out_ptrs[j] : nullptr;
        outs.stride[j] = j < n_outs ? out_strides[j] : 0;
    }
    const long smem = t1_layout(n_ops, pool_words, stride, WIDE_BYTES * n_wide, warps, inv_mask != 0).total;
    const cudaError_t st = transcript_allow_smem(smem);
    if (st != cudaSuccess) return (int)st;
    prove_transcript_kernel<<<(unsigned)((batch + warps - 1) / warps), 32 * (unsigned)warps, smem,
                              (cudaStream_t)stream>>>(
        (uint64_t *)state, (const int64_t *)points, (int)n_points, (const uint8_t *)witness, (int)witness_len,
        (const uint8_t *)block, stride, (const uint64_t *)blob, (int)n_ops, (int)pool_words, (int)n_wide,
        (int)n_draws, (u32)inv_mask, outs, (uint8_t *)flags, flags_stride, batch);
    return (int)cudaGetLastError();
}

// in, out: (n, 16) int64 limbs, canonical; a one-warp block a value.
extern "C" int bppt_transcript_inv_latency(const void *in, void *out, long n, long iters, void *stream) {
    if (n <= 0 || n >= (1L << 24) || iters < 0 || iters >= (1L << 24)) return (int)cudaErrorInvalidValue;
    transcript_inv_latency_kernel<<<(unsigned)n, 32, 0, (cudaStream_t)stream>>>((const int64_t *)in, (int64_t *)out,
                                                                                (int)iters);
    return (int)cudaGetLastError();
}
