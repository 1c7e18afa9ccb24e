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
// multiplications of about 128 32-bit multiply-adds each; per lane the
// table takes 14 point operations and the windows 64 additions, against
// 640 bytes of scalar and point limbs read.
//
// K1's design.  A block takes a tile of `tile` lanes (the wrapper picks it
// from n: see below) and has 256 threads, capped at 128 registers so that
// two blocks share an SM: 16 warps, four a scheduler, where a lone warp
// would wait out each multiplication's latency.  It first builds the tile's
// tables T[d] = d*P in shared memory in four levels:
//   1: T2 = 2 T1;  2: T3 = T2 + T1, T4 = 2 T2;
//   3: T[5 + j] = T4 + T[1 + j], j < 3, and T8 = 2 T4;
//   4: T[9 + j] = T8 + T[1 + j], j < 7.
// Levels 1 and 2 have a few warps' work, so there each operation's latency
// is the time: they run on the four-lane ge_dbl4 and ge_add4, a third of
// it.  Levels 3 and 4 keep many warps busy and run one thread a point (a
// four-lane operation issues 1.8 times the instructions).  No warp splits
// between an addition and a doubling: the doublings take warps of their
// own, and a level's additions are (entry, lane) jobs laid flat over the
// first warps.
// Then thread (q, w), q the quarter and w the window, sums the selected
// entries T_l[digit_w(s_l)] of lanes l = q, q + 4, q + 8, ..., and a group
// of four lanes a window adds the quarters, (Q0 + Q1) + (Q2 + Q3), on
// ge_add4: for a tile of 18 lanes 4 + 4 + 2 point operations deep (four of
// them over four lanes).  Quarters are warp-major (warps 2q and 2q + 1 hold
// quarter q), so no warp of the window phase parts.  A lane's table is 16
// entries of 33 words plus one: with that odd stride the 32 lanes of a
// table level hit 32 banks, and in the window phase, where a warp reads one
// lane's table, different digits fall in different banks and equal digits
// are one broadcast.
//
// The tile width sets the grid.  The wrapper reads the card's SM count and,
// through bppt_msm_occupancy, the K1 blocks an SM holds (two on an H100,
// where the register cap allows two), and takes the narrowest tile from 16
// lanes whose blocks the card holds all at once: on an H100 18 lanes for
// the 4736 of a 256-proof verify, 264 blocks, one wave, where 16-lane tiles
// make 296 blocks, 32 of them a second wave.  Tiles below 16 lanes do not
// pay: where they would fill an SM's second block (the 2048 lanes of a
// 64 x m4 verify at 8 lanes), K2's extra partials cost what K1 gains.
// Wider tiles move window additions from K2 into K1 and back: the two
// together always add 64 (n - 1) points.
//
// The hand-off.  K1 writes each tile's 64 window partials as 32 packed
// words a point (128 bytes, one line a thread, a quarter of int64 limbs),
// window major, (64, tiles, 32), which is the (rows, partials) layout of K6's input.
// K2 is then K6's fold (fold4.cuh) with a window a row: a block sums a
// window's partials on four-lane adders.  K3 is one block on the four-lane
// point operations of field25519.cuh: a group of four lanes doubles its
// windows' term up to 252 times (the chain Horner needs anyway), then a
// tree sums the groups; see horner_kernel.

#include "fold4.cuh"

#define N_WINDOWS 64
#define N_DIGITS 16
#define POINT_WORDS 32
#define K1_THREADS 256                               // K1's and K7's blocks
#define K1_MIN_BLOCKS 2                              // blocks an SM: caps K1 and K7 at 65536 / (2 * 256) = 128 registers
#define K1_QUARTERS (K1_THREADS / N_WINDOWS)         // threads a window
#define MAX_TILE 32                                  // a table doubling takes one warp of lanes
#define LANE_WORDS (N_DIGITS * GE_SMEM_STRIDE + 1)   // a lane's table, an odd stride
#define K1_TREE_WORDS (K1_THREADS * GE_SMEM_STRIDE)  // the quarters' sums, in the table's room
#define N_SIGNED 9                                   // K7's table: the identity, P .. 8P
#define K7_LANE_WORDS (N_SIGNED * GE_SMEM_STRIDE)    // 297 words, odd without a pad word

// Dynamic shared memory of a K1 or K7 block: `tile` lane tables of `lane_words` (or the quarters' sums, where
// those take more), then the tile's scalars, eight words a lane.
__host__ __device__ constexpr int msm_smem_words(int tile, int lane_words) {
    return (tile * lane_words > K1_TREE_WORDS ? tile * lane_words : K1_TREE_WORDS) + tile * 8;
}

// One coordinate (8 of a point's 33 words) in shared memory, as a four-lane operation holds it.
__device__ __forceinline__ fe fe_from_smem(const u32 *s) {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = s[k];
    return r;
}
__device__ __forceinline__ void fe_to_smem(u32 *s, const fe &a) {
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = a.w[k];
}

// Entries of one lane's table (`row`): T[dst] = T[a] + T[b], and T[dst] = 2 T[a].
__device__ __forceinline__ void table_add(u32 *row, int dst, int a, int b) {
    ge_to_smem(row + dst * GE_SMEM_STRIDE,
               ge_add(ge_from_smem(row + a * GE_SMEM_STRIDE), ge_from_smem(row + b * GE_SMEM_STRIDE)));
}
__device__ __forceinline__ void table_dbl(u32 *row, int dst, int a) {
    ge_to_smem(row + dst * GE_SMEM_STRIDE, ge_dbl(ge_from_smem(row + a * GE_SMEM_STRIDE)));
}

// The tile's scalars into `sc`, eight packed words a lane: lane l of warp 0 for tile lane l (lanes past n: zero).
// K7 recodes as it loads (`recode`): s + 0x88..8, whose nibble j is the signed digit d_j + 8 (ops/msm.py
// signed_digits4); a scalar below 2^253, as every canonical one is, cannot carry out of the top nibble.
__device__ __forceinline__ void load_scalars(u32 *sc, const int64_t *__restrict__ scalars, long n, long blk, int tile,
                                             bool recode) {
    const int tid = threadIdx.x;
    if (tid < tile) {
        const long lane = blk * tile + tid;
        const bool live = lane < n;
        u64 c = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const u32 lo = live ? (u32)scalars[(2 * q) * n + lane] : 0u;
            const u32 hi = live ? (u32)scalars[(2 * q + 1) * n + lane] : 0u;
            c += (u64)(lo | (hi << 16)) + (recode ? 0x88888888u : 0u);
            sc[tid * 8 + q] = (u32)c;
            c >>= 32;
        }
    }
}

// The tables' levels 1 and 2, shared by K1 and K7 (a lane's table `lane_words` apart), on four-lane point
// operations: lane group g = tid / 4 for tile lane g (in level 2 counted from the group's half), lane c of the
// group for coordinate c.  Only a few warps work here and each waits out its operation's latency, which four
// lanes cut to a third.  A warp's eight groups run one operation in one control flow, as the shuffles need;
// groups past the tile run it on the identity (level 1) or on lane 0's entries (level 2) and store nothing.
// Ends on a barrier: T0 .. T4 stored.
__device__ __forceinline__ void table_levels_12(u32 *smem, int lane_words, const int64_t *__restrict__ pts, long n,
                                                long blk, int tile) {
    const int tid = threadIdx.x, warp = tid >> 5;
    const int g = tid >> 2, c = tid & 3;
    const int half = (tile + 7) / 8;  // warps that cover the tile's lanes, four lanes each
    if (warp < half) {  // level 1: T0 the identity, T1 = P (lanes past n: the identity), T2 = 2P
        const long lane = blk * tile + g;
        const bool mine = g < tile;
        const fe p = mine && lane < n ? fe_load(pts + c * 16 * n + lane, n) : ge4_identity(c);
        const fe p2 = ge_dbl4(p);
        if (mine) {
            u32 *r = smem + g * lane_words + c * 8;
            fe_to_smem(r, ge4_identity(c));
            fe_to_smem(r + GE_SMEM_STRIDE, p);
            fe_to_smem(r + 2 * GE_SMEM_STRIDE, p2);
        }
    }
    __syncthreads();
    if (warp < 2 * half) {  // level 2: T3 = T2 + T1 in the first half of the warps, T4 = 2 T2 in the second
        const bool adds = warp < half;
        const int gl = adds ? g : g - 8 * half;
        const bool mine = gl < tile;
        u32 *r = smem + (mine ? gl : 0) * lane_words + c * 8;
        const fe t2 = fe_from_smem(r + 2 * GE_SMEM_STRIDE);
        fe t;
        if (adds) {
            t = ge_add4(t2, fe_from_smem(r + GE_SMEM_STRIDE));
        } else {
            t = ge_dbl4(t2);
        }
        if (mine) fe_to_smem(r + (adds ? 3 : 4) * GE_SMEM_STRIDE, t);
    }
    __syncthreads();
}

// The window phase's end, shared by K1 and K7: thread (q, w) holds its quarter's sum for window w; a group of
// four lanes a window adds the quarters on ge_add4, (Q0 + Q1) + (Q2 + Q3), and stores the tile's partial as
// packed words.  Every warp adds, so the shuffles find whole warps.
__device__ __forceinline__ void quarters_sum_store(u32 *smem, const ge &acc, u32 *__restrict__ out, int nb,
                                                   long blk) {
    const int tid = threadIdx.x, g = tid >> 2, c = tid & 3;
    __syncthreads();  // every table read: the room takes the quarters' sums
    ge_to_smem(smem + tid * GE_SMEM_STRIDE, acc);
    __syncthreads();
    const u32 *qs = smem + g * GE_SMEM_STRIDE + c * 8;  // coordinate c of quarter 0's sum for window g
    const int qstride = N_WINDOWS * GE_SMEM_STRIDE;
    const fe lo = ge_add4(fe_from_smem(qs), fe_from_smem(qs + qstride));
    const fe hi = ge_add4(fe_from_smem(qs + 2 * qstride), fe_from_smem(qs + 3 * qstride));
    fe_store_words(reinterpret_cast<uint4 *>(out + ((long)g * nb + blk) * POINT_WORDS + c * 8), ge_add4(lo, hi));
}

// scalars: (16, n) limb-major; pts: (4, 16, n); out: (64, nb, 32) words,
// nb = ceil(n / tile), tile from 1 to MAX_TILE; dynamic shared memory
// msm_smem_words(tile, LANE_WORDS) words.
__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS)
    dyn_acc_kernel(const int64_t *__restrict__ scalars, const int64_t *__restrict__ pts, u32 *__restrict__ out,
                   long n, int tile, int nb) {
    extern __shared__ u32 smem[];
    u32 *const sc = smem + msm_smem_words(tile, LANE_WORDS) - tile * 8;
    const int tid = threadIdx.x, warp = tid >> 5, l = tid & 31;
    const long blk = blockIdx.x;
    load_scalars(sc, scalars, n, blk, tile, false);
    table_levels_12(smem, LANE_WORDS, pts, n, blk, tile);
    // levels 3 and 4: the additions are jobs (entry, lane) laid flat over the first warps, so that a tile of
    // 18 lanes fills four warps for level 4 and not seven halves; level 3's doubling takes the warp after
    const int adds3 = (3 * tile + 31) / 32;  // warps of level 3's additions
    if (tid < 3 * tile) table_add(smem + (tid % tile) * LANE_WORDS, 5 + tid / tile, 4, 1 + tid / tile);
    if (warp == adds3 && l < tile) table_dbl(smem + l * LANE_WORDS, 8, 4);
    __syncthreads();
    if (tid < 7 * tile) table_add(smem + (tid % tile) * LANE_WORDS, 9 + tid / tile, 8, 1 + tid / tile);
    __syncthreads();

    // The windows: thread (q, w) sums T_l[digit_w(s_l)] over lanes l = q, q + 4, ...
    const int w = tid & (N_WINDOWS - 1), q = tid / N_WINDOWS;
    const int word = w >> 3, shift = 4 * (w & 7);
    ge acc = ge_identity();
    if (q < tile) {
        acc = ge_from_smem(smem + q * LANE_WORDS + ((sc[q * 8 + word] >> shift) & 15) * GE_SMEM_STRIDE);
#pragma unroll 1
        for (int j = q + K1_QUARTERS; j < tile; j += K1_QUARTERS) {
            const int digit = (sc[j * 8 + word] >> shift) & 15;
            acc = ge_add(acc, ge_from_smem(smem + j * LANE_WORDS + digit * GE_SMEM_STRIDE));
        }
    }
    quarters_sum_store(smem, acc, out, nb, blk);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------
//
// K7, replacing _dyn_acc_signed_kernel (:340): K1's function with each
// scalar recoded to signed digits d_j in [-8, 7], sum_j d_j 16^j = s, so that
// a lane's table holds 9 entries (the identity, P .. 8P) and not 16.  Bound
// as K1 by operations: the window additions, 64 (n - tiles) of them, and a
// table half as deep.
//
// The design is K1's (256 threads, two blocks an SM, the tile width from
// the card's occupancy, quarters, packed partials for K2), with three
// differences.  The recoding is done as the scalars are loaded (add
// 0x88..8).  The table is three levels deep: 2P; then 3P and 4P, both on the
// four-lane operations as in K1; then T[4 + j] = 4P + T[j] for j = 1 .. 4,
// (entry, lane) jobs laid flat over the first warps.  And the table is then
// rewritten in the cached form (Y + X, Y - X, 2d T, 2 Z), one product an
// entry, so that a window addition takes 8 products and not 9
// (ge_add_cached_signed).  A negative digit costs no subtraction chain: -Q =
// (-X, Y, Z, -T) swaps Y + X with Y - X, which the addition reads from
// shared memory at swapped offsets, and turns C = T1 2d T2 into -C, which
// swaps F = D - C with G = D + C, two selects.  A quarter's first entry
// becomes an extended point by one product (cached_to_ge).  A lane's table
// is 9 x 33 = 297 words, an odd stride without a pad word.  The same kernel
// on the extended table (9 products an addition, Y2 - X2 and Y2 + X2 formed
// and selected by the sign) read 3-4% slower on an H100 and took 128
// registers with 64 bytes of spill, where this form takes 120 and none.

// 1/d and -1/d mod p, d = -121665/121666: a cached entry's 2d T back to 2T, with the digit's sign.
__device__ __forceinline__ fe fe_inv_d() {
    fe r;
    r.w[0] = 0xcdc9f843u; r.w[1] = 0x25e0f276u; r.w[2] = 0x4279542eu; r.w[3] = 0x0b5dd698u;
    r.w[4] = 0xcdb9cf66u; r.w[5] = 0x2b162114u; r.w[6] = 0x14d5ce43u; r.w[7] = 0x40907ed2u;
    return r;
}
__device__ __forceinline__ fe fe_minus_inv_d() {
    fe r;
    r.w[0] = 0x323607aau; r.w[1] = 0xda1f0d89u; r.w[2] = 0xbd86abd1u; r.w[3] = 0xf4a22967u;
    r.w[4] = 0x32463099u; r.w[5] = 0xd4e9deebu; r.w[6] = 0xeb2a31bcu; r.w[7] = 0x3f6f812du;
    return r;
}

// A table entry in place, extended (X, Y, Z, T) -> cached (Y + X, Y - X, 2d T, 2 Z).
__device__ __forceinline__ void entry_to_cached(u32 *e) {
    const ge p = ge_from_smem(e);
    fe_to_smem(e, fe_add(p.y, p.x));
    fe_to_smem(e + 8, fe_sub(p.y, p.x));
    fe_to_smem(e + 2 * 8, fe_mul(p.t, fe_d2()));
    fe_to_smem(e + 3 * 8, fe_add(p.z, p.z));
}

// The cached entry of nibble v = d + 8 in lane table `row`: |d| P's, read with its Y + X and Y - X swapped
// where d < 0, which makes them -|d| P's (its 2d T keeps the wrong sign).  `yp_at`: the offset to read Y + X at.
__device__ __forceinline__ const u32 *signed_entry(const u32 *row, u32 nibble, bool &neg, int &yp_at) {
    neg = nibble < 8u;
    yp_at = neg ? 8 : 0;
    return row + (int)(neg ? 8u - nibble : nibble - 8u) * GE_SMEM_STRIDE;
}

// d P as an extended point from the cached table: (2X : 2Y : 2Z : 2T) by one product.
__device__ __forceinline__ ge cached_to_ge(const u32 *row, u32 nibble) {
    bool neg;
    int yp_at;
    const u32 *e = signed_entry(row, nibble, neg, yp_at);
    const fe yp = fe_from_smem(e + yp_at), ym = fe_from_smem(e + 8 - yp_at);
    ge r;
    r.x = fe_sub(yp, ym);
    r.y = fe_add(yp, ym);
    r.z = fe_from_smem(e + 3 * 8);
    r.t = fe_mul(fe_from_smem(e + 2 * 8), fe_select(neg, fe_minus_inv_d(), fe_inv_d()));
    return r;
}

// p + d P, d the nibble's signed digit: add-2008-hwcd-3 (ge_add's formulas) on a cached second operand, 8
// products.  For d < 0 the entry's Y + X and Y - X are read swapped and F and G trade places.
__device__ __forceinline__ ge ge_add_cached_signed(const ge &p, const u32 *row, u32 nibble) {
    bool neg;
    int yp_at;
    const u32 *e = signed_entry(row, nibble, neg, yp_at);
    const fe a = fe_mul(fe_sub(p.y, p.x), fe_from_smem(e + 8 - yp_at));
    const fe b = fe_mul(fe_add(p.y, p.x), fe_from_smem(e + yp_at));
    const fe c = fe_mul(p.t, fe_from_smem(e + 2 * 8));
    const fe d = fe_mul(p.z, fe_from_smem(e + 3 * 8));
    const fe ee = fe_sub(b, a), h = fe_add(b, a);
    const fe dc = fe_sub(d, c), ds = fe_add(d, c);
    const fe f = fe_select(neg, ds, dc), g = fe_select(neg, dc, ds);
    ge r;
    r.x = fe_mul(ee, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = fe_mul(ee, h);
    return r;
}

// scalars, pts, out as K1's; dynamic shared memory msm_smem_words(tile, K7_LANE_WORDS) words.
__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS)
    dyn_acc_signed_kernel(const int64_t *__restrict__ scalars, const int64_t *__restrict__ pts, u32 *__restrict__ out,
                          long n, int tile, int nb) {
    extern __shared__ u32 smem[];
    u32 *const sc = smem + msm_smem_words(tile, K7_LANE_WORDS) - tile * 8;
    const int tid = threadIdx.x;
    const long blk = blockIdx.x;
    load_scalars(sc, scalars, n, blk, tile, true);
    table_levels_12(smem, K7_LANE_WORDS, pts, n, blk, tile);
    // level 3: T[5 + j] = T4 + T[1 + j], j < 4, (entry, lane) jobs laid flat over the first warps
    if (tid < 4 * tile) table_add(smem + (tid % tile) * K7_LANE_WORDS, 5 + tid / tile, 4, 1 + tid / tile);
    __syncthreads();
    // T1 .. T8 rewritten in the cached form, a job (entry, lane) a thread; T0 the identity's, (1, 1, 0, 2)
    if (tid < 8 * tile) entry_to_cached(smem + (tid % tile) * K7_LANE_WORDS + (1 + tid / tile) * GE_SMEM_STRIDE);
    if (tid < tile) {
        u32 *e = smem + tid * K7_LANE_WORDS;
        fe two = fe_zero();
        two.w[0] = 2u;
        fe_to_smem(e, fe_one());
        fe_to_smem(e + 8, fe_one());
        fe_to_smem(e + 2 * 8, fe_zero());
        fe_to_smem(e + 3 * 8, two);
    }
    __syncthreads();

    // The windows: thread (q, w) sums d_w(s_l) P_l over lanes l = q, q + 4, ...
    const int w = tid & (N_WINDOWS - 1), q = tid / N_WINDOWS;
    const int word = w >> 3, shift = 4 * (w & 7);
    ge acc = ge_identity();
    if (q < tile) {
        acc = cached_to_ge(smem + q * K7_LANE_WORDS, (sc[q * 8 + word] >> shift) & 15u);
#pragma unroll 1
        for (int j = q + K1_QUARTERS; j < tile; j += K1_QUARTERS)
            acc = ge_add_cached_signed(acc, smem + j * K7_LANE_WORDS, (sc[j * 8 + word] >> shift) & 15u);
    }
    quarters_sum_store(smem, acc, out, nb, blk);
}

// K2, replacing _lane_fold_kernel (:422): parts (64, nb, 32) words -> out
// (4, 16, 64) int64 limbs, a block a window summing its nb partials on the
// four-lane adders of fold4.cuh (K6's fold, a window a row).  The wrapper
// sizes the block from nb as it does K6's.
__global__ void __launch_bounds__(FOLD_MAX_THREADS, 1) lane_fold_kernel(const u32 *__restrict__ parts,
                                                                        int64_t *__restrict__ out, int nb) {
    __shared__ __align__(16) u32 sh[FOLD_SMEM_WORDS];
    const int c = threadIdx.x & 3;
    const u32 *mine = parts + (long)blockIdx.x * nb * POINT_WORDS + c * 8;  // coordinate c of the window's partials
    const fe acc = ge4_block_sum(
        [&](int i) { return fe_load_words(reinterpret_cast<const uint4 *>(mine + (long)i * POINT_WORDS)); }, nb, sh);
    if (threadIdx.x < 4) fe_store(out + c * 16 * N_WINDOWS + blockIdx.x, N_WINDOWS, acc);
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
//
// The tail (I1 folded in): where `identity` is given, thread 0 writes whether
// the sum is the identity, X or Y 0 mod p as ristretto.cu's is_identity_kernel
// decides it (ops/ristretto.py:95-103): lanes 0 (X) and 1 (Y) each take their
// coordinate's canonical form, one shuffle joins the two tests.  The point is
// written all the same.
__global__ void __launch_bounds__(4 * HORNER_GROUPS, 1)
    horner_kernel(const int64_t *__restrict__ wsum, int64_t *__restrict__ out, uint8_t *__restrict__ identity) {
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
    if (identity != nullptr) {
        const bool zero = fe_is_zero(acc);
        const bool y_zero = __shfl_down_sync(0xffffffffu, zero, 1);  // lane 0 reads lane 1's: Y
        if (tid == 0) *identity = zero || y_zero;
    }
}

extern "C" const char *bppt_msm_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// Above 48 KB a block's dynamic shared memory must be allowed first: once a process and kernel, for the widest tile.
static cudaError_t msm_allow_smem(int kernel) {
    static const cudaError_t k1 = cudaFuncSetAttribute(dyn_acc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                       msm_smem_words(MAX_TILE, LANE_WORDS) * (int)sizeof(u32));
    static const cudaError_t k7 = cudaFuncSetAttribute(
        dyn_acc_signed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        msm_smem_words(MAX_TILE, K7_LANE_WORDS) * (int)sizeof(u32));
    return kernel == 0 ? k1 : k7;
}

static bool tile_ok(long n, long tile, long nb) {
    return tile >= 1 && tile <= MAX_TILE && nb == (n + tile - 1) / tile;
}

// scalars, pts: int64 limbs; out: int32 words; all contiguous, on the current device.  tile: 1 to MAX_TILE.
extern "C" int bppt_dyn_acc(const void *scalars, const void *pts, void *out, long n, long tile, long nb,
                            void *stream) {
    if (!tile_ok(n, tile, nb)) return (int)cudaErrorInvalidValue;
    const cudaError_t allowed = msm_allow_smem(0);
    if (allowed != cudaSuccess) return (int)allowed;
    dyn_acc_kernel<<<(unsigned)nb, K1_THREADS, msm_smem_words((int)tile, LANE_WORDS) * sizeof(u32),
                     (cudaStream_t)stream>>>((const int64_t *)scalars, (const int64_t *)pts, (u32 *)out, n, (int)tile,
                                             (int)nb);
    return (int)cudaGetLastError();
}

// K7, with K1's arguments and refusals.
extern "C" int bppt_dyn_acc_signed(const void *scalars, const void *pts, void *out, long n, long tile, long nb,
                                   void *stream) {
    if (!tile_ok(n, tile, nb)) return (int)cudaErrorInvalidValue;
    const cudaError_t allowed = msm_allow_smem(2);
    if (allowed != cudaSuccess) return (int)allowed;
    dyn_acc_signed_kernel<<<(unsigned)nb, K1_THREADS, msm_smem_words((int)tile, K7_LANE_WORDS) * sizeof(u32),
                            (cudaStream_t)stream>>>((const int64_t *)scalars, (const int64_t *)pts, (u32 *)out, n,
                                                    (int)tile, (int)nb);
    return (int)cudaGetLastError();
}

// Blocks of a kernel that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks: kernel 0 is K1 and 2 is K7, each at a tile of `tile` lanes (its dynamic shared memory); 1 is K2 at
// `threads`.
extern "C" int bppt_msm_occupancy(long kernel, long threads, long tile, int *blocks) {
    if (kernel == 0 || kernel == 2) {
        if (tile < 1 || tile > MAX_TILE) return (int)cudaErrorInvalidValue;
        const cudaError_t allowed = msm_allow_smem((int)kernel);
        if (allowed != cudaSuccess) return (int)allowed;
        if (kernel == 0)
            return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                blocks, dyn_acc_kernel, K1_THREADS, msm_smem_words((int)tile, LANE_WORDS) * sizeof(u32));
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, dyn_acc_signed_kernel, K1_THREADS, msm_smem_words((int)tile, K7_LANE_WORDS) * sizeof(u32));
    }
    if (kernel == 1) return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, lane_fold_kernel, threads, 0);
    return (int)cudaErrorInvalidValue;
}

// parts: int32 words; out: int64.  threads: a power of two from 32 to FOLD_MAX_THREADS; any other is refused.
extern "C" int bppt_lane_fold(const void *parts, void *out, long nb, long threads, void *stream) {
    if (threads < 32 || threads > FOLD_MAX_THREADS || (threads & (threads - 1))) return (int)cudaErrorInvalidValue;
    lane_fold_kernel<<<N_WINDOWS, (unsigned)threads, 0, (cudaStream_t)stream>>>((const u32 *)parts, (int64_t *)out,
                                                                               (int)nb);
    return (int)cudaGetLastError();
}

// identity: one byte, or null for the point alone.
extern "C" int bppt_horner(const void *wsum, void *out, void *identity, void *stream) {
    horner_kernel<<<1, 4 * HORNER_GROUPS, 0, (cudaStream_t)stream>>>((const int64_t *)wsum, (int64_t *)out,
                                                                     (uint8_t *)identity);
    return (int)cudaGetLastError();
}
