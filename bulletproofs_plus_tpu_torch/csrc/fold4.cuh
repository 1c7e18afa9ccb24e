// The sum of a block's points on four-lane adders: the body that K2
// (msm.cu lane_fold_kernel) and K6 (fixed.cu fixed_fold_kernel) share.
//
// What bounds a fold: its sum is a chain of dependent additions (the rate
// and byte bounds are several times lower), so the design shortens each
// addition and the chain.  Additions are ge_add4 of field25519.cuh, 3 fe_mul
// deep instead of 9: a group of four lanes is one adder, lane c holding
// coordinate c, and a block of T threads has T / 4 adders.  Adder a loads
// point a and adds points a + T / 4, a + 2 T / 4, ... to it, with the next
// point in flight while an addition runs; then a tree sums the adders, first
// across the warps through shared memory (adder k of a warp to adder k of
// another: every lane of a warp that adds has work, where a tree inside each
// warp would leave half, then three quarters, of them idle), then three
// levels inside warp 0 by shuffles.  The block is not short of latency
// alone: at wide shapes its warps also queue for the schedulers' multiplier,
// so an addition that half the lanes waste costs time.  Adders past the
// count hold the identity, and a warp all of whose adders do skips the
// loop's additions (the condition is the same for its 32 lanes, so the
// shuffles still find whole warps).

#pragma once

#include "field25519.cuh"

#define FOLD_MAX_THREADS 512
#define FOLD_SMEM_WORDS ((FOLD_MAX_THREADS / 32) * 32 * 8)  // a coordinate a lane

// Coordinate c = threadIdx.x & 3 of the sum of points 0 .. count - 1, left in
// every lane group of warp 0.  `load(i)` returns coordinate c of point i < count.
// blockDim.x is a power of two from 32 to FOLD_MAX_THREADS (the tree halves
// the adders); `sh` holds FOLD_SMEM_WORDS words, 16-byte aligned.  Every
// thread of the block calls it.
template <class Load>
__device__ __forceinline__ fe ge4_block_sum(Load load, int count, u32 *sh) {
    const int tid = threadIdx.x, lane = tid & 31, c = tid & 3, warp = tid >> 5;
    const int a = tid >> 2, adders = blockDim.x >> 2, first_of_warp = a & ~7;
    // the first point is loaded, not added to the identity; each next one is in flight while an addition runs
    fe acc = a < count ? load(a) : ge4_identity(c);
    fe part = adders + a < count ? load(adders + a) : ge4_identity(c);
#pragma unroll 1
    for (int i0 = adders; i0 + first_of_warp < count; i0 += adders) {  // until the whole warp is past the count
        const int i = i0 + adders + a;
        const fe next = i < count ? load(i) : ge4_identity(c);
        acc = ge_add4(acc, part);
        part = next;
    }
    int n = 1;  // adders the tree sums: the power of two covering those that hold a point
    while (n < count && n < adders) n <<= 1;
    // Across the warps first, adder k of one warp to adder k of another, so that all eight adders of a warp
    // that adds have work; only then the three levels inside warp 0, where they thin out.
    for (int w = n >> 4; w >= 1; w >>= 1) {  // n / 8 warps hold points; the upper half hands its sums down
        if (warp >= w && warp < 2 * w) fe_store_words(reinterpret_cast<uint4 *>(sh + (warp * 32 + lane) * 8), acc);
        __syncthreads();
        if (warp < w) {
            acc = ge_add4(acc, fe_load_words_shared(reinterpret_cast<const uint4 *>(sh + ((warp + w) * 32 + lane) * 8)));
        }
    }
    if (warp == 0) acc = ge4_warp_sum(acc, n);
    return acc;
}
