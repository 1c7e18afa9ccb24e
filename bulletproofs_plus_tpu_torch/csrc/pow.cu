// K4: x^((p-5)/8) = x^(2^252 - 3) for a batch of field elements, the
// sqrt-ratio exponent of every ristretto decompression and compression
// (RFC 9496), alone (`pow_p58_kernel`) and inside the whole SQRT_RATIO_M1
// (`sqrt_ratio_m1_kernel`).
//
// Replaces the TPU kernel _pow_p58_kernel (bulletproofs_plus_tpu/ops/
// pallas_pow.py:78), which ran the same 254-step addition chain over
// (16, 128/256)-lane tiles held in VMEM.  There XLA fused the rest of
// sqrt_ratio_m1 (bulletproofs_plus_tpu/ops/ristretto.py:31) around the
// Pallas call; here nothing fuses plain torch ops, so the second entry
// carries the function to its end: v^3, v^7, the chain, the three checks of
// v r^2 against u, -u and -u sqrt(-1), the multiplication by sqrt(-1), abs.
//
// The chain, SQRT_RATIO_M1 around it, their two forms (one lane an element,
// four lanes an element; the launchers take the second up to 4224 elements)
// and what bounds them are in sqrt_ratio.cuh, which ristretto.cu (D1, C1)
// shares: there the chain runs inline, inside the whole decode and encode.
//
// `pow_p58_kernel` reads and writes the limb-major (16, n) layout,
// coalesced.  `sqrt_ratio_m1_kernel` reads and writes the callers' own
// (n, 16) layout, a 128-byte line an element, so that no transposing copy
// surrounds it, and takes u with an element stride of 0 where the caller
// broadcasts one value (u = 1, as the ristretto formulas call it).
//
// `field_mul_latency_kernel` and `field_sqr_latency_kernel` are the probe
// behind the `chain_ms` figures: every warp of one block runs a chain of
// dependent fe_mul or fe_sqr; `field4_latency_kernel` the same for the
// four-lane product and squaring of D1's chain (`fe_mul4_ns`, `fe_sqr4_ns`).  The `point*_latency_kernel`s do the same for
// the point operations, one lane a point and four lanes a point.

#include "sqrt_ratio.cuh"

#define POW_THREADS 128

// x, out: (16, n) limb-major.
template <class M>
__device__ __forceinline__ void pow_p58_body(const int64_t *__restrict__ x, int64_t *__restrict__ out, long n) {
    const Work<M> w((long)blockIdx.x * blockDim.x + threadIdx.x, n);
    if (!w.live) return;
    const fe r = fe_pow_p58(w.m, fe_load(x + w.i, n));
    if (w.stores) fe_store(out + w.i, n, r);
}

__global__ void __launch_bounds__(POW_THREADS) pow_p58_kernel(const int64_t *__restrict__ x,
                                                              int64_t *__restrict__ out, long n) {
    pow_p58_body<OneLane>(x, out, n);
}

__global__ void __launch_bounds__(POW_THREADS) pow_p58_coop_kernel(const int64_t *__restrict__ x,
                                                                   int64_t *__restrict__ out, long n) {
    pow_p58_body<FourLanes>(x, out, n);
}

// u: element i at u + i * u_stride (16 limbs, contiguous); v, r: (n, 16);
// was_square: n bytes, 0 or 1.
template <class M>
__device__ __forceinline__ void sqrt_ratio_m1_body(const int64_t *__restrict__ u_in, long u_stride,
                                                   const int64_t *__restrict__ v_in,
                                                   uint8_t *__restrict__ was_square, int64_t *__restrict__ r_out,
                                                   long n) {
    const Work<M> w((long)blockIdx.x * blockDim.x + threadIdx.x, n);
    if (!w.live) return;
    fe r;
    const bool square = fe_sqrt_ratio_m1(w.m, fe_load(u_in + w.i * u_stride, 1), fe_load(v_in + w.i * 16, 1), r);
    if (w.stores) {
        was_square[w.i] = square ? 1 : 0;
        fe_store(r_out + w.i * 16, 1, r);
    }
}

__global__ void __launch_bounds__(POW_THREADS) sqrt_ratio_m1_kernel(const int64_t *__restrict__ u, long u_stride,
                                                                    const int64_t *__restrict__ v,
                                                                    uint8_t *__restrict__ was_square,
                                                                    int64_t *__restrict__ r, long n) {
    sqrt_ratio_m1_body<OneLane>(u, u_stride, v, was_square, r, n);
}

__global__ void __launch_bounds__(POW_THREADS) sqrt_ratio_m1_coop_kernel(const int64_t *__restrict__ u,
                                                                         long u_stride,
                                                                         const int64_t *__restrict__ v,
                                                                         uint8_t *__restrict__ was_square,
                                                                         int64_t *__restrict__ r, long n) {
    sqrt_ratio_m1_body<FourLanes>(u, u_stride, v, was_square, r, n);
}

// The latency probe: every thread of one block runs `iters` dependent
// fe_mul (acc <- acc * x) or fe_sqr from x (16 limbs) and writes the end to
// out (16 limbs) so that the chain is kept.  One kernel an operation, so
// that the SASS of each holds one fe_mul or one fe_sqr and little else.
template <bool SQUARE>
__device__ __forceinline__ void field_latency_chain(const int64_t *__restrict__ x, int64_t *__restrict__ out,
                                                    int iters) {
    const fe start = fe_load(x, 1);
    fe acc = start;
#pragma unroll 1
    for (int i = 0; i < iters; ++i) acc = SQUARE ? fe_sqr(acc) : fe_mul(acc, start);
    if (threadIdx.x == 0) fe_store(out, 1, acc);
}

__global__ void __launch_bounds__(1024) field_mul_latency_kernel(const int64_t *__restrict__ x,
                                                                int64_t *__restrict__ out, int iters) {
    field_latency_chain<false>(x, out, iters);
}

__global__ void __launch_bounds__(1024) field_sqr_latency_kernel(const int64_t *__restrict__ x,
                                                                int64_t *__restrict__ out, int iters) {
    field_latency_chain<true>(x, out, iters);
}

// The same for the four-lane multiplier of sqrt_ratio.cuh (D1's and C1's chain): each group of four lanes runs
// the chain together, all holding the product.
template <bool SQUARE>
__global__ void __launch_bounds__(1024) field4_latency_kernel(const int64_t *__restrict__ x,
                                                             int64_t *__restrict__ out, int iters) {
    const FourLanes m{(int)(threadIdx.x & 3)};
    const fe start = fe_load(x, 1);
    fe acc = start;
#pragma unroll 1
    for (int i = 0; i < iters; ++i) acc = SQUARE ? m.sqr(acc) : m.mul(acc, start);
    if (threadIdx.x == 0) fe_store(out, 1, acc);
}

// The same probe for the point operations: every thread of one block runs
// `iters` dependent doublings (acc <- 2 acc) or additions (acc <- acc + p)
// from p, (4, 16) limbs, and the chain's end goes to out.  In the one-lane
// form a thread runs ge_dbl or ge_add on a whole point; in the four-lane
// form a group of four lanes runs ge_dbl4 or ge_add4 on a coordinate each.
template <bool ADD>
__global__ void __launch_bounds__(1024) point_latency_kernel(const int64_t *__restrict__ p,
                                                            int64_t *__restrict__ out, int iters) {
    const ge start = ge_load(p, 16, 1);
    ge acc = start;
#pragma unroll 1
    for (int i = 0; i < iters; ++i) acc = ADD ? ge_add(acc, start) : ge_dbl(acc);
    if (threadIdx.x == 0) ge_store(out, 16, 1, acc);
}

template <bool ADD>
__global__ void __launch_bounds__(1024) point4_latency_kernel(const int64_t *__restrict__ p,
                                                             int64_t *__restrict__ out, int iters) {
    const int c = threadIdx.x & 3;
    const fe start = fe_load(p + c * 16, 1);
    fe acc = start;
#pragma unroll 1
    for (int i = 0; i < iters; ++i) acc = ADD ? ge_add4(acc, start) : ge_dbl4(acc);
    if (threadIdx.x < 4) fe_store(out + c * 16, 1, acc);
}

extern "C" const char *bppt_pow_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static unsigned pow_blocks(bool coop, long n) { return work_blocks(coop, n, POW_THREADS); }

// x, out: (16, n) int64 limb-major, contiguous, on the current device.
// lanes: 0 picks the form from n, 1 and 4 force one.
extern "C" int bppt_pow_p58(const void *x, void *out, long n, long lanes, void *stream) {
    const bool coop = four_lanes(lanes, n);
    if (coop) {
        pow_p58_coop_kernel<<<pow_blocks(coop, n), POW_THREADS, 0, (cudaStream_t)stream>>>(
            (const int64_t *)x, (int64_t *)out, n);
    } else {
        pow_p58_kernel<<<pow_blocks(coop, n), POW_THREADS, 0, (cudaStream_t)stream>>>((const int64_t *)x,
                                                                                     (int64_t *)out, n);
    }
    return (int)cudaGetLastError();
}

// u: int64 limbs, element stride u_stride (0 or 16); v, r: (n, 16) int64; was_square: n bytes.
extern "C" int bppt_sqrt_ratio_m1(const void *u, long u_stride, const void *v, void *was_square, void *r, long n,
                                  long lanes, void *stream) {
    const bool coop = four_lanes(lanes, n);
    if (coop) {
        sqrt_ratio_m1_coop_kernel<<<pow_blocks(coop, n), POW_THREADS, 0, (cudaStream_t)stream>>>(
            (const int64_t *)u, u_stride, (const int64_t *)v, (uint8_t *)was_square, (int64_t *)r, n);
    } else {
        sqrt_ratio_m1_kernel<<<pow_blocks(coop, n), POW_THREADS, 0, (cudaStream_t)stream>>>(
            (const int64_t *)u, u_stride, (const int64_t *)v, (uint8_t *)was_square, (int64_t *)r, n);
    }
    return (int)cudaGetLastError();
}

// One block of `warps` warps (1 to 32), every thread (or group of four lanes) the same chain.  op: 0 fe_mul,
// 1 fe_sqr, 2 the four-lane product, 3 the four-lane squaring.
extern "C" int bppt_field_latency(const void *x, void *out, long op, long iters, long warps, void *stream) {
    const unsigned threads = 32u * (unsigned)warps;
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t *in = (const int64_t *)x;
    int64_t *o = (int64_t *)out;
    const int n = (int)iters;
    switch (op) {
        case 0: field_mul_latency_kernel<<<1, threads, 0, st>>>(in, o, n); break;
        case 1: field_sqr_latency_kernel<<<1, threads, 0, st>>>(in, o, n); break;
        case 2: field4_latency_kernel<false><<<1, threads, 0, st>>>(in, o, n); break;
        case 3: field4_latency_kernel<true><<<1, threads, 0, st>>>(in, o, n); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// One block of `warps` warps (1 to 32), every thread (or group of four lanes) the same chain of point
// operations.  op: 0 ge_dbl, 1 ge_add, 2 ge_dbl4, 3 ge_add4.
extern "C" int bppt_point_latency(const void *p, void *out, long op, long iters, long warps, void *stream) {
    const unsigned threads = 32u * (unsigned)warps;
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t *in = (const int64_t *)p;
    int64_t *o = (int64_t *)out;
    const int n = (int)iters;
    switch (op) {
        case 0: point_latency_kernel<false><<<1, threads, 0, st>>>(in, o, n); break;
        case 1: point_latency_kernel<true><<<1, threads, 0, st>>>(in, o, n); break;
        case 2: point4_latency_kernel<false><<<1, threads, 0, st>>>(in, o, n); break;
        case 3: point4_latency_kernel<true><<<1, threads, 0, st>>>(in, o, n); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
