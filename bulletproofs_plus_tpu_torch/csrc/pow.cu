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
// Bound on this card: the chain.  An element needs 251 squarings and 11
// multiplications one after another, and the callers bring 128 to 4100
// elements: at one thread an element that is at most one warp on each of an
// SM's four schedulers, so the time is 262 times what one warp takes for a
// squaring, whatever the card could do beside it (the rate bound is some
// ten times lower).  A lone warp spends about two thirds of that time
// issuing the squaring's wide multiply-adds, which go through the
// scheduler's one multiplier at a quarter of the lane rate; the rest is
// carry arithmetic.
//
// Design: the whole chain in registers on the carry-flag arithmetic of
// field25519.cuh, no shared memory, the loops rolled to keep the code small,
// in two forms of one template.
//   One lane an element: a thread owns an element.  The form for many
//   elements, where every scheduler has several warps anyway.
//   Four lanes an element: lane t multiplies by words 2t and 2t + 1 of the
//   second operand, two rows of the product, so a warp issues 16 + 8 wide
//   multiply-adds a step instead of 43 + 8; two rounds of shuffles add the
//   four partial products at their offsets in the group's first lane, which
//   folds the sum and hands the result back to the other three.  A step has
//   more to issue in all, but a quarter of the multiplier's time, and
//   with at most 4224 elements (eight a warp, one warp on each of the 528
//   schedulers) nothing else wants that scheduler.  The launchers take this
//   form up to that count.
// `pow_p58_kernel` reads and writes the limb-major (16, n) layout,
// coalesced.  `sqrt_ratio_m1_kernel` reads and writes the callers' own
// (n, 16) layout, a 128-byte line an element, so that no transposing copy
// surrounds it, and takes u with an element stride of 0 where the caller
// broadcasts one value (u = 1 in compress and decompress).
//
// `field_mul_latency_kernel` and `field_sqr_latency_kernel` are the probe
// behind the `chain_ms` figures: every warp of one block runs a chain of
// dependent fe_mul or fe_sqr.  The `point*_latency_kernel`s do the same for
// the point operations, one lane a point and four lanes a point.

#include "field25519.cuh"

#define POW_THREADS 128
#define COOP_MAX_N 4224  // 132 SMs x 4 schedulers x 8 elements a warp

// The multiplier of the one-lane form: the header's own.
struct OneLane {
    __device__ __forceinline__ fe mul(const fe &a, const fe &b) const { return fe_mul(a, b); }
    __device__ __forceinline__ fe sqr(const fe &a) const { return fe_sqr(a); }
};

// The multiplier of the four-lane form.  All four lanes of a group hold the
// same operands and get the same product; all 32 lanes of the warp must call
// it together.
struct FourLanes {
    int t;  // this lane's place in its group, 0 to 3

    __device__ __forceinline__ fe mul(const fe &a, const fe &b) const {
        const unsigned full = 0xFFFFFFFFu;
        const u32 b0 = t == 0 ? b.w[0] : t == 1 ? b.w[2] : t == 2 ? b.w[4] : b.w[6];
        const u32 b1 = t == 0 ? b.w[1] : t == 1 ? b.w[3] : t == 2 ? b.w[5] : b.w[7];
        u32 e[16], o[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) e[k] = o[k] = 0u;
        fe_mul_row(e, o, a, b0, 0);
        fe_mul_row(e, o, a, b1, 1);
        u32 p[10];  // a * (b0 + b1 W), W = 2^32: this lane's share, to be weighed by W^(2t)
        p[0] = e[0];
        p[1] = add_cc(e[1], o[0]);
#pragma unroll
        for (int k = 2; k < 10; ++k) p[k] = addc_cc(e[k], o[k - 1]);
        u32 got[12];
#pragma unroll
        for (int k = 0; k < 10; ++k) got[k] = __shfl_down_sync(full, p[k], 1, 4);
        u32 s[12];  // p + W^2 * (the next lane's p): right in lanes 0 and 2
        s[0] = p[0];
        s[1] = p[1];
        s[2] = add_cc(p[2], got[0]);
#pragma unroll
        for (int k = 3; k < 10; ++k) s[k] = addc_cc(p[k], got[k - 2]);
        s[10] = addc_cc(0u, got[8]);
        s[11] = addc(0u, got[9]);
#pragma unroll
        for (int k = 0; k < 12; ++k) got[k] = __shfl_down_sync(full, s[k], 2, 4);
        u32 w[16];  // s + W^4 * (lane 2's s): the whole product, right in lane 0
#pragma unroll
        for (int k = 0; k < 4; ++k) w[k] = s[k];
        w[4] = add_cc(s[4], got[0]);
#pragma unroll
        for (int k = 5; k < 12; ++k) w[k] = addc_cc(s[k], got[k - 4]);
#pragma unroll
        for (int k = 12; k < 15; ++k) w[k] = addc_cc(0u, got[k - 4]);
        w[15] = addc(0u, got[11]);
        fe r = fe_fold_wide(w);
#pragma unroll
        for (int k = 0; k < 8; ++k) r.w[k] = __shfl_sync(full, r.w[k], 0, 4);
        return r;
    }
    __device__ __forceinline__ fe sqr(const fe &a) const { return mul(a, a); }
};

template <class M>
__device__ __forceinline__ fe fe_sqr_n(const M &m, fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = m.sqr(x);
    return x;
}

// v^(2^252 - 3): 251 squarings, 11 multiplications.
template <class M>
__device__ __forceinline__ fe fe_pow_p58(const M &m, const fe &v) {
    fe z2 = m.sqr(v);
    fe z9 = m.mul(v, fe_sqr_n(m, z2, 2));
    fe z11 = m.mul(z2, z9);
    fe z_5_0 = m.mul(z9, m.sqr(z11));
    fe z_10_0 = m.mul(fe_sqr_n(m, z_5_0, 5), z_5_0);
    fe z_20_0 = m.mul(fe_sqr_n(m, z_10_0, 10), z_10_0);
    fe z_40_0 = m.mul(fe_sqr_n(m, z_20_0, 20), z_20_0);
    fe z_50_0 = m.mul(fe_sqr_n(m, z_40_0, 10), z_10_0);
    fe z_100_0 = m.mul(fe_sqr_n(m, z_50_0, 50), z_50_0);
    fe z_200_0 = m.mul(fe_sqr_n(m, z_100_0, 100), z_100_0);
    fe z_250_0 = m.mul(fe_sqr_n(m, z_200_0, 50), z_50_0);
    return m.mul(fe_sqr_n(m, z_250_0, 2), v);
}

// RFC 9496 SQRT_RATIO_M1(u, v) -> was_square; r comes out canonical and
// non-negative.
template <class M>
__device__ __forceinline__ bool fe_sqrt_ratio_m1(const M &m, const fe &u, const fe &v, fe &r) {
    const fe v3 = m.mul(m.sqr(v), v);
    const fe v7 = m.mul(m.sqr(v3), v);
    r = m.mul(m.mul(u, v3), fe_pow_p58(m, m.mul(u, v7)));
    const fe check = m.mul(v, m.sqr(r));
    const fe neg_u = fe_neg(u);
    const bool correct = fe_eq(check, u);
    const bool flipped = fe_eq(check, neg_u);
    const bool flipped_i = fe_eq(check, m.mul(neg_u, fe_sqrt_m1()));
    r = fe_abs(fe_select(flipped || flipped_i, m.mul(r, fe_sqrt_m1()), r));
    return correct || flipped;
}

// Thread g of the grid -> its element and its multiplier.  In the four-lane
// form thread 4 i + t is lane t of element i; blocks are whole warps and
// every lane runs the chain (lanes past n on element n - 1, without
// storing), so that the shuffles always find their partners.
template <class M>
struct Work;
template <>
struct Work<OneLane> {
    long i;
    bool live, stores;
    OneLane m;
    __device__ __forceinline__ Work(long g, long n) : i(g), live(g < n), stores(g < n), m() {}
};
template <>
struct Work<FourLanes> {
    long i;
    bool live, stores;
    FourLanes m;
    __device__ __forceinline__ Work(long g, long n)
        : i((g >> 2) < n ? (g >> 2) : n - 1), live(true), stores((g >> 2) < n && (g & 3) == 0), m{(int)(g & 3)} {}
};

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

// Lanes an element: what the caller asks for (1 or 4), or by the count.
static bool four_lanes(long lanes, long n) { return lanes == 4 || (lanes == 0 && n <= COOP_MAX_N); }

static unsigned pow_blocks(bool coop, long n) {
    return (unsigned)(((coop ? 4 : 1) * n + POW_THREADS - 1) / POW_THREADS);
}

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

// One block of `warps` warps (1 to 32), every thread the same chain.
extern "C" int bppt_field_latency(const void *x, void *out, long op, long iters, long warps, void *stream) {
    const unsigned threads = 32u * (unsigned)warps;
    if (op == 0) {
        field_mul_latency_kernel<<<1, threads, 0, (cudaStream_t)stream>>>((const int64_t *)x, (int64_t *)out,
                                                                          (int)iters);
    } else {
        field_sqr_latency_kernel<<<1, threads, 0, (cudaStream_t)stream>>>((const int64_t *)x, (int64_t *)out,
                                                                          (int)iters);
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
