// K4: x^((p-5)/8) = x^(2^252 - 3) for a batch of field elements, the
// sqrt-ratio exponent of every ristretto decompression (RFC 9496).
//
// Replaces the TPU kernel _pow_p58_kernel (bulletproofs_plus_tpu/ops/
// pallas_pow.py:78), which ran the same 254-step addition chain over
// (16, 128/256)-lane tiles held in VMEM.
//
// Bound on this card: operations.  Each element needs 252 squarings and 11
// multiplications in a strict chain, about 128 32-bit multiply-adds each,
// against 8 bytes of limbs in and out per 16-bit limb: far above the card's
// ratio of integer rate to memory rate.  Design: one thread per element
// (elements are independent), the whole chain in registers, no shared
// memory; the only memory traffic is one read of x and one write of the
// result, both coalesced over the limb-major (16, n) layout.  The 254 steps
// are sequential within a thread, so throughput comes from the number of
// elements in flight; the loops stay rolled to keep the code small.

#include "field25519.cuh"

__device__ __forceinline__ fe fe_sqr_n(fe x, int n) {
#pragma unroll 1
    for (int i = 0; i < n; ++i) x = fe_sqr(x);
    return x;
}

__global__ void __launch_bounds__(128) pow_p58_kernel(const int64_t *__restrict__ x, int64_t *__restrict__ out,
                                                      long n) {
    long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    fe v = fe_load(x + i, n);
    fe z2 = fe_sqr(v);
    fe z9 = fe_mul(v, fe_sqr_n(z2, 2));
    fe z11 = fe_mul(z2, z9);
    fe z_5_0 = fe_mul(z9, fe_sqr(z11));
    fe z_10_0 = fe_mul(fe_sqr_n(z_5_0, 5), z_5_0);
    fe z_20_0 = fe_mul(fe_sqr_n(z_10_0, 10), z_10_0);
    fe z_40_0 = fe_mul(fe_sqr_n(z_20_0, 20), z_20_0);
    fe z_50_0 = fe_mul(fe_sqr_n(z_40_0, 10), z_10_0);
    fe z_100_0 = fe_mul(fe_sqr_n(z_50_0, 50), z_50_0);
    fe z_200_0 = fe_mul(fe_sqr_n(z_100_0, 100), z_100_0);
    fe z_250_0 = fe_mul(fe_sqr_n(z_200_0, 50), z_50_0);
    fe_store(out + i, n, fe_mul(fe_sqr_n(z_250_0, 2), v));
}

extern "C" const char *bppt_pow_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

// x, out: (16, n) int64 limb-major, contiguous, on the current device.
extern "C" int bppt_pow_p58(const void *x, void *out, long n, void *stream) {
    const int threads = 128;
    long blocks = (n + threads - 1) / threads;
    pow_p58_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>((const int64_t *)x, (int64_t *)out, n);
    return (int)cudaGetLastError();
}
