// D1, C1 and I1: ristretto255 decoding, encoding and the identity check
// (RFC 9496) for a batch of points, each a whole function in one launch.
//
// Replaces what XLA fused around the TPU kernel K4 (_pow_p58_kernel,
// bulletproofs_plus_tpu/ops/pallas_pow.py:78) in the JAX package's jitted
// programs:
//   D1 `decompress_kernel`: `decompress_batch` (bulletproofs_plus_tpu/models/
//      verifier_kernels.py:263) -> ops/ristretto.py:68 `decompress`;
//   C1 `compress_kernel`: ops/ristretto.py:47 `compress`, inside the fused
//      prover (bulletproofs_plus_tpu/models/prover_device.py:182, 293, 384);
//      on the port's prover path since the halved tables, C1's double-and-encode
//      `double_compress_kernel` (below) in its place;
//   I1 `is_identity_kernel`: ops/ristretto.py:103 `is_identity`, the closing
//      check of `final_msm_is_identity`, `mixed_msm_is_identity` and
//      `combine_groups_msm` (verifier_kernels.py:439, 446, 405); on the port's
//      single-host verify K3's tail takes the same test (msm.cu), and I1
//      checks a sharded verify's all-reduced point (parallel/verify.py).
// In the port these were eager torch, hundreds of launches of int64 limb
// arithmetic around one launch of K4's fused entry; their plain versions stay
// as the port's ops/ristretto.py `*_plain`, which these kernels equal.
//
// Bound on this card.  D1 and C1: the chain.  Each element runs K4's 251
// squarings and 11 multiplications and, around them, a dozen more products
// one after another (D1: 2 squarings and 9 products, C1: 1 and 13, beside
// SQRT_RATIO_M1's own 3 and 8), at 128 to 4100 elements a launch: the time
// is what one warp takes for that chain, the same argument as sqrt_ratio.cuh
// makes for K4.  I1: a launch.  It reads two coordinates of one point on
// every verify.
//
// Design.  D1 and C1 are K4's fused entry with the rest of the formula
// inside: the same two forms of one template (one lane an element; four
// lanes an element up to 4224 elements, where the launchers take it), the
// whole formula in registers on field25519.cuh, SQRT_RATIO_M1 from
// sqrt_ratio.cuh inline with u = 1 written as a constant.  The four lanes of
// an element hold the same values throughout and lane 0 stores.  Inputs and
// outputs are the callers' (n, 16) int64 limb rows, a 128-byte line an
// element and coordinate, so that no transposing copy surrounds a launch.
// D1 stores canonical coordinates (Z = 1) and the identity (0, 1, 1, 0) on
// every lane it rejects; C1 stores the canonical encoding.  I1 is one thread
// a point; it reads X and Y in place, so a point that K3 (csrc/msm.cu
// `horner_kernel`) left as one (4, 16) tensor is read with no copy.
//
// ops/field_model.py repeats D1, C1 and I1 word for word (`decompress_words`,
// `compress_words`, `is_identity_words`); tests/test_torch_ristretto.py holds
// the models against the JAX package.

#include "divsteps.cuh"
#include "sqrt_ratio.cuh"

#define RIST_THREADS 128
#define DC_THREADS 32  // the double-and-encode: a block is one warp, which inverts its lanes' product

__device__ __forceinline__ fe fe_d() {  // d = -121665/121666 mod p
    fe r;
    r.w[0] = 0x135978a3u; r.w[1] = 0x75eb4dcau; r.w[2] = 0x4141d8abu; r.w[3] = 0x00700a4du;
    r.w[4] = 0x7779e898u; r.w[5] = 0x8cc74079u; r.w[6] = 0x2b6ffe73u; r.w[7] = 0x52036ceeu;
    return r;
}

__device__ __forceinline__ fe fe_invsqrt_a_minus_d() {  // 1/sqrt(a - d), a = -1 (RFC 9496)
    fe r;
    r.w[0] = 0x805d40eau; r.w[1] = 0x99c8fdaau; r.w[2] = 0x5a4172beu; r.w[3] = 0x9d2f1617u;
    r.w[4] = 0xfe01d840u; r.w[5] = 0x16c27b91u; r.w[6] = 0xcfaffca2u; r.w[7] = 0x786c8905u;
    return r;
}

// s < p on the words as loaded, before any fold (fe_canon would map s >= p
// to s - p and hide it): s < 2^255 - 19 exactly when s + 19 leaves no carry
// out of word 7 and bit 255 clear.  s may be any value below 2^256.
__device__ __forceinline__ bool fe_below_p(const fe &s) {
    u32 top = add_cc(s.w[0], 19u);
#pragma unroll
    for (int k = 1; k < 8; ++k) top = addc_cc(s.w[k], 0u);
    const u32 carry = addc(0u, 0u);
    return carry == 0u && (top >> 31) == 0u;
}

// RFC 9496 DECODE of s, the steps of ops/ristretto.py:67-93 in their order:
// the point in p (canonical, Z = 1; the identity where rejected) and whether
// s was the canonical encoding of a point.
template <class M>
__device__ __forceinline__ bool ristretto_decode(const M &m, const fe &s, ge &p) {
    const bool canonical = fe_below_p(s);
    const bool nonneg = (s.w[0] & 1u) == 0u;
    const fe one = fe_one();
    const fe ss = m.sqr(s);
    const fe u1 = fe_sub(one, ss);
    const fe u2 = fe_add(one, ss);
    const fe u2_sqr = m.sqr(u2);
    const fe v = fe_sub(fe_neg(m.mul(m.mul(fe_d(), u1), u1)), u2_sqr);
    fe invsqrt;
    const bool was_square = fe_sqrt_ratio_m1(m, one, m.mul(v, u2_sqr), invsqrt);
    const fe den_x = m.mul(invsqrt, u2);
    const fe den_y = m.mul(m.mul(invsqrt, den_x), v);
    const fe x = fe_abs(m.mul(fe_add(s, s), den_x));  // 2s from s as given, below 2^256 but not canonical
    const fe y = m.mul(u1, den_y);
    const fe t = m.mul(x, y);
    const bool ok = canonical & nonneg & was_square & !fe_is_negative(t) & !fe_is_zero(y);
    const fe zero = fe_zero();
    p.x = fe_select(ok, x, zero);
    p.y = fe_select(ok, fe_canon(y), one);
    p.z = one;
    p.t = fe_select(ok, fe_canon(t), zero);
    return ok;
}

// RFC 9496 ENCODE of p, the steps of ops/ristretto.py:45-64 in their order:
// the canonical s.
template <class M>
__device__ __forceinline__ fe ristretto_encode(const M &m, const ge &p) {
    const fe u1 = m.mul(fe_add(p.z, p.y), fe_sub(p.z, p.y));
    const fe u2 = m.mul(p.x, p.y);
    fe invsqrt;
    fe_sqrt_ratio_m1(m, fe_one(), m.mul(u1, m.sqr(u2)), invsqrt);
    const fe den1 = m.mul(invsqrt, u1);
    const fe den2 = m.mul(invsqrt, u2);
    const fe z_inv = m.mul(m.mul(den1, den2), p.t);
    const fe ix0 = m.mul(p.x, fe_sqrt_m1());
    const fe iy0 = m.mul(p.y, fe_sqrt_m1());
    const fe enchanted = m.mul(den1, fe_invsqrt_a_minus_d());
    const bool rotate = fe_is_negative(m.mul(p.t, z_inv));
    const fe x = fe_select(rotate, iy0, p.x);
    fe y = fe_select(rotate, ix0, p.y);
    const fe den_inv = fe_select(rotate, enchanted, den2);
    y = fe_select(fe_is_negative(m.mul(x, z_inv)), fe_neg(y), y);
    return fe_abs(m.mul(den_inv, fe_sub(p.z, y)));
}

// s: (n, 16) limbs; out: (4, n, 16), coordinate c of element i at
// out + (c n + i) 16; valid: n bytes, 0 or 1.
template <class M>
__device__ __forceinline__ void decompress_body(const int64_t *__restrict__ s, int64_t *__restrict__ out,
                                                uint8_t *__restrict__ valid, long n) {
    const Work<M> w((long)blockIdx.x * blockDim.x + threadIdx.x, n);
    if (!w.live) return;
    ge p;
    const bool ok = ristretto_decode(w.m, fe_load(s + w.i * 16, 1), p);
    if (w.stores) {
        valid[w.i] = ok ? 1 : 0;
        ge_store(out + w.i * 16, n * 16, 1, p);
    }
}

__global__ void __launch_bounds__(RIST_THREADS) decompress_kernel(const int64_t *__restrict__ s,
                                                                 int64_t *__restrict__ out,
                                                                 uint8_t *__restrict__ valid, long n) {
    decompress_body<OneLane>(s, out, valid, n);
}

__global__ void __launch_bounds__(RIST_THREADS) decompress_coop_kernel(const int64_t *__restrict__ s,
                                                                      int64_t *__restrict__ out,
                                                                      uint8_t *__restrict__ valid, long n) {
    decompress_body<FourLanes>(s, out, valid, n);
}

// x, y, z, t, out: (n, 16) limbs each.
template <class M>
__device__ __forceinline__ void compress_body(const int64_t *__restrict__ x, const int64_t *__restrict__ y,
                                              const int64_t *__restrict__ z, const int64_t *__restrict__ t,
                                              int64_t *__restrict__ out, long n) {
    const Work<M> w((long)blockIdx.x * blockDim.x + threadIdx.x, n);
    if (!w.live) return;
    ge p;
    p.x = fe_load(x + w.i * 16, 1);
    p.y = fe_load(y + w.i * 16, 1);
    p.z = fe_load(z + w.i * 16, 1);
    p.t = fe_load(t + w.i * 16, 1);
    const fe s = ristretto_encode(w.m, p);
    if (w.stores) fe_store(out + w.i * 16, 1, s);
}

__global__ void __launch_bounds__(RIST_THREADS) compress_kernel(const int64_t *__restrict__ x,
                                                               const int64_t *__restrict__ y,
                                                               const int64_t *__restrict__ z,
                                                               const int64_t *__restrict__ t,
                                                               int64_t *__restrict__ out, long n) {
    compress_body<OneLane>(x, y, z, t, out, n);
}

__global__ void __launch_bounds__(RIST_THREADS) compress_coop_kernel(const int64_t *__restrict__ x,
                                                                    const int64_t *__restrict__ y,
                                                                    const int64_t *__restrict__ z,
                                                                    const int64_t *__restrict__ t,
                                                                    int64_t *__restrict__ out, long n) {
    compress_body<FourLanes>(x, y, z, t, out, n);
}

// C1's double-and-encode: the encoding of 2Q for each point Q, which is
// that of P where the prover's tables hold halved generators (Q_i =
// ((l + 1) / 2) G_i, so 2Q = P + l (sum s_i G_i), the second term in E[4]):
// curve25519-dalek's `RistrettoPoint::double_and_compress_batch`
// (src/ristretto.rs), which needs one inversion for the batch and no square
// root.  For Q = (X : Y : Z : T): e = 2XY, f = Z^2 + dT^2, g = Y^2 + X^2,
// h = Z^2 - dT^2, so that 2Q = (eh : fg : fh : eg); the lanes' efgh are
// inverted together by Montgomery's trick, then Zinv = 1 / fh = eg / efgh and
// Tinv = 1 / eg = fh / efgh,
// and two sign checks pick the rotation and the sign of g before
// s = |(h - g) magic g Tinv|.
//
// Bound on this card: the chain, as for C1's sqrt form, but some 20 products
// and one inversion deep in place of K4's 262 products and the formula's 9:
// the lane's efgh (a squaring and three products), the product tree (five
// levels up, five down), fe_inv (divsteps.cuh, 20 batches of 30 divsteps) and
// six products of the tail.
//
// Design: a block is one warp of 32 lanes, one lane a point, and inverts its
// own lanes' product, so any n is one launch and the blocks' inversions run
// side by side.  The tree is a butterfly of shuffles: at level k every lane
// takes the product of the 2^k lanes beside its own group (`sib[k]`) and
// multiplies, so after five levels every lane holds the warp's product and
// inverts it (all 32 the same value: one warp's issue whatever the count);
// going down, inv * sib[k] is the inverse of the lane's own group at level k,
// with no shuffle.  A lane whose e is 0 (Q in E[4], whose double is the
// identity, encoded as 0; f, g and h are never 0 on the curve) and a lane past
// n (which reads element n - 1) put 1 into the product; the first stores 0,
// the second nothing.  ops/field_model.py `double_compress_words` repeats the
// kernel lane for lane.
__global__ void __launch_bounds__(DC_THREADS) double_compress_kernel(const int64_t *__restrict__ x,
                                                                    const int64_t *__restrict__ y,
                                                                    const int64_t *__restrict__ z,
                                                                    const int64_t *__restrict__ t,
                                                                    int64_t *__restrict__ out, long n) {
    const long g_i = (long)blockIdx.x * DC_THREADS + threadIdx.x;
    const long i = g_i < n ? g_i : n - 1;
    const int lane = threadIdx.x;
    ge p;
    p.x = fe_load(x + i * 16, 1);
    p.y = fe_load(y + i * 16, 1);
    p.z = fe_load(z + i * 16, 1);
    p.t = fe_load(t + i * 16, 1);
    const fe xx = fe_sqr(p.x), yy = fe_sqr(p.y), zz = fe_sqr(p.z);
    const fe dtt = fe_mul(fe_sqr(p.t), fe_d());
    const fe e = fe_mul(p.x, fe_add(p.y, p.y));
    const fe f = fe_add(zz, dtt);
    const fe g = fe_add(yy, xx);
    const fe h = fe_sub(zz, dtt);
    const fe eg = fe_mul(e, g), fh = fe_mul(f, h);
    const bool torsion = fe_is_zero(e);
    fe acc = fe_select(torsion || g_i >= n, fe_one(), fe_mul(eg, fh));
    fe sib[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        sib[k] = fe_from_lane(acc, lane ^ (1 << k));
        acc = fe_mul(acc, sib[k]);
    }
    fe inv = fe_inv(acc);
#pragma unroll
    for (int k = 4; k >= 0; --k) inv = fe_mul(inv, sib[k]);
    const fe zinv = fe_mul(eg, inv), tinv = fe_mul(fh, inv);
    const bool rotate = fe_is_negative(fe_mul(eg, zinv));
    const fe e1 = fe_select(rotate, g, e);
    fe g1 = fe_select(rotate, fe_neg(e), g);
    const fe h1 = fe_select(rotate, fe_mul(f, fe_sqrt_m1()), h);
    const fe magic = fe_select(rotate, fe_sqrt_m1(), fe_invsqrt_a_minus_d());
    g1 = fe_select(fe_is_negative(fe_mul(fe_mul(h1, e1), zinv)), fe_neg(g1), g1);
    const fe s = fe_abs(fe_mul(fe_sub(h1, g1), fe_mul(magic, fe_mul(g1, tinv))));
    if (g_i < n) fe_store(out + g_i * 16, 1, fe_select(torsion, fe_zero(), s));
}

// One warp, each lane a chain of `iters` dependent fe_inv of x: x^((-1)^iters) mod p, canonical.  The probe
// behind the double-and-encode's `chain_ms` (`fe_inv_ns`).
__global__ void fe_inv_latency_kernel(const int64_t *in, int64_t *out, int iters) {
    fe acc = fe_load(in + 16 * threadIdx.x, 1);
    for (int k = 0; k < iters; ++k) acc = fe_inv(acc);
    fe_store(out + 16 * threadIdx.x, 1, acc);
}

// I1.  ops/ristretto.py:95-103: is_identity(p) = point_equal(p, (0 : 1 : 1 : 0)),
// and point_equal(p, q) = [X_p Y_q == Y_p X_q] or [Y_p Y_q == X_p X_q], each
// side compared canonically mod p.  With X_q = 0 and Y_q = 1 the first is
// [X_p == 0] and the second [Y_p == 0]: no product is left, only the two
// canonical forms.  x, y: (n, 16) limbs each; out: n bytes, 0 or 1.  Its one path
// is a sharded verify's all-reduced point: a single-host verify takes the same
// test from K3's tail (msm.cu horner_kernel).
__global__ void __launch_bounds__(RIST_THREADS) is_identity_kernel(const int64_t *__restrict__ x,
                                                                  const int64_t *__restrict__ y,
                                                                  uint8_t *__restrict__ out, long n) {
    const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = (fe_is_zero(fe_load(x + i * 16, 1)) || fe_is_zero(fe_load(y + i * 16, 1))) ? 1 : 0;
}

extern "C" const char *bppt_ristretto_error_string(int status) { return cudaGetErrorString((cudaError_t)status); }

static unsigned rist_blocks(bool coop, long n) { return work_blocks(coop, n, RIST_THREADS); }

// s: (n, 16) int64 limbs; out: (4, n, 16) int64; valid: n bytes; lanes: 0 picks the form from n, 1 and 4 force one.
extern "C" int bppt_decompress(const void *s, void *out, void *valid, long n, long lanes, void *stream) {
    const bool coop = four_lanes(lanes, n);
    const cudaStream_t st = (cudaStream_t)stream;
    if (coop) {
        decompress_coop_kernel<<<rist_blocks(coop, n), RIST_THREADS, 0, st>>>(
            (const int64_t *)s, (int64_t *)out, (uint8_t *)valid, n);
    } else {
        decompress_kernel<<<rist_blocks(coop, n), RIST_THREADS, 0, st>>>((const int64_t *)s, (int64_t *)out,
                                                                         (uint8_t *)valid, n);
    }
    return (int)cudaGetLastError();
}

// x, y, z, t, out: (n, 16) int64 limbs each.
extern "C" int bppt_compress(const void *x, const void *y, const void *z, const void *t, void *out, long n,
                             long lanes, void *stream) {
    const bool coop = four_lanes(lanes, n);
    const cudaStream_t st = (cudaStream_t)stream;
    if (coop) {
        compress_coop_kernel<<<rist_blocks(coop, n), RIST_THREADS, 0, st>>>(
            (const int64_t *)x, (const int64_t *)y, (const int64_t *)z, (const int64_t *)t, (int64_t *)out, n);
    } else {
        compress_kernel<<<rist_blocks(coop, n), RIST_THREADS, 0, st>>>(
            (const int64_t *)x, (const int64_t *)y, (const int64_t *)z, (const int64_t *)t, (int64_t *)out, n);
    }
    return (int)cudaGetLastError();
}

// x, y, z, t, out: (n, 16) int64 limbs each.
extern "C" int bppt_double_compress(const void *x, const void *y, const void *z, const void *t, void *out, long n,
                                    void *stream) {
    double_compress_kernel<<<(unsigned)((n + DC_THREADS - 1) / DC_THREADS), DC_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x, (const int64_t *)y, (const int64_t *)z, (const int64_t *)t, (int64_t *)out, n);
    return (int)cudaGetLastError();
}

// in, out: (32, 16) int64 limbs.
extern "C" int bppt_fe_inv_latency(const void *in, void *out, long iters, void *stream) {
    fe_inv_latency_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const int64_t *)in, (int64_t *)out, (int)iters);
    return (int)cudaGetLastError();
}

// x, y: (n, 16) int64 limbs each; out: n bytes.
extern "C" int bppt_is_identity(const void *x, const void *y, void *out, long n, void *stream) {
    is_identity_kernel<<<rist_blocks(false, n), RIST_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)x, (const int64_t *)y, (uint8_t *)out, n);
    return (int)cudaGetLastError();
}
