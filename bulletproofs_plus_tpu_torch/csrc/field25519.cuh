// GF(2^255 - 19) and extended twisted Edwards point arithmetic (a = -1)
// shared by every kernel of the port.
//
// Counterpart of bulletproofs_plus_tpu/ops/pfield.py, the limb-major field
// and point layer of the TPU kernels.  There the TPU's 32-bit vector unit
// forced radix-2^16 limbs and lo/hi product splits; here a field element is
// eight 32-bit words and each limb product is one 32x32->64 multiply-add.
//
// Representation: `fe` holds any value below 2^256 (not necessarily below
// p).  Every operation accepts any such input and returns a value below
// 2^256 congruent to the exact result; canonical reduction happens in torch
// at compare/encode time.  Each reduction folds the overflow through
// 2^256 == 38 (mod p) until the result provably fits: after the last
// fold a carry-out can still occur when the sum lands in [2^256, 2^256+38q),
// and the final `+38` below covers exactly that window (the JAX package's
// pfield._fold16 fix).
//
// At the kernel boundary values are radix-2^16 limbs held in int64 tensors,
// limb-major (16, n) so that neighbouring threads read neighbouring
// addresses.  Limbs must be below 2^16, which every torch op of the port
// guarantees.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

typedef uint32_t u32;
typedef uint64_t u64;

struct fe {
    u32 w[8];  // little-endian words, value < 2^256
};

struct ge {  // extended coordinates (X : Y : Z : T), x = X/Z, y = Y/Z, T = XY/Z
    fe x, y, z, t;
};

__device__ __forceinline__ fe fe_zero() {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = 0u;
    return r;
}

__device__ __forceinline__ fe fe_one() {
    fe r = fe_zero();
    r.w[0] = 1u;
    return r;
}

__device__ __forceinline__ fe fe_d2() {  // 2d mod p, d = -121665/121666
    fe r;
    r.w[0] = 0x26b2f159u; r.w[1] = 0xebd69b94u; r.w[2] = 0x8283b156u; r.w[3] = 0x00e0149au;
    r.w[4] = 0xeef3d130u; r.w[5] = 0x198e80f2u; r.w[6] = 0x56dffce7u; r.w[7] = 0x2406d9dcu;
    return r;
}

// r + c * 2^256 -> value < 2^256, for c < 2^26.
__device__ __forceinline__ void fe_fold_top(fe &r, u64 c) {
    c *= 38u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += r.w[k];
        r.w[k] = (u32)c;
        c >>= 32;
    }
    // A carry-out here means the wrapped r is below 38 * c_in < 2^32 - 38,
    // so adding the last 38 cannot carry again.
    r.w[0] += (u32)(38u * c);
}

__device__ __forceinline__ fe fe_add(const fe &a, const fe &b) {
    fe r;
    u64 c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (u64)a.w[k] + b.w[k];
        r.w[k] = (u32)c;
        c >>= 32;
    }
    fe_fold_top(r, c);
    return r;
}

__device__ __forceinline__ fe fe_sub(const fe &a, const fe &b) {
    fe r;
    int64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (int64_t)a.w[k] - (int64_t)b.w[k];
        r.w[k] = (u32)c;
        c >>= 32;  // arithmetic: 0 or -1
    }
    // A borrow left r = a - b + 2^256 == a - b + 38: take 38 off.
    c *= 38;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (int64_t)r.w[k];
        r.w[k] = (u32)c;
        c >>= 32;
    }
    // Borrowing again means r was below 38 and now sits at or above
    // 2^256 - 38: one more 38 comes off the low word without underflow.
    r.w[0] -= (u32)(38 * (int)(-c));
    return r;
}

__device__ __forceinline__ fe fe_neg(const fe &a) { return fe_sub(fe_zero(), a); }

__device__ __forceinline__ fe fe_mul(const fe &a, const fe &b) {
    u32 t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        u64 c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            c += (u64)a.w[i] * b.w[j] + t[i + j];  // <= 2^64 - 1
            t[i + j] = (u32)c;
            c >>= 32;
        }
        t[i + 8] = (u32)c;
    }
    fe r;
    u64 c = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        c += (u64)t[k] + (u64)t[k + 8] * 38u;
        r.w[k] = (u32)c;
        c >>= 32;
    }
    fe_fold_top(r, c);  // c < 39
    return r;
}

__device__ __forceinline__ fe fe_sqr(const fe &a) { return fe_mul(a, a); }

__device__ __forceinline__ ge ge_identity() {
    ge p;
    p.x = fe_zero();
    p.y = fe_one();
    p.z = fe_one();
    p.t = fe_zero();
    return p;
}

// Complete addition, add-2008-hwcd-3 for a = -1 (8M + 1 multiply by 2d).
__device__ __forceinline__ ge ge_add(const ge &p, const ge &q) {
    fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
    fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
    fe c = fe_mul(fe_mul(p.t, q.t), fe_d2());
    fe zz = fe_mul(p.z, q.z);
    fe d = fe_add(zz, zz);
    fe e = fe_sub(b, a);
    fe f = fe_sub(d, c);
    fe g = fe_add(d, c);
    fe h = fe_add(b, a);
    ge r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = fe_mul(e, h);
    return r;
}

// dbl-2008-hwcd for a = -1 (4M + 4S); complete, the identity included.
__device__ __forceinline__ ge ge_dbl(const ge &p) {
    fe a = fe_sqr(p.x);
    fe b = fe_sqr(p.y);
    fe zz = fe_sqr(p.z);
    fe c = fe_add(zz, zz);
    fe ab = fe_add(a, b);
    fe e = fe_sub(fe_sqr(fe_add(p.x, p.y)), ab);
    fe g = fe_sub(b, a);
    fe f = fe_sub(g, c);
    fe h = fe_neg(ab);
    ge r;
    r.x = fe_mul(e, f);
    r.y = fe_mul(g, h);
    r.z = fe_mul(f, g);
    r.t = fe_mul(e, h);
    return r;
}

// Radix-2^16 int64 limbs -> words.  Limb i of the element sits at
// base[i * limb_stride].
__device__ __forceinline__ fe fe_load(const int64_t *__restrict__ base, long limb_stride) {
    fe r;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        u32 lo = (u32)base[(2 * k) * limb_stride];
        u32 hi = (u32)base[(2 * k + 1) * limb_stride];
        r.w[k] = lo | (hi << 16);
    }
    return r;
}

__device__ __forceinline__ void fe_store(int64_t *__restrict__ base, long limb_stride, const fe &a) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        base[(2 * k) * limb_stride] = (int64_t)(a.w[k] & 0xFFFFu);
        base[(2 * k + 1) * limb_stride] = (int64_t)(a.w[k] >> 16);
    }
}

// Point (4, 16, ...) layout: coordinate c, limb i at base[c * coord_stride + i * limb_stride].
__device__ __forceinline__ ge ge_load(const int64_t *__restrict__ base, long coord_stride, long limb_stride) {
    ge p;
    p.x = fe_load(base, limb_stride);
    p.y = fe_load(base + coord_stride, limb_stride);
    p.z = fe_load(base + 2 * coord_stride, limb_stride);
    p.t = fe_load(base + 3 * coord_stride, limb_stride);
    return p;
}

__device__ __forceinline__ void ge_store(int64_t *__restrict__ base, long coord_stride, long limb_stride,
                                         const ge &p) {
    fe_store(base, limb_stride, p.x);
    fe_store(base + coord_stride, limb_stride, p.y);
    fe_store(base + 2 * coord_stride, limb_stride, p.z);
    fe_store(base + 3 * coord_stride, limb_stride, p.t);
}

// Points in shared memory: 32 words plus one pad word per point, so reads
// of different points by one warp fall in different banks.
#define GE_SMEM_STRIDE 33

__device__ __forceinline__ void ge_to_smem(u32 *s, const ge &p) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        s[k] = p.x.w[k];
        s[8 + k] = p.y.w[k];
        s[16 + k] = p.z.w[k];
        s[24 + k] = p.t.w[k];
    }
}

__device__ __forceinline__ ge ge_from_smem(const u32 *s) {
    ge p;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        p.x.w[k] = s[k];
        p.y.w[k] = s[8 + k];
        p.z.w[k] = s[16 + k];
        p.t.w[k] = s[24 + k];
    }
    return p;
}
