// A 128-point complex FFT in registers, held by 8 threads, for Hopper.
//
// 128 = 16 x 8. Input index n = 8a + b (a < 16, b < 8), output index
// k = k1 + 16 k2 (k1 < 16, k2 < 8):
//   X[k1 + 16 k2] = sum_b W8^(b k2) * ( W128^(b k1) * sum_a x[8a + b] W16^(a k1) )
// Thread b of a group of 8 holds the 16 values x[8a + b] and runs the
// 16-point DFT over a in registers (as 4 x 4), then multiplies by the
// twiddle W128^(b k1), read from a 128-entry table built on the host in
// double precision (no angle is evaluated here). One exchange through
// shared memory gives thread t the 8 values of k1 = t and of k1 = t + 8,
// and two 8-point DFTs (as 4 x 2) in registers finish the transform. The
// radix butterflies use only +-1, +-i, (+-1 +- i)/sqrt2 and cos/sin(pi/8)
// as compile-time constants. Forward transforms use W = exp(-2 pi i/N),
// inverse ones exp(+2 pi i/N) with no scale.
//
// Operations: about 2.7 kflop a transform against 131 kflop for the dense
// 128 x 128 product it replaces (48x fewer), all FP32 FMA/add on the CUDA
// cores.

#pragma once

#include <cuda_runtime.h>

namespace fft128 {

constexpr int N = 128;
constexpr int GROUP = 8;  // threads a transform

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a * (-i) forward, a * (+i) inverse
template <bool INV>
__device__ __forceinline__ float2 mul_i(float2 a) {
    return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// a * exp(-+i theta), given (cos theta, sin theta)
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a, float c, float s) {
    const float sn = INV ? s : -s;
    return make_float2(fmaf(a.x, c, -a.y * sn), fmaf(a.x, sn, a.y * c));
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
    const float2 s02 = cadd(a0, a2), d02 = csub(a0, a2);
    const float2 s13 = cadd(a1, a3), d13 = mul_i<INV>(csub(a1, a3));
    a0 = cadd(s02, s13);
    a2 = csub(s02, s13);
    a1 = cadd(d02, d13);
    a3 = csub(d02, d13);
}

constexpr float R2 = 0.70710678118654752f;  // cos(pi/4)
constexpr float C8 = 0.92387953251128676f;  // cos(pi/8)
constexpr float S8 = 0.38268343236508977f;  // sin(pi/8)

// 8-point DFT, natural order in and out: n = 2a + e, k = c + 4d
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8]) {
    dft4<INV>(v[0], v[2], v[4], v[6]);  // e = 0: U0[c] at v[2c]
    dft4<INV>(v[1], v[3], v[5], v[7]);  // e = 1: U1[c] at v[2c + 1]
    const float2 u0 = v[0], u1 = v[2], u2 = v[4], u3 = v[6];
    const float2 t0 = v[1];
    const float2 t1 = rot<INV>(v[3], R2, R2);   // W8^1
    const float2 t2 = mul_i<INV>(v[5]);         // W8^2
    const float2 t3 = rot<INV>(v[7], -R2, R2);  // W8^3
    v[0] = cadd(u0, t0);
    v[4] = csub(u0, t0);
    v[1] = cadd(u1, t1);
    v[5] = csub(u1, t1);
    v[2] = cadd(u2, t2);
    v[6] = csub(u2, t2);
    v[3] = cadd(u3, t3);
    v[7] = csub(u3, t3);
}

// 16-point DFT, natural order in and out: n = 4a + b, k = c + 4d
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
#pragma unroll
    for (int b = 0; b < 4; ++b) dft4<INV>(v[b], v[4 + b], v[8 + b], v[12 + b]);
    // U[b][c] sits at v[4c + b]; times W16^(b c)
    v[5] = rot<INV>(v[5], C8, S8);     // W16^1
    v[9] = rot<INV>(v[9], R2, R2);     // W16^2
    v[13] = rot<INV>(v[13], S8, C8);   // W16^3
    v[6] = rot<INV>(v[6], R2, R2);     // W16^2
    v[10] = mul_i<INV>(v[10]);         // W16^4
    v[14] = rot<INV>(v[14], -R2, R2);  // W16^6
    v[7] = rot<INV>(v[7], S8, C8);     // W16^3
    v[11] = rot<INV>(v[11], -R2, R2);  // W16^6
    v[15] = rot<INV>(v[15], -C8, -S8); // W16^9
#pragma unroll
    for (int c = 0; c < 4; ++c) dft4<INV>(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    // v[4c + d] holds Y[c + 4d]: back to natural order (register renaming)
    float2 t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = v[i];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int d = 0; d < 4; ++d) v[c + 4 * d] = t[4 * c + d];
}

// One 128-point DFT in place on C[0..127] (shared memory), natural order
// in and out, by the 8 threads t = 0..7 of an aligned group of a warp.
// Every lane of the warp calls it together (it synchronizes the warp);
// lanes whose group has no transform pass active = false and touch no
// memory. tw[j] = W128^j, j < 128. The exchange stores Z[b][k1] at
// 8 k1 + (b ^ (k1 & 7)), so both its writes and its transposed reads
// spread over the banks.
template <bool INV>
__device__ __forceinline__ void transform(float2* C, int t, bool active, const float2* __restrict__ tw) {
    float2 v[16];
    if (active) {
#pragma unroll
        for (int a = 0; a < 16; ++a) v[a] = C[8 * a + t];
        dft16<INV>(v);
#pragma unroll
        for (int k1 = 1; k1 < 16; ++k1) v[k1] = cmul(v[k1], __ldg(&tw[t * k1]));
    }
    __syncwarp();
    if (active) {
#pragma unroll
        for (int k1 = 0; k1 < 16; ++k1) C[8 * k1 + (t ^ (k1 & 7))] = v[k1];
    }
    __syncwarp();
    float2 u0[8], u1[8];
    if (active) {
#pragma unroll
        for (int b = 0; b < 8; ++b) {
            u0[b] = C[8 * t + (b ^ t)];
            u1[b] = C[8 * (t + 8) + (b ^ t)];
        }
        dft8<INV>(u0);
        dft8<INV>(u1);
    }
    __syncwarp();
    if (active) {
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) {
            C[t + 16 * k2] = u0[k2];
            C[t + 8 + 16 * k2] = u1[k2];
        }
    }
    __syncwarp();
}

}  // namespace fft128
