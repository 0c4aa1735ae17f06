// Per-axis DFT kernels of merfish3d_tpu_torch (ops/pfft.py), for Hopper.
//
// Replaces the Pallas kernels of merfish3d_tpu/ops/pfft.py:
//   K6  dft_trailing  (_dft_last_fwd_kernel / _dft_last_inv_kernel)
//   K7  dft_middle    (_dft_mid_fwd_kernel / _dft_mid_inv_kernel)
//   K8  dft_leading   (_dft_lead_kernel)
//   K10 dft_zx        (_dft_zx_fwd_kernel / _dft_zx_inv_kernel)
//   K9  dft_mid_conv  (_dft_mid_conv_kernel)
//
// Complex values are (real, imag) float32 planes in device memory; the
// constant tables (w1 (n1, n1), twiddle (n1, 128), w2 (128, 128), dense
// wz (n, n); for K10 also W128^j (128) and wz zero-padded to (n, nzp))
// are complex64, built on the host in double precision and
// uploaded by the wrapper, so no angle is ever evaluated here. Inverse
// tables carry the 1/n scale. All arithmetic is FP32 FMA on CUDA cores.
//
// Cooley-Tukey split of a length n = n1*128 line, natural j = 128p + q:
//   forward  C[k][q] = tw[k][q] * sum_p x[p][q] w1[k][p]      (stage 1)
//            X[k*128 + m] = sum_q C[k][q] w2[q][m]            (stage 2)
//   so position k*128 + m holds frequency n1*m + k: the scrambled order
//   falls out of the decomposition with no permute;
//   inverse  E[k][q] = tw'[k][q] * sum_m Y[k*128 + m] w2'[m][q]
//            x[p*128 + q] = sum_k E[k][q] w1'[k][p]            (natural).
//
// What bounds K6-K9: a line's stage 2 is a dense 128-point DFT, 128
// complex multiply-adds per element (~8*(n1 + 128) flops per element and
// axis), well above the 12-16 bytes an element moves; at the card's 67
// TFLOP/s FP32 this design's flops take ~4x the memory bound (3.35 TB/s).
// The transform itself needs only ~5*log2(n) flops per element and axis,
// so its bound on this card is the memory bound. The
// design keeps every operand of those sums on chip: a block stages its
// lines in shared memory once, stage 1 runs from registers (a thread owns
// one q of a line and holds its n1 <= 24 inputs), stage 2 reads the staged
// line as a warp broadcast and w2 through the read-only cache. K10 runs
// its stage 2 as the radix FFT of fft128.cuh instead; K6, K7 and K9 keep
// the dense one for now.
//
// Per kernel:
// - K6 (x, contiguous): 2 rows per block, shared memory 2*n*8 B <= 48 KB.
// - K7 (y, stride nx): a block holds 8 adjacent x columns of one z plane,
//   threads run along x so every global access of a warp is 32 B lines;
//   shared memory n*8*8 B <= 192 KB at n = 3072.
// - K8 (z dense): a block holds 64 adjacent (y, x) columns, n*64*8 B
//   <= 48 KB; the (n, n) matrix is read through the read-only cache.
// - K10 (z and x of a (z, y, x) volume; merfish3d_tpu/ops/pfft.py dft_zx,
//   _dft_zx_fwd_kernel / _dft_zx_inv_kernel). The TPU kernel keeps a
//   whole (nz, nx) plane in VMEM and runs both 128-point stages as MXU
//   matmuls. On this card a plane is 114-450 KB for the shapes
//   zx_supported admits, more than a block's shared memory, and a dense
//   128-point stage on the CUDA cores is bound by issuing its table loads
//   (two loads a complex multiply-add, a 128 KB table that L1 cannot keep).
//   The function itself is bound by bytes: 12 B an element (a real input)
//   at 5 log2(n) flops an element and axis. So K10 is two launches in one
//   call, each memory-bound:
//   x pass (dft_zx_x): one warp a line, four lines a block. Stage 1 and
//     the twiddle run from registers as in K6; the n1 128-point transforms
//     are fft128::transform (4 at a time, 8 lanes each) on the line's
//     slab in shared memory (n1 x 136 float2, 4.25 KB per n1: 39 KB a
//     block at n1 = 9, so at least two blocks an SM at every admitted
//     length); lines are read and written whole and coalesced.
//   z pass (dft_zx_z): the dense nz-point DFT (nz <= 96, any length) of
//     64 adjacent columns per block, staged in shared memory (<= 48 KB);
//     a lane accumulates 8 outputs of two columns in registers, and each
//     warp-uniform float4 table load feeds four complex multiply-adds.
//   Forward: x pass from the input into the output, z pass in place on
//   it. Inverse: z pass into the output, then the x pass in place (the
//   128-point inverse transform of each group, the conjugate twiddle with
//   1/n, the n1-point synthesis to natural order); its intermediate is
//   complex, so the output's imaginary plane is written as scratch even
//   when only the real part is returned. 28 B an element move in all
//   (about 2.3x the one-pass bound); the flops are ~10x below the FP32
//   peak's time.
//
// Plain C entry points; each returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "fft128.cuh"

namespace {

constexpr int LANE = 128;
constexpr int MAX_N1 = 24;
constexpr int THREADS = 256;
constexpr int TRAIL_ROWS = 2;
constexpr int MID_TX = 8;
constexpr int LEAD_COLS = 64;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
}

// L lines of length n1*128: element j of line l sits at base + l*ls + j*js
// of each channel; lines >= valid are a ragged tail and skipped. Shared
// memory holds a line group as S[j*L + l].
struct Lines {
    long long base, ls, js;
    int L, valid;
    __device__ long long at(int l, int j) const {
        return base + l * ls + static_cast<long long>(j) * js;
    }
};

// work item -> (index i along the line, line l): the direction that is
// contiguous in device memory is the fastest, so accesses coalesce
__device__ __forceinline__ void split_item(int item, int extent, const Lines& g, int& i, int& l) {
    if (g.js == 1) {
        i = item % extent;
        l = item / extent;
    } else {
        l = item % g.L;
        i = item / g.L;
    }
}

// forward stage 1 + twiddle, from device memory into S = C[(k*128+q)*L + l]
__device__ void ct_fwd_stage1(const float* xr, const float* xi, const Lines g, int n1,
                              const float2* __restrict__ w1, const float2* __restrict__ tw,
                              float2* S) {
    for (int item = threadIdx.x; item < LANE * g.L; item += blockDim.x) {
        int q, l;
        split_item(item, LANE, g, q, l);
        if (l >= g.valid) continue;
        float2 xv[MAX_N1];
#pragma unroll
        for (int p = 0; p < MAX_N1; ++p) {
            if (p < n1) {
                const long long o = g.at(l, p * LANE + q);
                xv[p] = make_float2(xr[o], xi ? xi[o] : 0.f);
            }
        }
        for (int k = 0; k < n1; ++k) {
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int p = 0; p < MAX_N1; ++p)
                if (p < n1) cmac(acc, xv[p], __ldg(&w1[k * n1 + p]));
            S[(k * LANE + q) * g.L + l] = cmul(acc, __ldg(&tw[k * LANE + q]));
        }
    }
}

// forward stage 2, from S into device memory (scrambled order)
__device__ void ct_fwd_stage2(const float2* S, const Lines g, int n1,
                              const float2* __restrict__ w2, float* yr, float* yi) {
    for (int item = threadIdx.x; item < LANE * g.L; item += blockDim.x) {
        int m, l;
        split_item(item, LANE, g, m, l);
        if (l >= g.valid) continue;
        for (int k = 0; k < n1; ++k) {
            const float2* row = S + k * LANE * g.L + l;
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
            for (int q = 0; q < LANE; ++q) cmac(acc, row[q * g.L], __ldg(&w2[q * LANE + m]));
            const long long o = g.at(l, k * LANE + m);
            yr[o] = acc.x;
            yi[o] = acc.y;
        }
    }
}

// a line group from device memory into S[j*L + l]
__device__ void load_lines(const float* xr, const float* xi, const Lines g, int n, float2* S) {
    for (int item = threadIdx.x; item < n * g.L; item += blockDim.x) {
        int j, l;
        split_item(item, n, g, j, l);
        if (l >= g.valid) continue;
        const long long o = g.at(l, j);
        S[j * g.L + l] = make_float2(xr[o], xi ? xi[o] : 0.f);
    }
}

// inverse from a scrambled line group in S: stage 2, conjugate twiddle,
// then the n1-point synthesis writing natural order (yi may be null)
__device__ void ct_inv(const float2* S, const Lines g, int n1, const float2* __restrict__ w1,
                       const float2* __restrict__ tw, const float2* __restrict__ w2,
                       float* yr, float* yi) {
    for (int item = threadIdx.x; item < LANE * g.L; item += blockDim.x) {
        int q, l;
        split_item(item, LANE, g, q, l);
        if (l >= g.valid) continue;
        float2 e[MAX_N1];
#pragma unroll
        for (int k = 0; k < MAX_N1; ++k) {
            if (k < n1) {
                const float2* row = S + k * LANE * g.L + l;
                float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
                for (int m = 0; m < LANE; ++m) cmac(acc, row[m * g.L], __ldg(&w2[m * LANE + q]));
                e[k] = cmul(acc, __ldg(&tw[k * LANE + q]));
            }
        }
        for (int p = 0; p < n1; ++p) {
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < MAX_N1; ++k)
                if (k < n1) cmac(acc, e[k], __ldg(&w1[k * n1 + p]));
            const long long o = g.at(l, p * LANE + q);
            yr[o] = acc.x;
            if (yi) yi[o] = acc.y;
        }
    }
}

// inverse stage 1 from E[(k*128+q)*L + l] in S: the n1-point synthesis,
// natural order out
__device__ void ct_inv_stage1(const float2* S, const Lines g, int n1,
                              const float2* __restrict__ w1, float* yr, float* yi) {
    for (int item = threadIdx.x; item < LANE * g.L; item += blockDim.x) {
        int q, l;
        split_item(item, LANE, g, q, l);
        if (l >= g.valid) continue;
        float2 e[MAX_N1];
#pragma unroll
        for (int k = 0; k < MAX_N1; ++k)
            if (k < n1) e[k] = S[(k * LANE + q) * g.L + l];
        for (int p = 0; p < n1; ++p) {
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int k = 0; k < MAX_N1; ++k)
                if (k < n1) cmac(acc, e[k], __ldg(&w1[k * n1 + p]));
            const long long o = g.at(l, p * LANE + q);
            yr[o] = acc.x;
            yi[o] = acc.y;
        }
    }
}

// dense DFT over n rows of `ncols` adjacent columns starting at c0 of a
// (n, plane) layout: out[k][c] = sum_j W[k][j] x[j][c], staged through
// S[j*sc + c]. x and y may be the same arrays (every read precedes the
// barrier, every write follows it); xi null reads zeros, yi null skips.
__device__ void dense_cols(const float* xr, const float* xi, float* yr, float* yi, int n,
                           long long plane, long long c0, int ncols, int sc,
                           const float2* __restrict__ W, float2* S) {
    for (int item = threadIdx.x; item < n * sc; item += blockDim.x) {
        const int c = item % sc, j = item / sc;
        if (c >= ncols) continue;
        const long long o = j * plane + c0 + c;
        S[j * sc + c] = make_float2(xr[o], xi ? xi[o] : 0.f);
    }
    __syncthreads();
    for (int item = threadIdx.x; item < n * sc; item += blockDim.x) {
        const int c = item % sc, k = item / sc;
        if (c >= ncols) continue;
        float2 acc = make_float2(0.f, 0.f);
        for (int j = 0; j < n; ++j) cmac(acc, S[j * sc + c], __ldg(&W[k * n + j]));
        const long long o = k * plane + c0 + c;
        yr[o] = acc.x;
        if (yi) yi[o] = acc.y;
    }
    __syncthreads();
}

// ---------------------------------------------------------------- K6
__device__ Lines trailing_lines(long long rows, int n1) {
    const int n = n1 * LANE;
    const long long r0 = static_cast<long long>(blockIdx.x) * TRAIL_ROWS;
    const long long left = rows - r0;
    return Lines{r0 * n, n, 1, TRAIL_ROWS, static_cast<int>(left < TRAIL_ROWS ? left : TRAIL_ROWS)};
}

__global__ void __launch_bounds__(THREADS)
dft_trailing_fwd(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
                 const float2* tw, const float2* w2, long long rows, int n1) {
    extern __shared__ float2 smem[];
    const Lines g = trailing_lines(rows, n1);
    ct_fwd_stage1(xr, xi, g, n1, w1, tw, smem);
    __syncthreads();
    ct_fwd_stage2(smem, g, n1, w2, yr, yi);
}

__global__ void __launch_bounds__(THREADS)
dft_trailing_inv(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
                 const float2* tw, const float2* w2, long long rows, int n1) {
    extern __shared__ float2 smem[];
    const Lines g = trailing_lines(rows, n1);
    load_lines(xr, xi, g, n1 * LANE, smem);
    __syncthreads();
    ct_inv(smem, g, n1, w1, tw, w2, yr, yi);
}

// ---------------------------------------------------------------- K7
__device__ Lines middle_lines(int n1, int nx) {
    const int tiles = nx / MID_TX;
    const long long z = blockIdx.x / tiles;
    const int x0 = (blockIdx.x % tiles) * MID_TX;
    return Lines{z * n1 * LANE * nx + x0, 1, nx, MID_TX, MID_TX};
}

__global__ void __launch_bounds__(THREADS)
dft_middle_fwd(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
               const float2* tw, const float2* w2, int n1, int nx) {
    extern __shared__ float2 smem[];
    const Lines g = middle_lines(n1, nx);
    ct_fwd_stage1(xr, xi, g, n1, w1, tw, smem);
    __syncthreads();
    ct_fwd_stage2(smem, g, n1, w2, yr, yi);
}

__global__ void __launch_bounds__(THREADS)
dft_middle_inv(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
               const float2* tw, const float2* w2, int n1, int nx) {
    extern __shared__ float2 smem[];
    const Lines g = middle_lines(n1, nx);
    load_lines(xr, xi, g, n1 * LANE, smem);
    __syncthreads();
    ct_inv(smem, g, n1, w1, tw, w2, yr, yi);
}

// ---------------------------------------------------------------- K8
__global__ void __launch_bounds__(THREADS)
dft_leading_k(const float* xr, const float* xi, float* yr, float* yi, const float2* w, int n,
              long long plane) {
    extern __shared__ float2 smem[];
    const long long c0 = static_cast<long long>(blockIdx.x) * LEAD_COLS;
    const long long left = plane - c0;
    dense_cols(xr, xi, yr, yi, n, plane, c0, static_cast<int>(left < LEAD_COLS ? left : LEAD_COLS),
               LEAD_COLS, w, smem);
}

// ---------------------------------------------------------------- K10
constexpr int ZX_WARPS = 4;       // lines (one a warp) per x-pass block
constexpr int ZX_GS = LANE + 8;   // a 128-group's stride in shared memory (bank offset)
constexpr int ZX_COLS = 64;       // columns per z-pass block, two a lane
constexpr int ZX_KT = 8;          // outputs a z-pass warp accumulates at once
constexpr int ZX_ZWARPS = 8;      // the most warps a z-pass block has

// x pass: the Cooley-Tukey DFT of `rows` contiguous lines of n1*128.
// Forward: natural order in, scrambled out (position k*128 + m holds
// frequency n1*m + k). Inverse: scrambled in, natural out, 1/n in tw;
// write_imag = 0 drops the imaginary output. In place is allowed: a warp
// reads its whole line before it writes.
template <bool INV>
__global__ void __launch_bounds__(ZX_WARPS * 32, 4)
dft_zx_x(const float* xr, const float* xi, float* yr, float* yi, const float2* __restrict__ w1,
         const float2* __restrict__ tw, const float2* __restrict__ w128, long long rows, int n1,
         int write_imag) {
    extern __shared__ float2 smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = static_cast<long long>(blockIdx.x) * ZX_WARPS + warp;
    if (row >= rows) return;  // the whole warp: nothing below synchronizes the block
    const int n = n1 * LANE;
    const long long base = row * n;
    float2* S = smem + warp * n1 * ZX_GS;  // group k at S + k*ZX_GS
    if (!INV) {
        // stage 1 + twiddle: C[k][q] = tw[k][q] * sum_p x[p*128 + q] w1[k][p]
        for (int q = lane; q < LANE; q += 32) {
            float2 xv[MAX_N1];
#pragma unroll
            for (int p = 0; p < MAX_N1; ++p) {
                if (p < n1) {
                    const long long o = base + p * LANE + q;
                    xv[p] = make_float2(xr[o], xi ? xi[o] : 0.f);
                }
            }
            for (int k = 0; k < n1; ++k) {
                float2 acc = make_float2(0.f, 0.f);
#pragma unroll
                for (int p = 0; p < MAX_N1; ++p)
                    if (p < n1) cmac(acc, xv[p], __ldg(&w1[k * n1 + p]));
                S[k * ZX_GS + q] = cmul(acc, __ldg(&tw[k * LANE + q]));
            }
        }
    } else {
        for (int s = lane; s < n; s += 32)
            S[(s >> 7) * ZX_GS + (s & (LANE - 1))] = make_float2(xr[base + s], xi ? xi[base + s] : 0.f);
    }
    __syncwarp();
    // the n1 128-point transforms, four at a time, eight lanes each
    const int g = lane >> 3, t = lane & 7;
    for (int k0 = 0; k0 < n1; k0 += 4) {
        const int k = k0 + g;
        fft128::transform<INV>(S + (k < n1 ? k : 0) * ZX_GS, t, k < n1, w128);
    }
    if (!INV) {
        for (int s = lane; s < n; s += 32) {
            const float2 v = S[(s >> 7) * ZX_GS + (s & (LANE - 1))];
            yr[base + s] = v.x;
            yi[base + s] = v.y;
        }
    } else {
        // conjugate twiddle (1/n folded in), then the n1-point synthesis:
        // x[p*128 + q] = sum_k E[k][q] w1[k][p], natural order
        for (int q = lane; q < LANE; q += 32) {
            float2 e[MAX_N1];
#pragma unroll
            for (int k = 0; k < MAX_N1; ++k)
                if (k < n1) e[k] = cmul(S[k * ZX_GS + q], __ldg(&tw[k * LANE + q]));
            for (int p = 0; p < n1; ++p) {
                float2 acc = make_float2(0.f, 0.f);
#pragma unroll
                for (int k = 0; k < MAX_N1; ++k)
                    if (k < n1) cmac(acc, e[k], __ldg(&w1[k * n1 + p]));
                const long long o = base + p * LANE + q;
                yr[o] = acc.x;
                if (write_imag) yi[o] = acc.y;
            }
        }
    }
}

// z pass: the dense nz-point DFT along axis 0 of an (nz, plane) pair,
// out[k][c] = sum_j W[k][j] x[j][c]; xi null reads zeros. In place is
// allowed: a block reads all of its 64 columns before the barrier and
// writes them after it. W is symmetric and stored as rows j of nzp (a
// multiple of 8) entries, zero past nz, so a thread reads W[j][kb..kb+7]
// as four aligned float4 pairs. A warp owns 8 consecutive outputs (kb,
// a multiple of 8) of all 64 columns, a lane two columns 32 apart: per j
// two shared-memory loads and four warp-uniform table loads feed 16
// complex multiply-adds.
__global__ void __launch_bounds__(ZX_ZWARPS * 32)
dft_zx_z(const float* xr, const float* xi, float* yr, float* yi, const float4* __restrict__ W, int nz,
         int nzp, long long plane) {
    extern __shared__ float2 S[];  // S[j*ZX_COLS + c]
    const long long c0 = static_cast<long long>(blockIdx.x) * ZX_COLS;
    const int ncols = static_cast<int>((plane - c0) < ZX_COLS ? plane - c0 : ZX_COLS);
    for (int item = threadIdx.x; item < nz * ZX_COLS; item += blockDim.x) {
        const int c = item % ZX_COLS, j = item / ZX_COLS;
        if (c >= ncols) continue;
        const long long o = j * plane + c0 + c;
        S[item] = make_float2(xr[o], xi ? xi[o] : 0.f);
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    for (int kb = warp * ZX_KT; kb < nz; kb += warps * ZX_KT) {
        float2 a0[ZX_KT], a1[ZX_KT];
#pragma unroll
        for (int i = 0; i < ZX_KT; ++i) a0[i] = a1[i] = make_float2(0.f, 0.f);
        for (int j = 0; j < nz; ++j) {
            const float2 x0 = S[j * ZX_COLS + lane], x1 = S[j * ZX_COLS + 32 + lane];
            const float4* wj = W + (j * nzp + kb) / 2;  // W[k][j] = W[j][k], k = kb..kb+7
#pragma unroll
            for (int i = 0; i < ZX_KT / 2; ++i) {
                const float4 w = __ldg(&wj[i]);
                const float2 wa = make_float2(w.x, w.y), wb = make_float2(w.z, w.w);
                cmac(a0[2 * i], x0, wa);
                cmac(a0[2 * i + 1], x0, wb);
                cmac(a1[2 * i], x1, wa);
                cmac(a1[2 * i + 1], x1, wb);
            }
        }
#pragma unroll
        for (int i = 0; i < ZX_KT; ++i) {
            if (kb + i >= nz) break;
            const long long o = (kb + i) * plane + c0;
            if (lane < ncols) {
                yr[o + lane] = a0[i].x;
                if (yi) yi[o + lane] = a0[i].y;
            }
            if (lane + 32 < ncols) {
                yr[o + 32 + lane] = a1[i].x;
                if (yi) yi[o + 32 + lane] = a1[i].y;
            }
        }
    }
}

// ---------------------------------------------------------------- K9
__global__ void __launch_bounds__(THREADS)
dft_mid_conv_k(const float* xr, const float* xi, const float* hr, const float* hi, float* yr,
               float* yi, const float2* w1f, const float2* twf, const float2* w2f,
               const float2* w1i, const float2* twi, const float2* w2i, int n1, int nx) {
    extern __shared__ float2 smem[];
    const Lines g = middle_lines(n1, nx);
    float2* S = smem;                    // the slab: C, then E, group by group
    float2* T = smem + n1 * LANE * g.L;  // one group's spectrum times the OTF
    ct_fwd_stage1(xr, xi, g, n1, w1f, twf, S);
    __syncthreads();
    for (int k = 0; k < n1; ++k) {
        float2* Sk = S + k * LANE * g.L;
        // forward stage 2 of group k: spectrum positions k*128 + m
        for (int item = threadIdx.x; item < LANE * g.L; item += blockDim.x) {
            int m, l;
            split_item(item, LANE, g, m, l);
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
            for (int q = 0; q < LANE; ++q) cmac(acc, Sk[q * g.L + l], __ldg(&w2f[q * LANE + m]));
            const long long o = g.at(l, k * LANE + m);
            T[m * g.L + l] = cmul(acc, make_float2(hr[o], hi[o]));
        }
        __syncthreads();
        // inverse stage 2 + conjugate twiddle (1/n folded in) of group k
        for (int item = threadIdx.x; item < LANE * g.L; item += blockDim.x) {
            int q, l;
            split_item(item, LANE, g, q, l);
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll 8
            for (int m = 0; m < LANE; ++m) cmac(acc, T[m * g.L + l], __ldg(&w2i[m * LANE + q]));
            Sk[q * g.L + l] = cmul(acc, __ldg(&twi[k * LANE + q]));
        }
        __syncthreads();
    }
    ct_inv_stage1(S, g, n1, w1i, yr, yi);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace

extern "C" {

int dft_trailing_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w1,
                     const void* tw, const void* w2, long long rows, int n1, int inverse,
                     void* stream) {
    auto kernel = inverse ? dft_trailing_inv : dft_trailing_fwd;
    const size_t smem = static_cast<size_t>(TRAIL_ROWS) * n1 * LANE * sizeof(float2);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (rows + TRAIL_ROWS - 1) / TRAIL_ROWS;
    kernel<<<static_cast<unsigned>(blocks), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        xr, xi, yr, yi, static_cast<const float2*>(w1), static_cast<const float2*>(tw),
        static_cast<const float2*>(w2), rows, n1);
    return cudaGetLastError();
}

int dft_middle_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w1,
                   const void* tw, const void* w2, int nz, int n1, int nx, int inverse,
                   void* stream) {
    auto kernel = inverse ? dft_middle_inv : dft_middle_fwd;
    const size_t smem = static_cast<size_t>(MID_TX) * n1 * LANE * sizeof(float2);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>(nz) * (nx / MID_TX);
    kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        xr, xi, yr, yi, static_cast<const float2*>(w1), static_cast<const float2*>(tw),
        static_cast<const float2*>(w2), n1, nx);
    return cudaGetLastError();
}

int dft_leading_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w, int n,
                    long long plane, void* stream) {
    const size_t smem = static_cast<size_t>(n) * LEAD_COLS * sizeof(float2);
    cudaError_t err = allow_smem(dft_leading_k, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (plane + LEAD_COLS - 1) / LEAD_COLS;
    dft_leading_k<<<static_cast<unsigned>(blocks), THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(xr, xi, yr, yi,
                                                         static_cast<const float2*>(w), n, plane);
    return cudaGetLastError();
}

// K10: two launches on one stream (see the note at the top). yi is
// written in full in both directions: with real_out it is the inverse's
// scratch.
int dft_zx_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w1,
               const void* tw, const void* w128, const void* wz, int nz, int nzp, int ny, int n1,
               int inverse, int real_out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2 *c1 = static_cast<const float2*>(w1), *ct = static_cast<const float2*>(tw),
                 *c128 = static_cast<const float2*>(w128);
    const float4* cz = static_cast<const float4*>(wz);
    const int warps_z = (nz + ZX_KT - 1) / ZX_KT < ZX_ZWARPS ? (nz + ZX_KT - 1) / ZX_KT : ZX_ZWARPS;
    const long long rows = static_cast<long long>(nz) * ny;
    const long long plane = static_cast<long long>(ny) * n1 * LANE;
    const size_t smem_x = static_cast<size_t>(ZX_WARPS) * n1 * ZX_GS * sizeof(float2);
    const size_t smem_z = static_cast<size_t>(nz) * ZX_COLS * sizeof(float2);
    const unsigned blocks_x = static_cast<unsigned>((rows + ZX_WARPS - 1) / ZX_WARPS);
    const unsigned blocks_z = static_cast<unsigned>((plane + ZX_COLS - 1) / ZX_COLS);
    auto x_pass = inverse ? dft_zx_x<true> : dft_zx_x<false>;
    cudaError_t err = allow_smem(x_pass, smem_x);
    if (err != cudaSuccess) return err;
    err = allow_smem(dft_zx_z, smem_z);
    if (err != cudaSuccess) return err;
    if (inverse) {
        dft_zx_z<<<blocks_z, warps_z * 32, smem_z, s>>>(xr, xi, yr, yi, cz, nz, nzp, plane);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        x_pass<<<blocks_x, ZX_WARPS * 32, smem_x, s>>>(yr, yi, yr, yi, c1, ct, c128, rows, n1,
                                                       real_out ? 0 : 1);
    } else {
        x_pass<<<blocks_x, ZX_WARPS * 32, smem_x, s>>>(xr, xi, yr, yi, c1, ct, c128, rows, n1, 1);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        dft_zx_z<<<blocks_z, warps_z * 32, smem_z, s>>>(yr, yi, yr, yi, cz, nz, nzp, plane);
    }
    return cudaGetLastError();
}

int dft_mid_conv_f32(const float* xr, const float* xi, const float* hr, const float* hi, float* yr,
                     float* yi, const void* w1f, const void* twf, const void* w2f, const void* w1i,
                     const void* twi, const void* w2i, int nz, int n1, int nx, void* stream) {
    const size_t smem = static_cast<size_t>(n1 + 1) * LANE * MID_TX * sizeof(float2);
    cudaError_t err = allow_smem(dft_mid_conv_k, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>(nz) * (nx / MID_TX);
    dft_mid_conv_k<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        xr, xi, hr, hi, yr, yi, static_cast<const float2*>(w1f), static_cast<const float2*>(twf),
        static_cast<const float2*>(w2f), static_cast<const float2*>(w1i),
        static_cast<const float2*>(twi), static_cast<const float2*>(w2i), n1, nx);
    return cudaGetLastError();
}

}  // extern "C"
