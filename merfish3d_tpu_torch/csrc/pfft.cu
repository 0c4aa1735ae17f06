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
// constant tables (w1 (n1, n1), twiddle (n1, 128), W128^j (128), dense
// wz (n, n) zero-padded to (n, nzp), K8's radix table) are complex64,
// built on the host in double precision and uploaded by the wrapper, so
// no angle is ever evaluated here. Inverse tables carry the 1/n scale.
// All arithmetic is FP32 FMA on CUDA cores.
//
// Cooley-Tukey split of a length n = n1*128 line, natural j = 128p + q:
//   forward  C[k][q] = tw[k][q] * sum_p x[p][q] w1[k][p]      (stage 1)
//            X[k*128 + m] = sum_q C[k][q] W128^(qm)          (stage 2)
//   so position k*128 + m holds frequency n1*m + k: the scrambled order
//   falls out of the decomposition with no permute;
//   inverse  E[k][q] = tw'[k][q] * sum_m Y[k*128 + m] W128^(-mq)
//            x[p*128 + q] = sum_k E[k][q] w1'[k][p]            (natural).
//
// What bounds them: the transform needs ~5*log2(n) flops an element and
// axis against 12-16 bytes moved, so on this card (67 TFLOP/s FP32,
// 3.35 TB/s) its bound is the bytes. A dense 128-point stage 2 (128
// complex multiply-adds an element) would instead be bound by issuing its
// loads, a shared-memory operand and a table entry for every multiply-add,
// so every stage 2 here is the radix FFT of fft128.cuh (16 x 8 in
// registers, one exchange through shared memory, ~2.7 kflop a transform
// instead of 131). Stage 1 (n1 <= 24 points, any length) is dense, from
// registers: a thread holds the n1 values of one q.
//
// Per kernel:
// - K6 (x, contiguous; merfish3d_tpu/ops/pfft.py dft_trailing): one
//   launch of K10's x pass below over the `rows` lines.
// - K7 (y, stride nx; merfish3d_tpu/ops/pfft.py dft_middle). The TPU
//   kernel holds whole y columns in VMEM and runs both stages as MXU
//   matmuls; here a column (n*8 B, 17 KB at n = 2176) times the 32 x
//   columns a coalesced access needs would be more than a block's shared
//   memory. So K7 is two launches, each a streaming pass:
//   pass A (dft_middle_a): stage 1 from registers, one thread a (z, q, x)
//     with lanes along x (128 B a warp access), so w1 and the twiddle are
//     warp-uniform loads. Forward: with the twiddle, natural order in.
//     Inverse: the n1-point synthesis to natural order, in place.
//   pass B (dft_middle_b): one block a (z, group k, 32-column tile): the
//     128 x 32 tile is staged transposed (mid_stage: a column's 128-group
//     contiguous at an odd stride of 129 float2, so the row-wise stores of
//     a half-warp hit 16 bank pairs), then 32 fft128::transforms, 8 lanes
//     each, four a warp (mid_transform); the two groups of a half-warp are
//     columns 8 apart, 8 bank pairs apart, so the transform's accesses are
//     conflict-free too. 33 KB of shared memory a block, so several blocks
//     an SM at every length. Inverse: the conjugate twiddle (1/n folded
//     in) on the way out (mid_store).
//   Forward: pass A into the output, pass B in place on it. Inverse:
//   pass B into the output, pass A in place; the intermediate is
//   complex, so the output's imaginary plane is written as scratch even
//   when only the real part is returned. 32 B an element move in all
//   (twice the one-pass bound).
// - K9 (y; forward, OTF product, inverse; merfish3d_tpu/ops/pfft.py
//   dft_mid_conv). The TPU kernel keeps a y column group in VMEM through
//   both transforms. Here it is three streaming launches built from K7's
//   pieces: pass A forward into the output; pass B conv (dft_mid_conv_b)
//   in place, one block a (z, group k, 32-column tile) as K7's pass B:
//   stage, forward transform, the product with the OTF at the spectrum's
//   own (z, k*128 + m, x) coordinates read in the staging's 128 B row
//   pattern, inverse transform, the conjugate twiddle (1/n folded in) on
//   the way out; then pass A inverse in place. 56 B an element move
//   (against 24 for a one-pass form); the flops are far below the FP32
//   peak's time.
// - K8 (z, stride plane; merfish3d_tpu/ops/pfft.py dft_leading), by the
//   length alone (ops/pfft.py leading_route): for n = R*M <= 64 with M
//   in {8, 16}, dft_lead_radix holds one (y, x) column a thread in
//   registers, lanes along the plane (each of the n row accesses of a warp
//   is one 128 B transaction, 2n loads in flight a thread): R M-point
//   radix DFTs (fft128.cuh's dft8 / dft16), the inter-stage twiddle, then
//   M dense R-point DFTs, from one warp-uniform table; no shared memory.
//   A column of 80 or 96 spills its registers, so those and every other
//   length are one launch of K10's z pass, the same dense DFT along
//   axis 0. 16 B an element with complex input and output.
// - K10 (z and x of a (z, y, x) volume; merfish3d_tpu/ops/pfft.py dft_zx,
//   _dft_zx_fwd_kernel / _dft_zx_inv_kernel). The TPU kernel keeps a
//   whole (nz, nx) plane in VMEM and runs both 128-point stages as MXU
//   matmuls. On this card a plane is 114-450 KB for the shapes
//   zx_supported admits, more than a block's shared memory. So K10 is
//   two launches in one call, each memory-bound:
//   x pass (dft_zx_x): one line a block of four warps. Stage 1 and the
//     twiddle run from registers (a thread a q); the n1 128-point
//     transforms are fft128::transform (4 a warp at a time, 8 lanes each)
//     on the line's slab in shared memory (n1 x 136 float2, 4.25 KB per
//     n1, <= 25.5 KB); lines are read and written whole and coalesced.
//     Registers, not shared memory, bound the blocks an SM: at most 80 a
//     thread for six blocks (24 warps; the forward spills a few values to
//     L1 for it). A warp a line with four lines a block, the first design,
//     fit only three blocks (12 warps) an SM at n1 = 17 (74 KB each) and
//     measured slower at n1 = 15, 17 and 24, as fast at n1 = 9.
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

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
}

// ---------------------------------------------------------------- K10
constexpr int ZX_WARPS = 4;       // warps of an x-pass block (one line)
constexpr int ZX_GS = LANE + 8;   // a 128-group's stride in shared memory (bank offset)
constexpr int ZX_COLS = 64;       // columns per z-pass block, two a lane
constexpr int ZX_KT = 8;          // outputs a z-pass warp accumulates at once
constexpr int ZX_ZWARPS = 8;      // the most warps a z-pass block has

// x pass: the Cooley-Tukey DFT of `rows` contiguous lines of n1*128, a
// line a block of ZX_WARPS warps. Forward: natural order in, scrambled
// out (position k*128 + m holds frequency n1*m + k). Inverse: scrambled
// in, natural out, 1/n in tw; write_imag = 0 drops the imaginary output.
// In place is allowed: the line is read whole before it is written.
template <bool INV>
__global__ void __launch_bounds__(ZX_WARPS * 32, 6)
dft_zx_x(const float* xr, const float* xi, float* yr, float* yi, const float2* __restrict__ w1,
         const float2* __restrict__ tw, const float2* __restrict__ w128, int n1, int write_imag) {
    static_assert(ZX_WARPS * 32 == LANE, "a thread a q");
    extern __shared__ float2 S[];  // group k at S + k*ZX_GS
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = threadIdx.x;
    const int n = n1 * LANE;
    const long long base = static_cast<long long>(blockIdx.x) * n;
    if (!INV) {
        // stage 1 + twiddle: C[k][q] = tw[k][q] * sum_p x[p*128 + q] w1[k][p]
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
    } else {
        for (int s = q; s < n; s += LANE)
            S[(s >> 7) * ZX_GS + (s & (LANE - 1))] = make_float2(xr[base + s], xi ? xi[base + s] : 0.f);
    }
    __syncthreads();
    // the n1 128-point transforms, four a warp at a time, eight lanes each
    const int g = lane >> 3, t = lane & 7;
    for (int k0 = 4 * warp; k0 < n1; k0 += 4 * ZX_WARPS) {
        const int k = k0 + g;
        fft128::transform<INV>(S + (k < n1 ? k : 0) * ZX_GS, t, k < n1, w128);
    }
    __syncthreads();
    if (!INV) {
        for (int s = q; s < n; s += LANE) {
            const float2 v = S[(s >> 7) * ZX_GS + (s & (LANE - 1))];
            yr[base + s] = v.x;
            yi[base + s] = v.y;
        }
    } else {
        // conjugate twiddle (1/n folded in), then the n1-point synthesis:
        // x[p*128 + q] = sum_k E[k][q] w1[k][p], natural order
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

// ---------------------------------------------------------------- K7
constexpr int MID_A_WARPS = 8;               // pass A: q values a block, one a warp
constexpr int MID_B_COLS = 32;               // pass B: x columns a block, one transform each
constexpr int MID_B_WARPS = MID_B_COLS / 4;  // four transforms a warp
constexpr int MID_B_GS = LANE + 1;           // a column's stride in shared memory (odd)

// pass A: the n1-point stage along y of an (nz, n1*128, nx) pair, one
// thread a (z, q, x) column of n1 values 128 rows apart, lanes along x.
// Forward: y[k*128 + q] = tw[k][q] * sum_p x[p*128 + q] w1[k][p] (natural
// order in). Inverse: y[p*128 + q] = sum_k x[k*128 + q] w1[k][p] (natural
// order out; the twiddle is pass B's); write_imag = 0 drops the imaginary
// output. xi null reads zeros. In place is allowed: a thread reads its n1
// values before it writes.
template <bool INV>
__global__ void __launch_bounds__(MID_A_WARPS * 32)
dft_middle_a(const float* xr, const float* xi, float* yr, float* yi, const float2* __restrict__ w1,
             const float2* __restrict__ tw, int n1, int nx, int write_imag) {
    constexpr int QBLOCKS = LANE / MID_A_WARPS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int xtiles = nx >> 5;
    const long long zq = blockIdx.x / xtiles;  // z * QBLOCKS + q block
    const long long z = zq / QBLOCKS;
    const int q = static_cast<int>(zq % QBLOCKS) * MID_A_WARPS + warp;
    const long long rs = static_cast<long long>(LANE) * nx;  // 128 rows
    const long long base = z * n1 * rs + static_cast<long long>(q) * nx + (blockIdx.x % xtiles) * 32 + lane;
    float2 v[MAX_N1];
#pragma unroll
    for (int p = 0; p < MAX_N1; ++p) {
        if (p < n1) {
            const long long o = base + p * rs;
            v[p] = make_float2(xr[o], xi ? xi[o] : 0.f);
        }
    }
    for (int k = 0; k < n1; ++k) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int p = 0; p < MAX_N1; ++p)
            if (p < n1) cmac(acc, v[p], __ldg(&w1[k * n1 + p]));
        if (!INV) acc = cmul(acc, __ldg(&tw[k * LANE + q]));
        const long long o = base + k * rs;
        yr[o] = acc.x;
        if (!INV || write_imag) yi[o] = acc.y;
    }
}

// Pass B's three steps on one tile: MID_B_COLS adjacent columns of one
// 128-row group, rows base + r*nx (r < 128) of each plane, held
// transposed in S (column c at S + c*MID_B_GS). All MID_B_WARPS warps of
// the block call each step together; the caller puts a barrier between
// steps. K7's pass B and K9's conv pass share them.

// stage: row r into column `lane`; at the odd stride a half-warp's stores
// hit 16 bank pairs. xi null reads zeros.
__device__ __forceinline__ void mid_stage(const float* xr, const float* xi, long long base, int nx,
                                          float2* S) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < LANE / MID_B_WARPS; ++i) {
        const int r = warp + i * MID_B_WARPS;
        const long long o = base + static_cast<long long>(r) * nx + lane;
        S[lane * MID_B_GS + r] = make_float2(xr[o], xi ? xi[o] : 0.f);
    }
}

// transform: the tile's 32 128-point FFTs, four a warp, 8 lanes each; the
// two of a half-warp are columns c and c + 8, whose groups start 8 bank
// pairs apart
template <bool INV>
__device__ __forceinline__ void mid_transform(float2* S, const float2* __restrict__ w128) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 3, pair = 2 * warp + (g >> 1);
    const int col = (pair & 7) + 16 * (pair >> 3) + 8 * (g & 1);
    fft128::transform<INV>(S + col * MID_B_GS, lane & 7, true, w128);
}

// store: the tile back to the rows, output q times tw_k[q] where tw_k is
// not null
__device__ __forceinline__ void mid_store(const float2* S, float* yr, float* yi, long long base, int nx,
                                          const float2* __restrict__ tw_k) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < LANE / MID_B_WARPS; ++i) {
        const int r = warp + i * MID_B_WARPS;
        float2 v = S[lane * MID_B_GS + r];
        if (tw_k) v = cmul(v, __ldg(&tw_k[r]));
        const long long o = base + static_cast<long long>(r) * nx + lane;
        yr[o] = v.x;
        yi[o] = v.y;
    }
}

// A pass-B block's tile: (z, group k, 32-column tile) of blockIdx.x;
// returns the tile's first element and sets k.
__device__ __forceinline__ long long mid_tile(int n1, int nx, int& k) {
    const int tiles = nx / MID_B_COLS;
    const long long zk = blockIdx.x / tiles;  // z * n1 + k
    k = static_cast<int>(zk % n1);
    return zk * LANE * nx + (blockIdx.x % tiles) * MID_B_COLS;
}

// pass B: forward X[k*128 + m] from C[k][q] (scrambled order out); inverse
// E[k][q] = tw'[k][q] times the inverse FFT of Y[k*128 + m]. In place is
// allowed: every read precedes the first barrier.
template <bool INV>
__global__ void __launch_bounds__(MID_B_WARPS * 32)
dft_middle_b(const float* xr, const float* xi, float* yr, float* yi, const float2* __restrict__ tw,
             const float2* __restrict__ w128, int n1, int nx) {
    __shared__ float2 S[MID_B_COLS * MID_B_GS];
    int k;
    const long long base = mid_tile(n1, nx, k);
    mid_stage(xr, xi, base, nx, S);
    __syncthreads();
    mid_transform<INV>(S, w128);
    __syncthreads();
    mid_store(S, yr, yi, base, nx, INV ? tw + k * LANE : nullptr);
}

// ---------------------------------------------------------------- K9
// pass B conv, in place on pass A's output y: the forward 128-point FFTs
// of the tile (spectrum positions k*128 + m), the product with the OTF h
// at the same coordinates, the inverse FFTs, the conjugate twiddle twi
// (1/n folded in) on the way out.
__global__ void __launch_bounds__(MID_B_WARPS * 32)
dft_mid_conv_b(float* yr, float* yi, const float* __restrict__ hr, const float* __restrict__ hi,
               const float2* __restrict__ twi, const float2* __restrict__ w128f,
               const float2* __restrict__ w128i, int n1, int nx) {
    __shared__ float2 S[MID_B_COLS * MID_B_GS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int k;
    const long long base = mid_tile(n1, nx, k);
    mid_stage(yr, yi, base, nx, S);
    __syncthreads();
    mid_transform<false>(S, w128f);
    __syncthreads();
    // the OTF product, in the staging's row pattern (128 B a warp access)
#pragma unroll
    for (int i = 0; i < LANE / MID_B_WARPS; ++i) {
        const int r = warp + i * MID_B_WARPS;
        const long long o = base + static_cast<long long>(r) * nx + lane;
        float2& v = S[lane * MID_B_GS + r];
        v = cmul(v, make_float2(hr[o], hi[o]));
    }
    __syncthreads();
    mid_transform<true>(S, w128i);
    __syncthreads();
    mid_store(S, yr, yi, base, nx, twi + k * LANE);
}

// ---------------------------------------------------------------- K8
constexpr int LEAD_THREADS = 128;

template <int M, bool INV>
__device__ __forceinline__ void dft_radix(float2 (&v)[M]) {
    static_assert(M == 8 || M == 16, "radix 8 or 16");
    if constexpr (M == 8)
        fft128::dft8<INV>(v);
    else
        fft128::dft16<INV>(v);
}

// The n-point DFT (n = R*M) along axis 0 of an (n, plane) pair, one
// column c a thread, natural order in and out. Input j = R*j2 + j1,
// output k = k1 + M*k2:
//   U[j1][k1] = W_n^(j1 k1) * sum_j2 x[R j2 + j1] W_M^(j2 k1)   (R radix DFTs)
//   X[k1 + M k2] = sum_j1 U[j1][k1] W_R^(j1 k2)                   (M dense R-point DFTs)
// tab: W_n^(j1 k1) at j1*M + k1 (R*M entries), then W_R^(j1 k2) at
// R*M + j1*R + k2 (R*R, times 1/n for the inverse); warp-uniform reads.
// xi null reads zeros; yi null skips the imaginary output.
template <int R, int M, bool INV>
__global__ void __launch_bounds__(LEAD_THREADS)
dft_lead_radix(const float* xr, const float* xi, float* yr, float* yi,
               const float2* __restrict__ tab, long long plane) {
    const long long c = static_cast<long long>(blockIdx.x) * LEAD_THREADS + threadIdx.x;
    if (c >= plane) return;
    float2 u[R][M];
#pragma unroll
    for (int j1 = 0; j1 < R; ++j1)
#pragma unroll
        for (int j2 = 0; j2 < M; ++j2) {
            const long long o = static_cast<long long>(R * j2 + j1) * plane + c;
            u[j1][j2] = make_float2(xr[o], xi ? xi[o] : 0.f);
        }
#pragma unroll
    for (int j1 = 0; j1 < R; ++j1) {
        dft_radix<M, INV>(u[j1]);
        if (j1 > 0) {
#pragma unroll
            for (int k1 = 1; k1 < M; ++k1) u[j1][k1] = cmul(u[j1][k1], __ldg(&tab[j1 * M + k1]));
        }
    }
    const float2* wr = tab + R * M;
#pragma unroll
    for (int k1 = 0; k1 < M; ++k1) {
#pragma unroll
        for (int k2 = 0; k2 < R; ++k2) {
            float2 acc = make_float2(0.f, 0.f);
#pragma unroll
            for (int j1 = 0; j1 < R; ++j1) cmac(acc, u[j1][k1], __ldg(&wr[j1 * R + k2]));
            const long long o = static_cast<long long>(k1 + M * k2) * plane + c;
            yr[o] = acc.x;
            if (yi) yi[o] = acc.y;
        }
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

// the x pass over `rows` contiguous lines: K6, and K10's x pass
cudaError_t launch_rows(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
                        const float2* tw, const float2* w128, long long rows, int n1, bool inverse,
                        int write_imag, cudaStream_t s) {
    const size_t smem = static_cast<size_t>(n1) * ZX_GS * sizeof(float2);
    auto kernel = inverse ? dft_zx_x<true> : dft_zx_x<false>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(rows), ZX_WARPS * 32, smem, s>>>(xr, xi, yr, yi, w1, tw, w128, n1,
                                                                    write_imag);
    return cudaGetLastError();
}

// the z pass over an (nz, plane) pair: K10's z pass, and K8's dense route
cudaError_t launch_z(const float* xr, const float* xi, float* yr, float* yi, const float4* wz, int nz,
                     int nzp, long long plane, cudaStream_t s) {
    const int warps = (nz + ZX_KT - 1) / ZX_KT < ZX_ZWARPS ? (nz + ZX_KT - 1) / ZX_KT : ZX_ZWARPS;
    const size_t smem = static_cast<size_t>(nz) * ZX_COLS * sizeof(float2);
    const cudaError_t err = allow_smem(dft_zx_z, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = static_cast<unsigned>((plane + ZX_COLS - 1) / ZX_COLS);
    dft_zx_z<<<blocks, warps * 32, smem, s>>>(xr, xi, yr, yi, wz, nz, nzp, plane);
    return cudaGetLastError();
}

template <int R, int M>
cudaError_t launch_lead_radix(const float* xr, const float* xi, float* yr, float* yi, const float2* tab,
                              long long plane, bool inverse, cudaStream_t s) {
    const unsigned blocks = static_cast<unsigned>((plane + LEAD_THREADS - 1) / LEAD_THREADS);
    if (inverse)
        dft_lead_radix<R, M, true><<<blocks, LEAD_THREADS, 0, s>>>(xr, xi, yr, yi, tab, plane);
    else
        dft_lead_radix<R, M, false><<<blocks, LEAD_THREADS, 0, s>>>(xr, xi, yr, yi, tab, plane);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// K6: one launch of the x pass; yi may be null when real_out drops the
// inverse's imaginary output.
int dft_trailing_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w1,
                     const void* tw, const void* w128, long long rows, int n1, int inverse,
                     int real_out, void* stream) {
    return launch_rows(xr, xi, yr, yi, static_cast<const float2*>(w1), static_cast<const float2*>(tw),
                       static_cast<const float2*>(w128), rows, n1, inverse != 0,
                       (inverse && real_out) ? 0 : 1, static_cast<cudaStream_t>(stream));
}

// K7: two launches on one stream (see the note at the top). yi is
// written in full in both directions: with real_out it is the inverse's
// scratch.
int dft_middle_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w1,
                   const void* tw, const void* w128, int nz, int n1, int nx, int inverse,
                   int real_out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2 *c1 = static_cast<const float2*>(w1), *ct = static_cast<const float2*>(tw),
                 *c128 = static_cast<const float2*>(w128);
    const unsigned blocks_a = static_cast<unsigned>(nz) * (LANE / MID_A_WARPS) * (nx / 32);
    const unsigned blocks_b = static_cast<unsigned>(nz) * n1 * (nx / MID_B_COLS);
    if (inverse) {
        dft_middle_b<true><<<blocks_b, MID_B_WARPS * 32, 0, s>>>(xr, xi, yr, yi, ct, c128, n1, nx);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        dft_middle_a<true><<<blocks_a, MID_A_WARPS * 32, 0, s>>>(yr, yi, yr, yi, c1, ct, n1, nx,
                                                                  real_out ? 0 : 1);
    } else {
        dft_middle_a<false><<<blocks_a, MID_A_WARPS * 32, 0, s>>>(xr, xi, yr, yi, c1, ct, n1, nx, 1);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        dft_middle_b<false><<<blocks_b, MID_B_WARPS * 32, 0, s>>>(yr, yi, yr, yi, ct, c128, n1, nx);
    }
    return cudaGetLastError();
}

// K8: one launch, by the length (ops/pfft.py leading_route): radix M
// (8 or 16) takes dft_lead_radix with K8's radix table w; radix 0 takes
// the z pass with the dense table w, zero-padded to rows of nzp. yi null
// drops the inverse's imaginary output. A length the radix route does not
// instantiate returns cudaErrorInvalidValue.
int dft_leading_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w, int n,
                    int radix, int nzp, long long plane, int inverse, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* tab = static_cast<const float2*>(w);
    const bool inv = inverse != 0;
    if (radix == 0) return launch_z(xr, xi, yr, yi, static_cast<const float4*>(w), n, nzp, plane, s);
    if (radix == 8) {
        switch (n) {
            case 8: return launch_lead_radix<1, 8>(xr, xi, yr, yi, tab, plane, inv, s);
            case 24: return launch_lead_radix<3, 8>(xr, xi, yr, yi, tab, plane, inv, s);
            case 40: return launch_lead_radix<5, 8>(xr, xi, yr, yi, tab, plane, inv, s);
        }
    } else if (radix == 16) {
        switch (n) {
            case 16: return launch_lead_radix<1, 16>(xr, xi, yr, yi, tab, plane, inv, s);
            case 32: return launch_lead_radix<2, 16>(xr, xi, yr, yi, tab, plane, inv, s);
            case 48: return launch_lead_radix<3, 16>(xr, xi, yr, yi, tab, plane, inv, s);
            case 64: return launch_lead_radix<4, 16>(xr, xi, yr, yi, tab, plane, inv, s);
        }
    }
    return cudaErrorInvalidValue;
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
    const long long rows = static_cast<long long>(nz) * ny;
    const long long plane = static_cast<long long>(ny) * n1 * LANE;
    if (inverse) {
        const cudaError_t err = launch_z(xr, xi, yr, yi, cz, nz, nzp, plane, s);
        if (err != cudaSuccess) return err;
        return launch_rows(yr, yi, yr, yi, c1, ct, c128, rows, n1, true, real_out ? 0 : 1, s);
    }
    const cudaError_t err = launch_rows(xr, xi, yr, yi, c1, ct, c128, rows, n1, false, 1, s);
    if (err != cudaSuccess) return err;
    return launch_z(yr, yi, yr, yi, cz, nz, nzp, plane, s);
}

// K9: three launches on one stream (see the note at the top): pass A
// forward into y, pass B conv in place, pass A inverse in place. The
// tables are K7's, forward (w1f, twf, w128f) and inverse (w1i, twi, w128i).
int dft_mid_conv_f32(const float* xr, const float* xi, const float* hr, const float* hi, float* yr,
                     float* yi, const void* w1f, const void* twf, const void* w128f, const void* w1i,
                     const void* twi, const void* w128i, int nz, int n1, int nx, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned blocks_a = static_cast<unsigned>(nz) * (LANE / MID_A_WARPS) * (nx / 32);
    const unsigned blocks_b = static_cast<unsigned>(nz) * n1 * (nx / MID_B_COLS);
    dft_middle_a<false><<<blocks_a, MID_A_WARPS * 32, 0, s>>>(
        xr, xi, yr, yi, static_cast<const float2*>(w1f), static_cast<const float2*>(twf), n1, nx, 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dft_mid_conv_b<<<blocks_b, MID_B_WARPS * 32, 0, s>>>(
        yr, yi, hr, hi, static_cast<const float2*>(twi), static_cast<const float2*>(w128f),
        static_cast<const float2*>(w128i), n1, nx);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dft_middle_a<true><<<blocks_a, MID_A_WARPS * 32, 0, s>>>(
        yr, yi, yr, yi, static_cast<const float2*>(w1i), static_cast<const float2*>(twi), n1, nx, 1);
    return cudaGetLastError();
}

}  // extern "C"
