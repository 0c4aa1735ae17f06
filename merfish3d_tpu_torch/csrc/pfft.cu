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
// wz (n, n)) are complex64, built on the host in double precision and
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
// What bounds them: a line's stage 2 is a dense 128-point DFT, 128
// complex multiply-adds per element (~8*(n1 + 128) flops per element and
// axis), well above the 12-16 bytes an element moves; at the card's 67
// TFLOP/s FP32 this design's flops take ~4x the memory bound (3.35 TB/s).
// The transform itself needs only ~5*log2(n) flops per element and axis,
// so its bound on this card is the memory bound. The
// design keeps every operand of those sums on chip: a block stages its
// lines in shared memory once, stage 1 runs from registers (a thread owns
// one q of a line and holds its n1 <= 24 inputs), stage 2 reads the staged
// line as a warp broadcast and w2 through the read-only cache. A radix-2/4
// stage 2 would cut the flops ~20x; that is later work.
//
// Per kernel:
// - K6 (x, contiguous): 2 rows per block, shared memory 2*n*8 B <= 48 KB.
// - K7 (y, stride nx): a block holds 8 adjacent x columns of one z plane,
//   threads run along x so every global access of a warp is 32 B lines;
//   shared memory n*8*8 B <= 192 KB at n = 3072.
// - K8 (z dense): a block holds 64 adjacent (y, x) columns, n*64*8 B
//   <= 48 KB; the (n, n) matrix is read through the read-only cache.
// - K10 (z + x in one launch): one block per y row. The TPU kernel keeps
//   the whole (nz, nx) plane in VMEM; here the plane is 114 KB at the
//   production crop (16, 896) but up to ~440 KB for planes zx_supported
//   admits (18 x 3072, 73 x 768). So the block runs the x pass over
//   chunks of zc rows, writes them to the output (still L2-resident, 50
//   MB), and then runs the z pass over chunks of sc columns read back from
//   there; zc and sc (ops/pfft.py zx_chunks) fit a 200 KB budget, which
//   is the gate: every admitted plane runs in one launch, and one chunk of
//   each covers the whole production plane.
//
// Plain C entry points; each returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

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
__device__ Lines zx_rows(int y, int ny, int n1, int z0, int zc, int nz) {
    const long long nx = n1 * LANE;
    const long long plane = ny * nx;
    return Lines{z0 * plane + y * nx, plane, 1, zc, (nz - z0) < zc ? nz - z0 : zc};
}

__global__ void __launch_bounds__(THREADS)
dft_zx_fwd(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
           const float2* tw, const float2* w2, const float2* wz, int nz, int ny, int n1, int zc,
           int sc) {
    extern __shared__ float2 smem[];
    const int y = blockIdx.x, nx = n1 * LANE;
    const long long plane = static_cast<long long>(ny) * nx;
    // x pass (Cooley-Tukey) on zc rows at a time, into the output
    for (int z0 = 0; z0 < nz; z0 += zc) {
        const Lines g = zx_rows(y, ny, n1, z0, zc, nz);
        ct_fwd_stage1(xr, xi, g, n1, w1, tw, smem);
        __syncthreads();
        ct_fwd_stage2(smem, g, n1, w2, yr, yi);
        __syncthreads();
    }
    // z pass (dense) on sc columns at a time, in place on the output
    for (int s0 = 0; s0 < nx; s0 += sc)
        dense_cols(yr, yi, yr, yi, nz, plane, static_cast<long long>(y) * nx + s0,
                   (nx - s0) < sc ? nx - s0 : sc, sc, wz, smem);
}

__global__ void __launch_bounds__(THREADS)
dft_zx_inv(const float* xr, const float* xi, float* yr, float* yi, const float2* w1,
           const float2* tw, const float2* w2, const float2* wz, int nz, int ny, int n1, int zc,
           int sc, int real_out) {
    extern __shared__ float2 smem[];
    const int y = blockIdx.x, nx = n1 * LANE;
    const long long plane = static_cast<long long>(ny) * nx;
    // z pass first, into the output (its imaginary plane is scratch when
    // only the real part is kept)
    for (int s0 = 0; s0 < nx; s0 += sc)
        dense_cols(xr, xi, yr, yi, nz, plane, static_cast<long long>(y) * nx + s0,
                   (nx - s0) < sc ? nx - s0 : sc, sc, wz, smem);
    // then the x pass on zc rows at a time, in place
    for (int z0 = 0; z0 < nz; z0 += zc) {
        const Lines g = zx_rows(y, ny, n1, z0, zc, nz);
        load_lines(yr, yi, g, nx, smem);
        __syncthreads();
        ct_inv(smem, g, n1, w1, tw, w2, yr, real_out ? nullptr : yi);
        __syncthreads();
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

int dft_zx_f32(const float* xr, const float* xi, float* yr, float* yi, const void* w1,
               const void* tw, const void* w2, const void* wz, int nz, int ny, int n1, int zc,
               int sc, int inverse, int real_out, void* stream) {
    const size_t rows = static_cast<size_t>(zc) * n1 * LANE, cols = static_cast<size_t>(nz) * sc;
    const size_t smem = (rows > cols ? rows : cols) * sizeof(float2);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2 *c1 = static_cast<const float2*>(w1), *ct = static_cast<const float2*>(tw),
                 *c2 = static_cast<const float2*>(w2), *cz = static_cast<const float2*>(wz);
    cudaError_t err;
    if (inverse) {
        err = allow_smem(dft_zx_inv, smem);
        if (err != cudaSuccess) return err;
        dft_zx_inv<<<ny, THREADS, smem, s>>>(xr, xi, yr, yi, c1, ct, c2, cz, nz, ny, n1, zc, sc,
                                             real_out);
    } else {
        err = allow_smem(dft_zx_fwd, smem);
        if (err != cudaSuccess) return err;
        dft_zx_fwd<<<ny, THREADS, smem, s>>>(xr, xi, yr, yi, c1, ct, c2, cz, nz, ny, n1, zc, sc);
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
