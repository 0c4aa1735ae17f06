// Fused elementwise passes of the RLGC iteration (ops/rlgc_kernels.py),
// for Hopper.
//
// Replaces the Pallas kernels of merfish3d_tpu/ops/rlgc_kernels.py:
//   K4 ratio_kld      (_ratio_kld_kernel)
//   K5 update_select  (_update_select_kernel)
//
// Between its FFT convolutions an RLGC iteration runs two elementwise
// chains with reductions: the update ratios and the six partial sums of
// both split KLDs (K4), and the consensus-gated update, the restore select
// and the convergence statistics (K5). Each kernel is one pass: every
// input is read once and every output written once, so it is bound by
// bytes (K4 moves 20 B a voxel, K5 24 B; each does ~20 operations a voxel
// including two logf, far under the FP32 rate).
//
// The observed-region mask comes from index arithmetic on the static pad
// bounds, as the TPU kernel's iota mask does: it costs no memory traffic.
// A block owns whole rows of the (nz*ny, nx) view, one 16-byte quad of x
// a thread (nx is a multiple of 128, so a row is a whole number of warps),
// and walks rows with a fixed grid stride; the row's (z, y) mask is one
// division a row.
//
// Reductions are deterministic: each block folds its threads' partials in
// a fixed order (K4 in FP64) and writes one row of partials; the caller
// folds those rows (torch.sum in FP64, an integer sum, a max). No float
// atomics, so a solve on the card repeats exactly. K5 counts updated
// voxels as an integer: an f32 count is inexact past 2^24 voxels, and a
// production volume holds 42 M.
//
// Plain C entry points; each returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr float EPS_KLD = 1e-4f;
constexpr int MAX_WARPS = 32;

struct Bounds {
    int nz, ny, nx, zb, za, yb, ya, xb, xa;
    __device__ bool row_in(long long row) const {
        const int z = static_cast<int>(row / ny), y = static_cast<int>(row - static_cast<long long>(z) * ny);
        return z >= zb && z < nz - za && y >= yb && y < ny - ya;
    }
    __device__ bool col_in(int x) const { return x >= xb && x < nx - xa; }
};

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
    return v;
}

// ---------------------------------------------------------------- K4
struct KldTerms {
    double p = 0.0, q1 = 0.0, q2 = 0.0, pk = 0.0, t1 = 0.0, t2 = 0.0;
};

// one voxel: both ratios, and its terms of the six KLD sums
__device__ __forceinline__ void ratio_kld_voxel(float h, float a, float b, bool m, float& r1,
                                                float& r2, KldTerms& acc) {
    const float mf = m ? 1.f : 0.f;
    const float denom = 0.5f * (h + 1e-12f);
    r1 = mf * (a / denom);
    r2 = mf * (b / denom);
    const float hp = h + EPS_KLD;
    const float p = hp * mf;
    acc.p += p;
    acc.q1 += (a + EPS_KLD) * mf;
    acc.q2 += (b + EPS_KLD) * mf;
    // the terms the reference keeps: in the mask and p > 0 (its NaN -> 0
    // zeroing drops exactly the p <= 0 entries)
    if (m && hp > 0.f) {
        const float lg = logf(hp);
        acc.pk += p;
        acc.t1 += p * (lg - logf(a + EPS_KLD));
        acc.t2 += p * (lg - logf(b + EPS_KLD));
    }
}

__global__ void ratio_kld_k(const float4* hu, const float4* s1, const float4* s2, float4* r1,
                            float4* r2, double* partials, long long rows, Bounds bd) {
    const int nq = bd.nx / 4;
    KldTerms acc;
    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
        const bool row_in = bd.row_in(row);
        for (int qx = threadIdx.x; qx < nq; qx += blockDim.x) {
            const long long i = row * nq + qx;
            const float4 h = hu[i], a = s1[i], b = s2[i];
            float4 o1, o2;
            const int x = 4 * qx;
            ratio_kld_voxel(h.x, a.x, b.x, row_in && bd.col_in(x), o1.x, o2.x, acc);
            ratio_kld_voxel(h.y, a.y, b.y, row_in && bd.col_in(x + 1), o1.y, o2.y, acc);
            ratio_kld_voxel(h.z, a.z, b.z, row_in && bd.col_in(x + 2), o1.z, o2.z, acc);
            ratio_kld_voxel(h.w, a.w, b.w, row_in && bd.col_in(x + 3), o1.w, o2.w, acc);
            r1[i] = o1;
            r2[i] = o2;
        }
    }
    __shared__ double red[MAX_WARPS][6];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    double v[6] = {acc.p, acc.q1, acc.q2, acc.pk, acc.t1, acc.t2};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        v[k] = warp_sum(v[k]);
        if (lane == 0) red[warp][k] = v[k];
    }
    __syncthreads();
    if (threadIdx.x < 6) {
        double s = 0.0;
        for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += red[w][threadIdx.x];
        partials[blockIdx.x * 6 + threadIdx.x] = s;
    }
}

// ---------------------------------------------------------------- K5
struct UpdateStats {
    unsigned long long count = 0;
    float max_new = -INFINITY, max_delta = -INFINITY;
};

__device__ __forceinline__ void update_voxel(float c, float rec, float prev, float ht, bool restore,
                                             bool m, float& nr, float& np, UpdateStats& st) {
    const float mf = m ? 1.f : 0.f;
    const float upd = c < 0.f ? rec : rec * ht;
    nr = restore ? prev : upd;
    np = restore ? prev : rec;
    st.count += (m && c >= 0.f) ? 1ull : 0ull;
    st.max_new = fmaxf(st.max_new, upd * mf);
    st.max_delta = fmaxf(st.max_delta, fabsf(upd - rec) * mf);
}

__global__ void update_select_k(const float4* cons, const float4* recon, const float4* prev,
                                const float4* ht, const int* flag, float4* new_recon,
                                float4* new_prev, unsigned long long* counts, float* maxima,
                                long long rows, Bounds bd) {
    const int nq = bd.nx / 4;
    const bool restore = *flag != 0;
    UpdateStats st;
    for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
        const bool row_in = bd.row_in(row);
        for (int qx = threadIdx.x; qx < nq; qx += blockDim.x) {
            const long long i = row * nq + qx;
            const float4 c = cons[i], r = recon[i], p = prev[i], h = ht[i];
            float4 o1, o2;
            const int x = 4 * qx;
            update_voxel(c.x, r.x, p.x, h.x, restore, row_in && bd.col_in(x), o1.x, o2.x, st);
            update_voxel(c.y, r.y, p.y, h.y, restore, row_in && bd.col_in(x + 1), o1.y, o2.y, st);
            update_voxel(c.z, r.z, p.z, h.z, restore, row_in && bd.col_in(x + 2), o1.z, o2.z, st);
            update_voxel(c.w, r.w, p.w, h.w, restore, row_in && bd.col_in(x + 3), o1.w, o2.w, st);
            new_recon[i] = o1;
            new_prev[i] = o2;
        }
    }
    __shared__ unsigned long long red_n[MAX_WARPS];
    __shared__ float red_m[MAX_WARPS][2];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned long long n = warp_sum(st.count);
    const float mn = warp_max(st.max_new), md = warp_max(st.max_delta);
    if (lane == 0) {
        red_n[warp] = n;
        red_m[warp][0] = mn;
        red_m[warp][1] = md;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long total = 0;
        float a = -INFINITY, b = -INFINITY;
        for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
            total += red_n[w];
            a = fmaxf(a, red_m[w][0]);
            b = fmaxf(b, red_m[w][1]);
        }
        counts[blockIdx.x] = total;
        maxima[blockIdx.x * 2] = a;
        maxima[blockIdx.x * 2 + 1] = b;
    }
}

}  // namespace

extern "C" {

// threads = min(nx / 4, 1024), a multiple of 32; blocks as the wrapper
// allocated partial rows for
int ratio_kld_f32(const float* hu, const float* s1, const float* s2, float* r1, float* r2,
                  double* partials, int nz, int ny, int nx, int zb, int za, int yb, int ya, int xb,
                  int xa, int blocks, int threads, void* stream) {
    const Bounds bd{nz, ny, nx, zb, za, yb, ya, xb, xa};
    ratio_kld_k<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(hu), reinterpret_cast<const float4*>(s1),
        reinterpret_cast<const float4*>(s2), reinterpret_cast<float4*>(r1),
        reinterpret_cast<float4*>(r2), partials, static_cast<long long>(nz) * ny, bd);
    return cudaGetLastError();
}

int update_select_f32(const float* cons, const float* recon, const float* prev, const float* ht,
                      const int* flag, float* new_recon, float* new_prev,
                      unsigned long long* counts, float* maxima, int nz, int ny, int nx, int zb,
                      int za, int yb, int ya, int xb, int xa, int blocks, int threads,
                      void* stream) {
    const Bounds bd{nz, ny, nx, zb, za, yb, ya, xb, xa};
    update_select_k<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(cons), reinterpret_cast<const float4*>(recon),
        reinterpret_cast<const float4*>(prev), reinterpret_cast<const float4*>(ht), flag,
        reinterpret_cast<float4*>(new_recon), reinterpret_cast<float4*>(new_prev), counts, maxima,
        static_cast<long long>(nz) * ny, bd);
    return cudaGetLastError();
}

}  // extern "C"
