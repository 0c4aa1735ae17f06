// K1 + K2: separable Gaussian lowpass fused with the nearest-codeword
// decode, in two device-memory passes.
//
// K1 (zy_lowpass_kernel) replaces
//   merfish3d_tpu/ops/fused_decode.py:_zyconv_scan_kernel
// — the y and z passes of the lowpass. The TPU kernel scans y blocks in
// order and carries the halo in VMEM from one grid step to the next; on
// Hopper blocks run in no order, so each thread reads its own y halo
// straight from device memory (neighbouring rows are L1/L2 hits) through
// a host-built symmetric index map (np.pad "symmetric", reflection at the
// true edges). Up to 64 planes, a thread keeps its whole z column of
// y-filtered values in registers (unrolled) and applies the z pass as a
// dense (nz, nz) matrix with the symmetric z pad folded in — the same
// fold the TPU kernel uses, exact for any pad width. A deeper column does
// not fit in registers: zy_lowpass_direct_kernel then sums, for each
// output plane, the y pass of its taps_z input planes through the z index
// map (the y pass is recomputed per z tap; any Z, any pad width).
//
// K2 (x_lowpass_decode_kernel) replaces
//   merfish3d_tpu/ops/fused_decode.py:_xconv_decode_kernel
// — the x pass (symmetric halo through the same kind of index map), then
// (t - bg) / norm, clip to [0, 1], magnitude, unit trace, projection onto
// the L2-normalized codebook, first-maximum argmax (strict >),
// dist = sqrt(max(2 - 2 max, 0)) and assignment by dist <= thr and
// lo <= mag <= hi. Outputs are stored as int16 labels and float16 floats
// (the TPU stored bfloat16 only because Mosaic crashes on f16 stores).
//
// Bound on the H100. K1 moves its bytes at ~18 % of the 3.35 TB/s DRAM
// roofline on the production tile (NVIDIA H100 80GB HBM3, 700 W), so
// memory does not bound it; it does (taps_y + nz) FMAs per voxel with a
// shared-memory read each, and the likely bound is instruction issue (an
// inference: no instruction counter could be read there). Threads map to
// x, so every load and store of a warp touches 32 consecutive addresses;
// each input voxel is read from DRAM once and the halo taps come from
// cache.
//
// K2 is bound by its FP32 operations: (taps_x + words) FMAs a voxel and bit
// (9 + 90 at production) against 4 bytes read. Its decode is the shared
// core of decode_core.cuh (V voxels a thread, V unit traces in registers,
// the packed codebook read as float4 broadcasts). Its x pass: one block a
// (z, y) row segment of 128 * V outputs, a thread V consecutive x. Every
// bit's segment and its taps_x - 1 halo are copied into shared memory by
// cp.async (16 bytes a copy inside the row), all bits in flight together
// with the tables (33 KB of segments at production; fewer bits a set where
// shared memory runs out): a ring of two buffers left one device-memory
// wait a bit exposed. The symmetric pad (any width, also wider than the
// row) is resolved when an element is staged: its source is the row's own
// sample inside the row, else the host-built xmap's reflection; no tap
// reads an index. A thread then reads its V + taps_x - 1 window as float4
// (float2) loads, conflict-free, into registers (taps_x <= 9, the main
// path's sigma_x = 1; more taps read shared memory tap by tap) and sums
// the taps in ascending order with fmaf. Outputs go out as V halves (or V
// int16) a store where nx % V == 0. All arithmetic is FP32 FMA.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "decode_core.cuh"

namespace {

constexpr int kThreadsX = 128;

template <int MAXZ>
__global__ void zy_lowpass_kernel(const float* __restrict__ vol,
                                  const float* __restrict__ wz,
                                  const float* __restrict__ ky,
                                  const int* __restrict__ ymap, int nz, int ny,
                                  int nx, int taps_y, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_wz = smem;                // (nz, nz): out_z = wz @ in_z
  float* s_ky = s_wz + nz * nz;      // (taps_y,)
  int* s_rows = reinterpret_cast<int*>(s_ky + taps_y);  // (taps_y,) input rows
  const int y = blockIdx.y;
  for (int i = threadIdx.x; i < nz * nz; i += blockDim.x) s_wz[i] = wz[i];
  for (int i = threadIdx.x; i < taps_y; i += blockDim.x) {
    s_ky[i] = ky[i];
    s_rows[i] = ymap[y + i];
  }
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;

  const long long plane = (long long)ny * nx;
  const float* vb = vol + (long long)blockIdx.z * nz * plane + x;
  float t[MAXZ];
#pragma unroll
  for (int z = 0; z < MAXZ; ++z) {
    float acc = 0.f;
    if (z < nz) {
      const float* col = vb + (long long)z * plane;
      for (int k = 0; k < taps_y; ++k)
        acc = fmaf(s_ky[k], __ldg(col + (long long)s_rows[k] * nx), acc);
    }
    t[z] = acc;
  }
  float* ob = out + (long long)blockIdx.z * nz * plane + (long long)y * nx + x;
  for (int zo = 0; zo < nz; ++zo) {
    const float* wrow = s_wz + zo * nz;
    float acc = 0.f;
#pragma unroll
    for (int zi = 0; zi < MAXZ; ++zi)
      if (zi < nz) acc = fmaf(wrow[zi], t[zi], acc);
    ob[(long long)zo * plane] = acc;
  }
}

__global__ void zy_lowpass_direct_kernel(
    const float* __restrict__ vol, const float* __restrict__ kz,
    const int* __restrict__ zmap, const float* __restrict__ ky,
    const int* __restrict__ ymap, int nz, int ny, int nx, int taps_z,
    int taps_y, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_kz = smem;                // (taps_z,)
  float* s_ky = s_kz + taps_z;       // (taps_y,)
  int* s_rows = reinterpret_cast<int*>(s_ky + taps_y);  // (taps_y,) input rows
  const int y = blockIdx.y;
  for (int i = threadIdx.x; i < taps_z; i += blockDim.x) s_kz[i] = kz[i];
  for (int i = threadIdx.x; i < taps_y; i += blockDim.x) {
    s_ky[i] = ky[i];
    s_rows[i] = ymap[y + i];
  }
  __syncthreads();
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= nx) return;

  const long long plane = (long long)ny * nx;
  const float* vb = vol + (long long)blockIdx.z * nz * plane + x;
  float* ob = out + (long long)blockIdx.z * nz * plane + (long long)y * nx + x;
  for (int zo = 0; zo < nz; ++zo) {
    float acc = 0.f;
    for (int k = 0; k < taps_z; ++k) {
      const float* col = vb + (long long)__ldg(zmap + zo + k) * plane;
      float t = 0.f;
      for (int j = 0; j < taps_y; ++j)
        t = fmaf(s_ky[j], __ldg(col + (long long)s_rows[j] * nx), t);
      acc = fmaf(s_kz[k], t, acc);
    }
    ob[(long long)zo * plane] = acc;
  }
}

// Stage one bit's row segment: element i is the row's sample at
// x0 + i - r, or, where that falls outside the row, at the symmetric pad's
// source xmap[x0 + i] (r = (taps - 1) / 2; xmap[j] = j - r inside). Four
// elements a copy: one 16-byte copy where all four lie inside the row and
// the source is 16-byte aligned (every interior group at production:
// nx % 4 == 0 and r = 4), else four 4-byte ones. ``buf`` holds
// ceil(nstage / 4) * 4 floats.
__device__ __forceinline__ void stage_row(const float* __restrict__ row,
                                          const int* __restrict__ xmap, int x0,
                                          int r, int nx, int nstage, float* buf) {
  for (int i = 4 * threadIdx.x; i < nstage; i += 4 * kThreadsX) {
    const int src = x0 + i - r;
    if (src >= 0 && src + 4 <= nx && (reinterpret_cast<uintptr_t>(row + src) & 15) == 0) {
      decode_core::cp_async16(buf + i, row + src);
    } else {
      for (int k = i; k < i + 4 && k < nstage; ++k) {
        int sk = x0 + k - r;
        if ((unsigned)sk >= (unsigned)nx) sk = __ldg(xmap + x0 + k);
        decode_core::cp_async4(buf + k, row + sk);
      }
    }
  }
}

// The x pass of V consecutive outputs from the staged segment at ``st``
// (this thread's first output's window): acc[v] = sum over k ascending of
// kx[k] * st[v + k], each an fmaf from +0. TW > 0: the V + TW - 1 values sit
// in registers (read as float4 or float2) and taps <= TW; TW == 0: any
// taps, read from shared memory.
template <int V, int TW>
__device__ __forceinline__ void x_pass(const float* st, const float (&kr)[TW > 0 ? TW : 1],
                                       const float* s_kx, int taps, float (&acc)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if constexpr (TW > 0) {
    constexpr int NW = (V + TW - 1 + V - 1) / V;  // V-wide loads of the window
    float win[NW * V];
#pragma unroll
    for (int c = 0; c < NW; ++c) {
      if constexpr (V == 4) {
        const float4 q = reinterpret_cast<const float4*>(st)[c];
        win[4 * c] = q.x; win[4 * c + 1] = q.y; win[4 * c + 2] = q.z; win[4 * c + 3] = q.w;
      } else {
        const float2 q = reinterpret_cast<const float2*>(st)[c];
        win[2 * c] = q.x; win[2 * c + 1] = q.y;
      }
    }
#pragma unroll
    for (int k = 0; k < TW; ++k)
      if (k < taps) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = fmaf(kr[k], win[v + k], acc[v]);
      }
  } else {
    for (int k = 0; k < taps; ++k) {
      const float w = s_kx[k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(w, st[v + k], acc[v]);
    }
  }
}

template <int V>
struct Half;
template <>
struct Half<4> {
  struct alignas(8) H { __half2 a, b; };
  using S = short4;
  __device__ static H pack(const float (&t)[4]) {
    return H{__floats2half2_rn(t[0], t[1]), __floats2half2_rn(t[2], t[3])};
  }
  __device__ static S pack(const short (&t)[4]) { return make_short4(t[0], t[1], t[2], t[3]); }
};
template <>
struct Half<2> {
  using H = __half2;
  using S = short2;
  __device__ static H pack(const float (&t)[2]) { return __floats2half2_rn(t[0], t[1]); }
  __device__ static S pack(const short (&t)[2]) { return make_short2(t[0], t[1]); }
};

// V halves at ``out`` (one vector store when ``vec``, else the first n)
template <int V>
__device__ __forceinline__ void store_halves(__half* out, const float (&t)[V], bool vec, int n) {
  if (vec) {
    *reinterpret_cast<typename Half<V>::H*>(out) = Half<V>::pack(t);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < n) out[v] = __float2half_rn(t[v]);
  }
}

// The staged segment's length in floats: room for every window a thread
// reads (V-wide loads may run past the last tap) and for the last 16-byte
// copy, a multiple of 4.
template <int V, int TW>
__host__ __device__ constexpr int stage_len(int taps) {
  const int halo = (taps > TW ? taps : TW) + V;
  return kThreadsX * V + ((halo + 3) & ~3);
}

// One block a (z, y) row segment of SEG = 128 * V outputs; a thread takes V
// consecutive x. The segment of every bit, each with its taps_x - 1 halo,
// arrives in shared memory by cp.async, ``depth`` bits a set (all bits
// unless shared memory runs out) and the first set together with the
// tables, so the block waits for device memory once. The threads run the x
// pass of every bit into registers, then the decode. ``vec``: nx % V == 0
// and the outputs aligned, so every thread stores V values at a time.
template <int MAXB, int TW>
__global__ void __launch_bounds__(kThreadsX) x_lowpass_decode_kernel(
    const float* __restrict__ inter, const float* __restrict__ kx,
    const int* __restrict__ xmap, int taps_x, const float* __restrict__ cb,
    const float* __restrict__ bg, const float* __restrict__ nrm, int bits,
    int words, int nz, int ny, int nx, float lo, float hi, float dthr, int vec,
    int depth, short* __restrict__ decoded, __half* __restrict__ mag_out,
    __half* __restrict__ dist_out, __half* __restrict__ scaled_out) {
  constexpr int V = decode_core::voxels<MAXB>();
  constexpr int SEG = kThreadsX * V;
  extern __shared__ float4 smem4[];
  const int slen = stage_len<V, TW>(taps_x);
  float* s_stage = reinterpret_cast<float*>(smem4);  // depth x (slen,)
  float* s_cb = s_stage + depth * slen;              // (words, bits_p), bg, nrm
  const int cb_len = words * decode_core::padded_bits(bits);
  const float* s_bg = s_cb + cb_len;
  const float* s_nrm = s_bg + bits;
  float* s_kx = s_cb + cb_len + 2 * bits;  // (taps_x,)

  const int x0 = blockIdx.x * SEG;
  const int nstage = min(SEG + taps_x - 1, nx + taps_x - 1 - x0);
  const long long vox = (long long)nz * ny * nx;
  const long long at = ((long long)blockIdx.z * ny + blockIdx.y) * nx;
  decode_core::load_tables(cb, bg, nrm, bits, words, s_cb);
  for (int i = threadIdx.x; i < taps_x; i += kThreadsX) decode_core::cp_async4(s_kx + i, kx + i);
  const int xb = threadIdx.x * V;  // this thread's first output, in the segment
  const int x = x0 + xb;
  const bool active = x < nx;
  float kr[TW > 0 ? TW : 1];
#pragma unroll
  for (int k = 0; k < (TW > 0 ? TW : 1); ++k) kr[k] = k < taps_x ? __ldg(kx + k) : 0.f;

  float s[V][MAXB];  // the x pass of every bit, then the scaled traces
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b) s[v][b] = 0.f;
  }
  int slot = 0;  // b's buffer: b % depth
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < bits) {
      if (slot == 0) {  // stage the next set of bits
        if (b > 0) __syncthreads();  // the last set is read
        const int nb = min(depth, bits - b);
        for (int j = 0; j < nb; ++j)
          stage_row(inter + (b + j) * vox + at, xmap, x0, (taps_x - 1) / 2, nx, nstage,
                    s_stage + j * slen);
        decode_core::cp_async_wait_all();
        __syncthreads();
      }
      if (active) {
        float acc[V];
        x_pass<V, TW>(s_stage + slot * slen + xb, kr, s_kx, taps_x, acc);
#pragma unroll
        for (int v = 0; v < V; ++v) s[v][b] = acc[v];
      }
      slot = slot + 1 == depth ? 0 : slot + 1;
    }
  }
  if (!active) return;

  const int nv = min(V, nx - x);  // outputs of this thread inside the row
  float msq[V];
  decode_core::scale_traces(s, msq, s_bg, s_nrm, bits);
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b < bits) {
      float t[V];
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = s[v][b];
      store_halves<V>(scaled_out + b * vox + at + x, t, vec, nv);
    }
  }

  int arg[V];
  float dist[V], mag[V];
  decode_core::nearest(s, msq, s_cb, bits, words, arg, dist, mag);
  short ids[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const bool assigned = (dist[v] <= dthr) && (mag[v] >= lo) && (mag[v] <= hi);
    ids[v] = assigned ? (short)arg[v] : (short)-1;
  }
  if (vec) {
    *reinterpret_cast<typename Half<V>::S*>(decoded + at + x) = Half<V>::pack(ids);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) decoded[at + x + v] = ids[v];
  }
  store_halves<V>(mag_out + at + x, mag, vec, nv);
  store_halves<V>(dist_out + at + x, dist, vec, nv);
}

// the largest dynamic shared memory a block may have on the H100
constexpr size_t kMaxSmem = 232448;

template <int MAXB, int TW>
int launch_x_decode(const float* inter, const float* kx, const int* xmap,
                    int taps_x, const float* cb, const float* bg,
                    const float* nrm, int bits, int words, int nz, int ny,
                    int nx, float lo, float hi, float dthr, short* d,
                    __half* m, __half* di, __half* sc, cudaStream_t st) {
  constexpr int V = decode_core::voxels<MAXB>();
  constexpr int SEG = kThreadsX * V;
  const size_t fixed = (decode_core::smem_floats(words, bits) + taps_x) * sizeof(float);
  const size_t per_bit = (size_t)stage_len<V, TW>(taps_x) * sizeof(float);
  if (fixed + per_bit > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int depth = (int)std::min<size_t>(bits, (kMaxSmem - fixed) / per_bit);
  const size_t smem = fixed + depth * per_bit;
  static size_t smem_allowed = 48 * 1024;  // the default dynamic limit
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        x_lowpass_decode_kernel<MAXB, TW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const uintptr_t align = 2 * V;  // bytes of V halves
  const int vec = nx % V == 0 && reinterpret_cast<uintptr_t>(d) % align == 0 &&
                  reinterpret_cast<uintptr_t>(m) % align == 0 &&
                  reinterpret_cast<uintptr_t>(di) % align == 0 &&
                  reinterpret_cast<uintptr_t>(sc) % align == 0;
  const dim3 grid((nx + SEG - 1) / SEG, ny, nz);
  x_lowpass_decode_kernel<MAXB, TW><<<grid, kThreadsX, smem, st>>>(
      inter, kx, xmap, taps_x, cb, bg, nrm, bits, words, nz, ny, nx, lo, hi,
      dthr, vec, depth, d, m, di, sc);
  return (int)cudaGetLastError();
}

// the register window's tap count: the main path's sigma_x = 1 gives 9 taps
constexpr int kWindowTaps = 9;

template <int MAXB>
int dispatch_x_decode(const float* inter, const float* kx, const int* xmap,
                      int taps_x, const float* cb, const float* bg,
                      const float* nrm, int bits, int words, int nz, int ny,
                      int nx, float lo, float hi, float dthr, short* d,
                      __half* m, __half* di, __half* sc, cudaStream_t st) {
  if (taps_x <= kWindowTaps)
    return launch_x_decode<MAXB, kWindowTaps>(inter, kx, xmap, taps_x, cb, bg, nrm, bits,
                                              words, nz, ny, nx, lo, hi, dthr, d, m, di, sc, st);
  return launch_x_decode<MAXB, 0>(inter, kx, xmap, taps_x, cb, bg, nrm, bits, words, nz,
                                  ny, nx, lo, hi, dthr, d, m, di, sc, st);
}

}  // namespace

extern "C" int zy_lowpass_f32(const float* vol, const float* wz,
                              const float* kz, const int* zmap, int taps_z,
                              const float* ky, const int* ymap, int bits,
                              int nz, int ny, int nx, int taps_y, float* out,
                              void* stream) {
  if (bits < 1 || bits > 65535 || nz < 1 || ny < 1 || ny > 65535 || nx < 1 ||
      taps_y < 1 || taps_z < 1 || (nz <= 64 && wz == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nx + kThreadsX - 1) / kThreadsX, ny, bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nz > 64) {
    const size_t smem = (size_t)(taps_z + taps_y) * sizeof(float) +
                        (size_t)taps_y * sizeof(int);
    zy_lowpass_direct_kernel<<<grid, kThreadsX, smem, st>>>(
        vol, kz, zmap, ky, ymap, nz, ny, nx, taps_z, taps_y, out);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)(nz * nz + taps_y) * sizeof(float) +
                      (size_t)taps_y * sizeof(int);
  if (nz <= 16)
    zy_lowpass_kernel<16><<<grid, kThreadsX, smem, st>>>(vol, wz, ky, ymap, nz,
                                                         ny, nx, taps_y, out);
  else if (nz <= 32)
    zy_lowpass_kernel<32><<<grid, kThreadsX, smem, st>>>(vol, wz, ky, ymap, nz,
                                                         ny, nx, taps_y, out);
  else
    zy_lowpass_kernel<64><<<grid, kThreadsX, smem, st>>>(vol, wz, ky, ymap, nz,
                                                         ny, nx, taps_y, out);
  return (int)cudaGetLastError();
}

// inter: (bits, nz, ny, nx) float32, the K1 output; xmap: the symmetric
// pad's source index of each of nx + taps_x - 1 padded samples; cb: the
// packed (words, padded_bits(bits)) codebook (ops/decode.pack_codebook),
// 16-byte aligned.
extern "C" int x_lowpass_decode_f32(const float* inter, const float* kx,
                                    const int* xmap, int taps_x,
                                    const float* cb, const float* bg,
                                    const float* nrm, int bits, int words,
                                    int nz, int ny, int nx, float lo, float hi,
                                    float dthr, void* decoded, void* mag,
                                    void* dist, void* scaled, void* stream) {
  if (bits < 1 || bits > 32 || words < 1 || nz < 1 || nz > 65535 || ny < 1 ||
      ny > 65535 || nx < 1 || taps_x < 1 || reinterpret_cast<uintptr_t>(cb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  short* d = static_cast<short*>(decoded);
  __half* m = static_cast<__half*>(mag);
  __half* di = static_cast<__half*>(dist);
  __half* sc = static_cast<__half*>(scaled);
  if (bits <= 16)
    return dispatch_x_decode<16>(inter, kx, xmap, taps_x, cb, bg, nrm, bits, words, nz, ny,
                                 nx, lo, hi, dthr, d, m, di, sc, st);
  return dispatch_x_decode<32>(inter, kx, xmap, taps_x, cb, bg, nrm, bits, words, nz, ny,
                               nx, lo, hi, dthr, d, m, di, sc, st);
}
