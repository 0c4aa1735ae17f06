// K3: unfused per-pixel nearest-codeword decode (bits-major traces).
//
// Replaces merfish3d_tpu/ops/decode.py:_decode_kernel (the Pallas kernel
// behind _decode_chunk_pallas). Same arithmetic: scale (t - bg) / norm,
// clip to [0, 1], L2-normalize, project onto the L2-normalized codebook,
// first-maximum argmax, dist = sqrt(max(2 - 2 max, 0)); all of it in
// decode_core.cuh, which K2 shares. All FP32 FMA; no TF32.
//
// Bound on the H100: the bits * words FMAs a pixel (16 x 90 at
// production) at the FP32 rate; the 4 * bits bytes a pixel read take about
// half that time at 3.35 TB/s. Design: a thread takes V consecutive pixels
// (V = 4 for bits <= 16, 2 for bits <= 32). A block's tile of 128 * V
// pixels (every bit) and its tables arrive in shared memory by cp.async,
// all in flight together, V values a copy when the rows allow it (the base
// aligned, the bit stride and N multiples of V), else, and for a ragged
// last group, element by element. The traces are a (bits, N) view whose
// rows lie ``bit_stride`` elements apart, so decode_volume hands over a
// z-chunk of a (bits, Z, Y, X) volume without copying it. The codebook
// loop is the core's: V unit traces in registers, float4 broadcasts of the
// packed codebook from shared memory. (A persistent grid that copied the
// next tile under the decode of the one before measured slower, here and
// in K2.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_core.cuh"

namespace {

constexpr int kThreads = 128;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using F = float4;
  using I = int4;
  __device__ static void split(const F& f, float (&t)[4]) {
    t[0] = f.x; t[1] = f.y; t[2] = f.z; t[3] = f.w;
  }
  __device__ static F join(const float (&t)[4]) { return make_float4(t[0], t[1], t[2], t[3]); }
  __device__ static I join(const int (&t)[4]) { return make_int4(t[0], t[1], t[2], t[3]); }
};
template <>
struct Vec<2> {
  using F = float2;
  using I = int2;
  __device__ static void split(const F& f, float (&t)[2]) {
    t[0] = f.x; t[1] = f.y;
  }
  __device__ static F join(const float (&t)[2]) { return make_float2(t[0], t[1]); }
  __device__ static I join(const int (&t)[2]) { return make_int2(t[0], t[1]); }
};

// Stage tile ``tile`` of the traces, (bits, P) floats, into ``buf``: one
// V-wide copy a thread and bit when VEC, else V single floats; zeros past n.
template <int V, bool VEC>
__device__ __forceinline__ void stage_tile(const float* __restrict__ traces, int bits,
                                           long long n, long long bit_stride, long long tile,
                                           float* buf) {
  constexpr int P = kThreads * V;
  const long long p0 = tile * P + threadIdx.x * V;
  for (int b = 0; b < bits; ++b) {
    const float* row = traces + (long long)b * bit_stride;
    float* dst = buf + b * P + threadIdx.x * V;
    if constexpr (VEC) {
      const bool ok = p0 < n;
      decode_core::cp_async_zfill<4 * V>(dst, row + (ok ? p0 : 0), ok);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool ok = p0 + v < n;
        decode_core::cp_async_zfill<4>(dst + v, row + (ok ? p0 + v : 0), ok);
      }
    }
  }
}

// A block decodes one tile of P = 128 * V pixels. The tile's traces (every
// bit) arrive by cp.async into shared memory together with the tables, so
// the block waits for device memory once; the threads then take their V
// values of every bit into registers. VEC: every row of traces and scaled
// can be read and written V values at a time (the launcher checks
// alignment and that N % V == 0, so no group is ragged).
template <int MAXB, bool VEC>
__global__ void __launch_bounds__(kThreads) decode_chunk_kernel(
    const float* __restrict__ traces, const float* __restrict__ cb,
    const float* __restrict__ bg, const float* __restrict__ nrm, int bits,
    int words, long long n, long long bit_stride, int* __restrict__ best_out,
    float* __restrict__ dist_out, float* __restrict__ mag_out,
    float* __restrict__ scaled_out) {
  constexpr int V = decode_core::voxels<MAXB>();
  constexpr int P = kThreads * V;
  using W = Vec<V>;
  extern __shared__ float4 smem4[];
  float* s_tile = reinterpret_cast<float*>(smem4);  // (bits, P)
  float* s_cb = s_tile + bits * P;                   // (words, bits_p)
  const int cb_len = words * decode_core::padded_bits(bits);
  const float* s_bg = s_cb + cb_len;  // (bits,)
  const float* s_nrm = s_bg + bits;   // (bits,)
  stage_tile<V, VEC>(traces, bits, n, bit_stride, blockIdx.x, s_tile);
  decode_core::load_tables(cb, bg, nrm, bits, words, s_cb);
  decode_core::cp_async_wait_all();
  __syncthreads();
  const long long p0 = (long long)blockIdx.x * P + threadIdx.x * V;
  if (p0 >= n) return;

  float s[V][MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    float t[V];
    if (b < bits) {
      W::split(*reinterpret_cast<const typename W::F*>(s_tile + b * P + threadIdx.x * V), t);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) t[v] = 0.f;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) s[v][b] = t[v];
  }
  float msq[V];
  decode_core::scale_traces(s, msq, s_bg, s_nrm, bits);
  if (scaled_out != nullptr) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < bits) {
        float t[V];
#pragma unroll
        for (int v = 0; v < V; ++v) t[v] = s[v][b];
        float* out = scaled_out + (long long)b * n + p0;
        if constexpr (VEC) {
          *reinterpret_cast<typename W::F*>(out) = W::join(t);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            if (p0 + v < n) out[v] = t[v];
        }
      }
    }
  }

  int arg[V];
  float dist[V], mag[V];
  decode_core::nearest(s, msq, s_cb, bits, words, arg, dist, mag);
  if constexpr (VEC) {
    *reinterpret_cast<typename W::I*>(best_out + p0) = W::join(arg);
    *reinterpret_cast<typename W::F*>(dist_out + p0) = W::join(dist);
    *reinterpret_cast<typename W::F*>(mag_out + p0) = W::join(mag);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (p0 + v < n) {
        best_out[p0 + v] = arg[v];
        dist_out[p0 + v] = dist[v];
        mag_out[p0 + v] = mag[v];
      }
    }
  }
}

template <int MAXB, bool VEC>
int launch(const float* traces, const float* cb, const float* bg,
           const float* nrm, int bits, int words, long long n,
           long long bit_stride, int* best, float* dist, float* mag,
           float* scaled, cudaStream_t st) {
  constexpr int V = decode_core::voxels<MAXB>();
  constexpr int P = kThreads * V;
  const size_t smem =
      ((size_t)bits * P + decode_core::smem_floats(words, bits)) * sizeof(float);
  static size_t smem_allowed = 48 * 1024;  // the default dynamic limit
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_chunk_kernel<MAXB, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  const long long blocks = (n + P - 1) / P;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  decode_chunk_kernel<MAXB, VEC><<<(unsigned int)blocks, kThreads, smem, st>>>(
      traces, cb, bg, nrm, bits, words, n, bit_stride, best, dist, mag, scaled);
  return (int)cudaGetLastError();
}

template <int MAXB>
int dispatch(const float* traces, const float* cb, const float* bg,
             const float* nrm, int bits, int words, long long n,
             long long bit_stride, int* best, float* dist, float* mag,
             float* scaled, cudaStream_t st) {
  constexpr int V = decode_core::voxels<MAXB>();
  const bool vec = reinterpret_cast<uintptr_t>(traces) % (4 * V) == 0 &&
                   bit_stride % V == 0 && n % V == 0;
  if (vec)
    return launch<MAXB, true>(traces, cb, bg, nrm, bits, words, n, bit_stride,
                              best, dist, mag, scaled, st);
  return launch<MAXB, false>(traces, cb, bg, nrm, bits, words, n, bit_stride,
                             best, dist, mag, scaled, st);
}

}  // namespace

// traces: (bits, n) float32, row b at traces + b * bit_stride, each row
// contiguous; cb: the packed (words, padded_bits(bits)) codebook
// (ops/decode.pack_codebook), 16-byte aligned; best, dist, mag: (n,); scaled: (bits, n)
// packed, or null. best, dist, mag and scaled must be 16-byte aligned.
extern "C" int decode_chunk_f32(const float* traces, const float* cb,
                                const float* bg, const float* nrm, int bits,
                                int words, long long n, long long bit_stride,
                                int* best, float* dist, float* mag,
                                float* scaled, void* stream) {
  if (bits < 1 || bits > 32 || words < 1 || n < 1 || (bits > 1 && bit_stride < 1) ||
      reinterpret_cast<uintptr_t>(cb) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits <= 16)
    return dispatch<16>(traces, cb, bg, nrm, bits, words, n, bit_stride, best,
                        dist, mag, scaled, st);
  return dispatch<32>(traces, cb, bg, nrm, bits, words, n, bit_stride, best,
                      dist, mag, scaled, st);
}
