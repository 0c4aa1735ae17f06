// Component extraction of the decoded volume (ops/components.py), for
// Hopper: the connected components of equal codeword, then each
// component's sums.
//
// Replaces no Pallas kernel. The JAX package and, before these kernels,
// this port extract components on the host: the native union-find
// labeller (csrc/hostops.cpp label_components_sparse) and float64 numpy
// sums (ops/cc.py component_stats_host), which needed the decoded,
// magnitude and distance volumes and the gathered intensities downloaded
// after every decode. Here both run where the decode's outputs already
// are, and only the sums of the components within the size window cross
// to the host.
//
// label_components_i16: 26-connected components of equal decoded value
// over the foreground (decoded >= 0). Union-find over a label volume, as
// in Playne & Hawick's GPU union-find: every voxel starts as its own root
// (its linear index); a voxel unites with each of its 13 equal neighbours
// that precede it in scan order, hooking the larger root under the smaller
// one with atomicMin and retrying from whatever a root that lost a race
// now points to; a last pass points every voxel at its root (path
// compression). A label only ever points at a smaller index of the same
// component, so each root is its component's smallest linear index: the
// scan-order first voxel, the component the host labeller numbers first.
// Bound: bytes, 2 B read and 4 B written a voxel, 0.030 ms at a 16 Mi-voxel
// tile; it takes 0.53 ms there (~5 % foreground), the unions' chains of
// dependent reads and atomics over the foreground being the rest. Every
// voxel's neighbours come from L1/L2, and a background voxel costs one
// 2-byte read in the union pass. (The JAX package's min-label propagation
// is gather-bound and was rejected at 47 s a tile, docs/kernels.md.)
//
// component_sums_f64: a component's area, coordinate and second-moment
// sums, magnitude sum, distance minimum, codeword, per-bit intensity sums
// and, when asked, per-bit intensity-weighted z, y, x sums, in float64.
// Its foreground comes stably sorted by root, so a component's voxels lie
// together in scan order. One thread sums one quantity group of one
// component sequentially, in that order: the geometry (thread 0 of the
// component) or one bit (threads 1..bits). That is the order np.bincount
// adds in, and every product and sum is rounded alone (__dmul_rn,
// __dadd_rn: no contraction to FMA), so the sums equal the host's bit for
// bit and repeat from run to run. Bound: bytes, 12 B a voxel and 2 or 4 B
// a voxel and bit (0.006 ms for a tile's ~0.46 M kept voxels of 16 float16
// bits); it takes 0.29 ms (0.46 ms with the weighted sums), held by the
// latency of each thread's sequential chain of scattered reads, which the
// exactness asks for.
//
// Plain C entry points; each returns cudaGetLastError() after its launches.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // grid-stride beyond this

__global__ void cc_init(const int16_t* __restrict__ dec, int n, int* __restrict__ lab) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    lab[i] = dec[i] >= 0 ? i : -1;
}

// the root of x: follow labels until one points at itself (L2 reads: other
// SMs hook roots while this runs)
__device__ __forceinline__ int find_root(const int* lab, int x) {
  int p = __ldcg(lab + x);
  while (p != x) {
    x = p;
    p = __ldcg(lab + x);
  }
  return x;
}

__device__ void unite(int* lab, int a, int b) {
  for (;;) {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(lab + b, a);
    if (old == b) return;  // b was still a root: hooked under a
    b = old;               // b was hooked elsewhere meanwhile: unite with that
  }
}

__global__ void cc_merge(const int16_t* __restrict__ dec, int nz, int ny, int nx, int* lab) {
  const int n = nz * ny * nx, plane = ny * nx;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int v = dec[i];
    if (v < 0) continue;
    const int z = i / plane, r = i - z * plane, y = r / nx, x = r - y * nx;
    // the 13 neighbours before i in scan order: the plane below (9), the
    // row above (3), the voxel to the left (1)
    for (int dz = -1; dz <= 0; ++dz) {
      if (z + dz < 0) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        if (dz == 0 && dy > 0) break;
        if (y + dy < 0 || y + dy >= ny) continue;
        for (int dx = -1; dx <= 1; ++dx) {
          if (dz == 0 && dy == 0 && dx >= 0) break;
          if (x + dx < 0 || x + dx >= nx) continue;
          const int j = i + dz * plane + dy * nx + dx;
          if (dec[j] == v) unite(lab, i, j);
        }
      }
    }
  }
}

__global__ void cc_compress(int n, int* lab) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int p = lab[i];
    if (p >= 0 && p != i) lab[i] = find_root(lab, p);
  }
}

__device__ __forceinline__ double widen(float v) { return static_cast<double>(v); }
__device__ __forceinline__ double widen(__half v) { return static_cast<double>(__half2float(v)); }

// out row of a component: area, z, y, x, zz, yy, xx, zy, zx, yx sums,
// magnitude sum, distance minimum, codeword, bits intensity sums, then
// (weighted) bits × (z, y, x) intensity-weighted sums
constexpr int kGeometryCols = 13;

template <typename T, bool WEIGHTED>
__global__ void cc_sums(const long long* __restrict__ lin, const long long* __restrict__ off,
                        const long long* __restrict__ cnt, int k, const int16_t* __restrict__ dec,
                        const __half* __restrict__ mag, const __half* __restrict__ dist,
                        const T* __restrict__ vals, long long plane_stride, int bits, int ny,
                        int nx, double* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int parts = bits + 1;
  if (t >= static_cast<long long>(k) * parts) return;
  const int c = static_cast<int>(t / parts), part = static_cast<int>(t - static_cast<long long>(c) * parts);
  const int cols = kGeometryCols + bits * (WEIGHTED ? 4 : 1);
  const long long* l = lin + off[c];
  const long long m = cnt[c];
  const long long yx = static_cast<long long>(ny) * nx;
  double* row = out + static_cast<long long>(c) * cols;
  if (part == 0) {
    double sz = 0.0, sy = 0.0, sx = 0.0, szz = 0.0, syy = 0.0, sxx = 0.0;
    double szy = 0.0, szx = 0.0, syx = 0.0, smag = 0.0, dmin = INFINITY;
#pragma unroll 4
    for (long long j = 0; j < m; ++j) {
      const long long i = l[j];
      const long long zi = i / yx, rem = i - zi * yx, yi = rem / nx;
      const double z = static_cast<double>(zi), y = static_cast<double>(yi),
                   x = static_cast<double>(rem - yi * nx);
      sz = __dadd_rn(sz, z);
      sy = __dadd_rn(sy, y);
      sx = __dadd_rn(sx, x);
      szz = __dadd_rn(szz, __dmul_rn(z, z));
      syy = __dadd_rn(syy, __dmul_rn(y, y));
      sxx = __dadd_rn(sxx, __dmul_rn(x, x));
      szy = __dadd_rn(szy, __dmul_rn(z, y));
      szx = __dadd_rn(szx, __dmul_rn(z, x));
      syx = __dadd_rn(syx, __dmul_rn(y, x));
      smag = __dadd_rn(smag, widen(mag[i]));
      dmin = fmin(dmin, widen(dist[i]));
    }
    row[0] = static_cast<double>(m);
    row[1] = sz;
    row[2] = sy;
    row[3] = sx;
    row[4] = szz;
    row[5] = syy;
    row[6] = sxx;
    row[7] = szy;
    row[8] = szx;
    row[9] = syx;
    row[10] = smag;
    row[11] = dmin;
    row[12] = static_cast<double>(dec[l[0]]);  // the root: the scan-order first voxel
    return;
  }
  const int b = part - 1;
  const T* v = vals + b * plane_stride;
  double s = 0.0, wz = 0.0, wy = 0.0, wx = 0.0;
#pragma unroll 4
  for (long long j = 0; j < m; ++j) {
    const long long i = l[j];
    const double w = widen(v[i]);
    s = __dadd_rn(s, w);
    if (WEIGHTED) {
      const long long zi = i / yx, rem = i - zi * yx, yi = rem / nx;
      wz = __dadd_rn(wz, __dmul_rn(w, static_cast<double>(zi)));
      wy = __dadd_rn(wy, __dmul_rn(w, static_cast<double>(yi)));
      wx = __dadd_rn(wx, __dmul_rn(w, static_cast<double>(rem - yi * nx)));
    }
  }
  row[kGeometryCols + b] = s;
  if (WEIGHTED) {
    double* w3 = row + kGeometryCols + bits + 3 * b;
    w3[0] = wz;
    w3[1] = wy;
    w3[2] = wx;
  }
}

template <typename T>
int launch_sums(const long long* lin, const long long* off, const long long* cnt, int k,
                const int16_t* dec, const __half* mag, const __half* dist, const T* vals,
                long long plane_stride, int bits, int ny, int nx, bool weighted, double* out,
                cudaStream_t st) {
  const long long tasks = static_cast<long long>(k) * (bits + 1);
  const int threads = 128;
  const long long blocks = (tasks + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (weighted)
    cc_sums<T, true><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        lin, off, cnt, k, dec, mag, dist, vals, plane_stride, bits, ny, nx, out);
  else
    cc_sums<T, false><<<static_cast<unsigned>(blocks), threads, 0, st>>>(
        lin, off, cnt, k, dec, mag, dist, vals, plane_stride, bits, ny, nx, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dec: (nz, ny, nx) int16, -1 background; lab: (nz, ny, nx) int32 out, the
// root (smallest linear index of the component) of each foreground voxel,
// -1 elsewhere. Three launches on ``stream``.
extern "C" int label_components_i16(const int16_t* dec, int nz, int ny, int nx, int* lab,
                                    void* stream) {
  const long long n = static_cast<long long>(nz) * ny * nx;
  if (nz < 1 || ny < 1 || nx < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const unsigned g = static_cast<unsigned>(blocks);
  cc_init<<<g, kThreads, 0, st>>>(dec, static_cast<int>(n), lab);
  cc_merge<<<g, kThreads, 0, st>>>(dec, nz, ny, nx, lab);
  cc_compress<<<g, kThreads, 0, st>>>(static_cast<int>(n), lab);
  return static_cast<int>(cudaGetLastError());
}

// lin: the foreground's linear indices stably sorted by root; off, cnt: (k,)
// the first position in lin and the voxel count of each component summed;
// dec, mag, dist: (Z, Y, X) int16, float16, float16; vals: (bits, Z, Y, X),
// plane b at vals + b * plane_stride, float16 (vals_half) or float32; out:
// (k, 13 + bits (+ 3 bits when weighted)) float64, one row a component.
extern "C" int component_sums_f64(const long long* lin, const long long* off,
                                  const long long* cnt, int k, const void* dec, const void* mag,
                                  const void* dist, const void* vals, int vals_half,
                                  long long plane_stride, int bits, int ny, int nx, int weighted,
                                  double* out, void* stream) {
  if (k < 1 || bits < 1 || ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int16_t*>(dec);
  const auto* mg = static_cast<const __half*>(mag);
  const auto* ds = static_cast<const __half*>(dist);
  if (vals_half)
    return launch_sums(lin, off, cnt, k, d, mg, ds, static_cast<const __half*>(vals), plane_stride,
                       bits, ny, nx, weighted != 0, out, st);
  return launch_sums(lin, off, cnt, k, d, mg, ds, static_cast<const float*>(vals), plane_stride,
                     bits, ny, nx, weighted != 0, out, st);
}
