// K1 + K2: separable Gaussian lowpass fused with the nearest-codeword
// decode, in two device-memory passes.
//
// K1 (zy_lowpass_kernel) replaces
//   merfish3d_tpu/ops/fused_decode.py:_zyconv_scan_kernel
// — the y and z passes of the lowpass. The TPU kernel scans y blocks in
// order and carries the halo in VMEM from one grid step to the next; on
// Hopper blocks run in no order, so a block stages its own halo. Up to 64
// planes, a tile is a bit, kZyTileX = 32 columns and a segment of
// SEG = kZyWarps * R output rows (R = kZyAcc / MAXZ rows a thread: 4 at
// MAXZ = 16, the main path's depths), and a block walks a tile's z planes
// itself. The grid is one wave of blocks, each walking every gridDim-th
// tile. For each plane a block copies the segment's SEG + taps_y - 1 input
// rows of its columns into shared memory once by cp.async (16 bytes a copy
// where nx % 4 == 0), through a ring of kZyStages planes that runs on from
// one tile to the next, so the next planes are in flight while one is
// summed and while a finished tile is stored. The symmetric pad (np.pad
// "symmetric", any width) is resolved when a row is staged: its source is
// the row itself inside the volume, else the host-built ymap's reflection;
// no tap reads an index or device memory. Lane l of warp w then sums the y
// taps of its R rows (rows w * R .. w * R + R - 1, column x0 + l) from a
// register window of R + taps_y - 1 staged values (taps_y <= kWindowTaps;
// more taps read shared memory tap by tap), in ascending tap order from
// +0, and folds each into R * MAXZ accumulators:
// acc[zo] = fmaf(wz[zo][zi], t, acc[zo]) for plane zi, with wz's column
// read from shared memory as float4 broadcasts. wz is the dense (nz, nz) z
// pass with the symmetric z pad folded in, exact for any pad width, and the
// planes come in ascending order, so every output is the same fmaf chain
// as the one-row-a-block kernel this replaced: the outputs are bit for bit
// that kernel's. Tiles are numbered column tile fastest, so the blocks
// running together cover whole rows of tiles, and neighbouring segments,
// which share taps_y - 1 halo rows, are staged close in time: the halo
// comes from L2. A deeper volume does not fit the accumulators:
// zy_lowpass_direct_kernel then sums, for each output plane, the y pass of
// its taps_z input planes through the z index map (the y pass is
// recomputed per z tap; any Z, any pad width).
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
// Bound on the H100. K1 reads and writes each voxel once (8 bytes a
// voxel) against min(taps_z, nz) + taps_y FMAs (16 + 9 at production),
// under the card's FP32 balance: the 3.35 TB/s DRAM rate bounds it
// (0.641 ms for the (16, 16, 1024, 1024) production tile). Every input
// voxel crosses from device memory once, as 16-byte copies with up to
// kZyStages - 1 planes in flight a block, and a warp stores 128 contiguous
// bytes an instruction. It does not reach the bound: at 128 registers a
// thread (the R * MAXZ accumulators) an SM holds two blocks of 8 warps,
// and the FMAs, 100 a thread and plane, are what the SM waits on
// (profile_decode.py --k1-tiling times the kernel with a quarter of the
// fold's FMAs, and with rings of other depths).
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
// the largest dynamic shared memory a block may have on the H100
constexpr size_t kMaxSmem = 232448;

// the register window's tap count: the main path's sigma = 1 gives 9 taps
// (K1's y pass, K2's x pass)
constexpr int kWindowTaps = 9;

// K1's tiling (see the note above)
constexpr int kZyWarps = 8;
constexpr int kZyThreads = 32 * kZyWarps;
constexpr int kZyTileX = 32;   // columns a tile: a lane each
constexpr int kZyAcc = 64;     // accumulators a thread: R = kZyAcc / MAXZ rows
constexpr int kZyStages = 6;   // staged planes in the ring

template <int MAXZ>
__host__ __device__ constexpr int zy_rows() {
  static_assert(MAXZ == 16 || MAXZ == 32 || MAXZ == 64, "MAXZ is 16, 32 or 64");
  return kZyAcc / MAXZ;
}

// rows of a staged plane: the segment, its taps - 1 halo rows and room for
// the register window's reads past the last tap
__host__ __device__ constexpr int zy_stage_rows(int seg, int taps) {
  return seg + (taps > kWindowTaps ? taps : kWindowTaps) - 1;
}

// shared memory of K1's block: the ring of staged planes, wz transposed
// (nz, MAXZ) and the y taps
template <int MAXZ>
size_t zy_smem_bytes(int nz, int taps_y) {
  const int srows = zy_stage_rows(kZyWarps * zy_rows<MAXZ>(), taps_y);
  return ((size_t)kZyStages * srows * kZyTileX + (size_t)nz * MAXZ + taps_y) * sizeof(float);
}

// The y pass of R consecutive rows from the staged plane at ``st`` (this
// thread's first row, its column; rows kZyTileX floats apart):
// t[r] = sum over k ascending of ky[k] * st[(r + k) row], each an fmaf
// from +0. TW > 0: the R + TW - 1 values sit in registers and taps <= TW;
// TW == 0: any taps, read from shared memory.
template <int R, int TW>
__device__ __forceinline__ void y_pass(const float* st, const float (&kr)[TW > 0 ? TW : 1],
                                       const float* s_ky, int taps, float (&t)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = 0.f;
  if constexpr (TW > 0) {
    float win[R + TW - 1];
#pragma unroll
    for (int j = 0; j < R + TW - 1; ++j) win[j] = st[j * kZyTileX];
#pragma unroll
    for (int k = 0; k < TW; ++k)
      if (k < taps) {
#pragma unroll
        for (int r = 0; r < R; ++r) t[r] = fmaf(kr[k], win[r + k], t[r]);
      }
  } else {
    for (int k = 0; k < taps; ++k) {
      const float w = s_ky[k];
#pragma unroll
      for (int r = 0; r < R; ++r) t[r] = fmaf(w, st[(r + k) * kZyTileX], t[r]);
    }
  }
}

// A tile of K1 and a plane of it, with the tile's place: its first output
// row, first column and bit. Tiles are numbered column tile fastest, then y
// segment, then bit.
struct ZyCursor {
  long long t;
  int z, y0, x0, b;
  __device__ void locate(int nseg, int ntx, int seg_rows) {
    x0 = (int)(t % ntx) * kZyTileX;
    y0 = (int)(t / ntx % nseg) * seg_rows;
    b = (int)(t / ntx / nseg);
  }
  __device__ void next(int nz, long long stride, int nseg, int ntx, int seg_rows) {
    if (++z < nz) return;
    z = 0;
    t += stride;
    locate(nseg, ntx, seg_rows);
  }
};

// The grid is one wave of the card's blocks; block i walks tiles i, i + grid,
// i + 2 grid, ..., so the blocks running together cover whole rows of tiles
// and a segment's halo rows, read by the segment above it in the same round,
// come from L2. The ring of staged planes runs on across a block's tiles:
// the next tile's first planes are in flight while a tile finishes and
// stores. ``vec``: nx % 4 == 0 and ``vol`` 16-byte aligned, so a staged row
// can be copied as 16-byte groups, each wholly inside or outside the row.
template <int MAXZ, int TW>
__global__ void __launch_bounds__(kZyThreads, 2) zy_lowpass_kernel(
    const float* __restrict__ vol, const float* __restrict__ wz,
    const float* __restrict__ ky, const int* __restrict__ ymap, int bits, int nz,
    int ny, int nx, int taps_y, int vec, float* __restrict__ out) {
  constexpr int R = zy_rows<MAXZ>();
  constexpr int SEG = kZyWarps * R;
  constexpr int G = kZyTileX / 4;  // 16-byte groups a staged row
  const int srows = zy_stage_rows(SEG, taps_y);
  const int plane_floats = srows * kZyTileX;
  extern __shared__ float4 smem4[];
  float* s_stage = reinterpret_cast<float*>(smem4);      // kZyStages x (srows, kZyTileX)
  float* s_wzt = s_stage + kZyStages * plane_floats;      // (nz, MAXZ): wz[zo][zi] at [zi][zo], 0 past nz
  float* s_ky = s_wzt + nz * MAXZ;                        // (taps_y,)
  for (int i = threadIdx.x; i < nz * MAXZ; i += kZyThreads) {
    const int zi = i / MAXZ, zo = i % MAXZ;
    s_wzt[i] = zo < nz ? __ldg(wz + zo * nz + zi) : 0.f;
  }
  for (int i = threadIdx.x; i < taps_y; i += kZyThreads) s_ky[i] = __ldg(ky + i);

  const int r_y = (taps_y - 1) / 2;
  const int nseg = (ny + SEG - 1) / SEG, ntx = (nx + kZyTileX - 1) / kZyTileX;
  const long long ntiles = (long long)nseg * ntx * bits;
  // (tile, plane) steps of this block: tiles blockIdx.x + k * gridDim.x
  const long long steps = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nz;
  const long long plane = (long long)ny * nx;
  // the source of padded row y0 + row of a segment: row y0 + row - r_y
  // inside the volume, else the symmetric pad's ymap[y0 + row]
  auto source_row = [&](int y0, int row) {
    const int src = y0 + row - r_y;
    return (src >= 0 && src < ny) ? src : __ldg(ymap + y0 + row);
  };
  // plane c.z of tile c into ring slot ``slot``. Where nx % 4 == 0 and
  // taps_y <= kWindowTaps (``fixed``) a plane is at most two 16-byte groups a
  // thread, threadIdx.x + j * kZyThreads (j < 2), the same in every plane of
  // a tile, so their offsets are found once a tile
  constexpr bool kTwoCopies = TW > 0 && (SEG + kWindowTaps - 1) * G <= 2 * kZyThreads;
  static_assert(TW == 0 || kTwoCopies, "a plane's 16-byte groups exceed two a thread");
  const bool fixed = kTwoCopies && vec;
  long long off[2] = {0, 0};
  bool ok[2] = {false, false};
  auto stage = [&](const ZyCursor& c, int slot) {
    const int y0 = c.y0, x0 = c.x0;
    const int nrows = min(SEG, ny - y0) + taps_y - 1;
    const int ncols = min(kZyTileX, nx - x0);
    float* buf = s_stage + slot * plane_floats;
    const float* pz = vol + ((long long)c.b * nz + c.z) * plane + x0;
    if (fixed) {
      if (c.z == 0) {  // a new tile: its copies' offsets
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = threadIdx.x + j * kZyThreads, row = i / G, g = i % G;
          ok[j] = row < nrows && 4 * g < ncols;
          off[j] = ok[j] ? (long long)source_row(y0, row) * nx + 4 * g : 0;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = threadIdx.x + j * kZyThreads;
        if (ok[j]) decode_core::cp_async16(buf + (i / G) * kZyTileX + 4 * (i % G), pz + off[j]);
      }
    } else {  // any row length or tap count: 4-byte copies
      for (int i = threadIdx.x; i < nrows * kZyTileX; i += kZyThreads) {
        const int row = i / kZyTileX, col = i % kZyTileX;
        if (col < ncols)
          decode_core::cp_async4(buf + row * kZyTileX + col, pz + (long long)source_row(y0, row) * nx + col);
      }
    }
  };

  ZyCursor in;  // the next plane to stage
  in.t = blockIdx.x;
  in.z = 0;
  in.locate(nseg, ntx, SEG);
  ZyCursor cur = in;  // the plane to sum
#pragma unroll
  for (int s = 0; s < kZyStages - 1; ++s) {
    if (s < steps) {
      stage(in, s);
      in.next(nz, gridDim.x, nseg, ntx, SEG);
    }
    decode_core::cp_async_commit();
  }
  __syncthreads();  // s_wzt, s_ky
  float kr[TW > 0 ? TW : 1];
#pragma unroll
  for (int k = 0; k < (TW > 0 ? TW : 1); ++k) kr[k] = k < taps_y ? s_ky[k] : 0.f;
  float acc[MAXZ][R];
#pragma unroll
  for (int zo = 0; zo < MAXZ; ++zo) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[zo][r] = 0.f;
  }
  const int col = threadIdx.x & 31;  // this thread's column, in the tile
  const int rb = (threadIdx.x >> 5) * R;  // this thread's first row, in the segment

  int slot = 0, next_slot = kZyStages - 1;
  for (long long q = 0; q < steps; ++q) {
    decode_core::cp_async_wait_group<kZyStages - 2>();  // plane q has landed (own copies)
    __syncthreads();  // everyone's copies of q; everyone is done with plane q - 1's slot
    if (q + kZyStages - 1 < steps) {
      stage(in, next_slot);
      in.next(nz, gridDim.x, nseg, ntx, SEG);
    }
    decode_core::cp_async_commit();
    next_slot = next_slot + 1 == kZyStages ? 0 : next_slot + 1;
    float t[R];
    y_pass<R, TW>(s_stage + slot * plane_floats + rb * kZyTileX + col, kr, s_ky, taps_y, t);
    slot = slot + 1 == kZyStages ? 0 : slot + 1;
    const float4* w4 = reinterpret_cast<const float4*>(s_wzt + cur.z * MAXZ);
#pragma unroll
    for (int g = 0; g < MAXZ / 4; ++g) {
      if (4 * g < nz) {
        const float4 w = w4[g];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[4 * g][r] = fmaf(w.x, t[r], acc[4 * g][r]);
          acc[4 * g + 1][r] = fmaf(w.y, t[r], acc[4 * g + 1][r]);
          acc[4 * g + 2][r] = fmaf(w.z, t[r], acc[4 * g + 2][r]);
          acc[4 * g + 3][r] = fmaf(w.w, t[r], acc[4 * g + 3][r]);
        }
      }
    }
    if (cur.z == nz - 1) {  // the tile's last plane: store it, start the next
      const int y0 = cur.y0, x = cur.x0 + col;
      const int nout = min(SEG, ny - y0);
      float* ob = out + (long long)cur.b * nz * plane + (long long)(y0 + rb) * nx + x;
#pragma unroll
      for (int zo = 0; zo < MAXZ; ++zo) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (zo < nz && rb + r < nout && x < nx) ob[zo * plane + (long long)r * nx] = acc[zo][r];
          acc[zo][r] = 0.f;
        }
      }
    }
    cur.next(nz, gridDim.x, nseg, ntx, SEG);
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

// K1's launch shape: its shared bytes (allowed above the default 48 KB
// limit once), the blocks an SM holds, and the grid: the blocks one wave of
// the card holds, or a block a tile where there are fewer tiles.
template <int MAXZ, int TW>
cudaError_t zy_shape(int bits, int ny, int nx, size_t smem, int* per_sm, int* grid) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        zy_lowpass_kernel<MAXZ, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  constexpr int SEG = kZyWarps * zy_rows<MAXZ>();
  const long long ntiles =
      (long long)((ny + SEG - 1) / SEG) * ((nx + kZyTileX - 1) / kZyTileX) * bits;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, zy_lowpass_kernel<MAXZ, TW>,
                                                      kZyThreads, smem);
  if (e != cudaSuccess) return e;
  const long long wave = (long long)*per_sm * sms;
  if (wave < 1) return cudaErrorInvalidConfiguration;
  *grid = (int)std::min(ntiles, wave);
  return cudaSuccess;
}

template <int MAXZ, int TW>
int launch_zy(const float* vol, const float* wz, const float* ky, const int* ymap, int bits,
              int nz, int ny, int nx, int taps_y, float* out, cudaStream_t st) {
  int per_sm = 0, grid = 0;
  const cudaError_t e =
      zy_shape<MAXZ, TW>(bits, ny, nx, zy_smem_bytes<MAXZ>(nz, taps_y), &per_sm, &grid);
  if (e != cudaSuccess) return (int)e;
  const int vec = nx % 4 == 0 && reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  zy_lowpass_kernel<MAXZ, TW><<<grid, kZyThreads, zy_smem_bytes<MAXZ>(nz, taps_y), st>>>(
      vol, wz, ky, ymap, bits, nz, ny, nx, taps_y, vec, out);
  return (int)cudaGetLastError();
}

template <int MAXZ>
int dispatch_zy(const float* vol, const float* wz, const float* ky, const int* ymap, int bits,
                int nz, int ny, int nx, int taps_y, float* out, cudaStream_t st) {
  if (taps_y <= kWindowTaps)
    return launch_zy<MAXZ, kWindowTaps>(vol, wz, ky, ymap, bits, nz, ny, nx, taps_y, out, st);
  return launch_zy<MAXZ, 0>(vol, wz, ky, ymap, bits, nz, ny, nx, taps_y, out, st);
}

// K1's route for a shape, for the logs: info = {1 for the staged kernel or 0
// for the direct one, output rows a segment, columns a tile, shared bytes a
// block, resident blocks an SM, threads a block, blocks in the grid}.
template <int MAXZ, int TW>
int zy_route(int bits, int nz, int ny, int nx, int taps_y, int* info) {
  const size_t smem = zy_smem_bytes<MAXZ>(nz, taps_y);
  info[0] = 1;
  info[1] = kZyWarps * zy_rows<MAXZ>();
  info[2] = kZyTileX;
  info[3] = (int)smem;
  info[5] = kZyThreads;
  return (int)zy_shape<MAXZ, TW>(bits, ny, nx, smem, &info[4], &info[6]);
}

template <int MAXZ>
int zy_route_taps(int bits, int nz, int ny, int nx, int taps_y, int* info) {
  if (taps_y <= kWindowTaps) return zy_route<MAXZ, kWindowTaps>(bits, nz, ny, nx, taps_y, info);
  return zy_route<MAXZ, 0>(bits, nz, ny, nx, taps_y, info);
}

}  // namespace

extern "C" int zy_lowpass_route(int bits, int nz, int ny, int nx, int taps_y, int* info) {
  if (bits < 1 || nz < 1 || ny < 1 || nx < 1 || taps_y < 1) return (int)cudaErrorInvalidValue;
  if (nz <= 16) return zy_route_taps<16>(bits, nz, ny, nx, taps_y, info);
  if (nz <= 32) return zy_route_taps<32>(bits, nz, ny, nx, taps_y, info);
  if (nz <= 64) return zy_route_taps<64>(bits, nz, ny, nx, taps_y, info);
  const int direct[7] = {0, 1, kThreadsX, 0, 0, kThreadsX, (nx + kThreadsX - 1) / kThreadsX * ny * bits};
  std::copy(direct, direct + 7, info);
  return 0;
}

// vol: (bits, nz, ny, nx) float32; wz: the (nz, nz) z fold (nz <= 64, else
// unused); kz, zmap: the z taps and the z pad's index map (nz > 64, else
// unused); ymap: the y pad's source row of each of ny + taps_y - 1 padded
// rows.
extern "C" int zy_lowpass_f32(const float* vol, const float* wz,
                              const float* kz, const int* zmap, int taps_z,
                              const float* ky, const int* ymap, int bits,
                              int nz, int ny, int nx, int taps_y, float* out,
                              void* stream) {
  if (bits < 1 || bits > 65535 || nz < 1 || ny < 1 || ny > 65535 || nx < 1 ||
      taps_y < 1 || taps_z < 1 || (nz <= 64 && wz == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nz > 64) {
    const dim3 grid((nx + kThreadsX - 1) / kThreadsX, ny, bits);
    const size_t smem = (size_t)(taps_z + taps_y) * sizeof(float) +
                        (size_t)taps_y * sizeof(int);
    zy_lowpass_direct_kernel<<<grid, kThreadsX, smem, st>>>(
        vol, kz, zmap, ky, ymap, nz, ny, nx, taps_z, taps_y, out);
    return (int)cudaGetLastError();
  }
  if (nz <= 16) return dispatch_zy<16>(vol, wz, ky, ymap, bits, nz, ny, nx, taps_y, out, st);
  if (nz <= 32) return dispatch_zy<32>(vol, wz, ky, ymap, bits, nz, ny, nx, taps_y, out, st);
  return dispatch_zy<64>(vol, wz, ky, ymap, bits, nz, ny, nx, taps_y, out, st);
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
