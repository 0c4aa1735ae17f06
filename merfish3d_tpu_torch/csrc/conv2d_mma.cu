// Stride-1 SAME 2D convolution with bf16 operands on the tensor cores, with
// a fused bias + activation epilogue (ops/conv2d.py): K11, every convolution
// of the U-FISH U-Net.
//
// Replaces the Pallas kernel of merfish3d_tpu/ops/conv2d.py:
//   K11 conv2d_lanepack_packed (_conv_scan_kernel)
//
// It computes what the TPU kernel computes, not its layout:
// y[n, i, j, o] = act(b[o] + sum over (dy, dx, c) of
// x[n, i + dy - lo_h, j + dx - lo_w, c] * w[dy, dx, c, o]), zero outside the
// image, with SAME's lo = (k - 1) / 2 on each axis (the 2x2 decoder kernels
// take lo 0, hi 1). Any Cin and Co; k <= 3 on each axis. Activations NHWC.
//
// Numbers: bf16 operands, products exact in f32, f32 sums on the tensor
// cores (mma.sync m16n8k16, f32 accumulators in registers); the epilogue
// adds the f32 bias, applies the activation in f32 and rounds once to bf16
// or f32 (round to nearest even). The sums run in another order than a CPU
// or cuDNN convolution, so a bf16 output may differ from theirs by one bf16
// rounding step. The f32-operand route stays on the FP32 cores
// (csrc/conv2d.cu): the tensor cores would take f32 operands only as TF32.
//
// Bound: at the U-Net's 3x3 layers of 32 to 128 channels a convolution does
// 2 * 9 * Cin FLOPs per output value against ~2 * (Cin + Co) bytes per
// pixel, above the card's balance even at the bf16 tensor rate; the 1x1
// layers and the narrow first layer and head are bound by bytes. The design
// reads each input tile once per layer and writes each output once.
//
// Design, an implicit GEMM: M is a block's tile of output pixels (8 rows of
// 16 to 64 columns; an m16 fragment is 16 pixels of one row), N is Co in
// blocks of NB = 16, 32, 64 or 128 channels (Co = 256 walks two N halves
// inside the block, the second reading its input again from L2), K is
// kh * kw * Cin, walked as 16-channel slices of the input, each slice
// taking every tap. Per slice, the input tile with its halo (16 channels,
// 32 bytes a pixel) and the slice's weights for every tap and the block's
// NB outputs sit in shared memory, double-buffered: 16-byte cp.async copies
// of the next slice run under the current slice's products. Both are read
// with ldmatrix from rows of 32 bytes whose two 16-byte halves swap on
// every fourth row, so any 8 consecutive rows fill all 32 banks. The host
// packs the weights once (ops/conv2d.pack_weights) into the kernel's
// (N half, slice, tap, NB, 16) bf16 layout, zero-padded in Cin and Co, so
// a stage's weights are one contiguous copy.
//
// Narrow layers go through the same kernel, padded: the first layer's one
// input channel takes a 16-channel slice (9 taps x 16 of K, 9 real; the
// layer is bound by its 32-channel output, and the padded products cost
// less than the FP32-core kernel it replaces), and the head's one output
// takes NB = 16. Cin not a multiple of 8 (or an input that is not 16-byte
// aligned) is staged with 2-byte loads instead of cp.async. The epilogue
// stages the rounded tile in shared memory and stores it with 16-byte
// writes along Co where Co allows (bf16: Co % 8 == 0; f32: Co % 4 == 0),
// else element by element.
//
// Plain C entry point; it returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int KS = 16;        // input channels a K slice: one mma k-step

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

// A block's output tile (TH rows x TW columns) and its warps: WM x WN
// warps, each MT m16 fragments (16 pixels of one row) x NT n8 fragments.
template <int NB>
struct Cfg;
template <>
struct Cfg<16> {
    static constexpr int TH = 8, TW = 64, WM = 8, WN = 1, MT = 4, NT = 2;
};
template <>
struct Cfg<32> {
    static constexpr int TH = 8, TW = 64, WM = 8, WN = 1, MT = 4, NT = 4;
};
template <>
struct Cfg<64> {
    static constexpr int TH = 8, TW = 32, WM = 4, WN = 2, MT = 4, NT = 4;
};
template <>
struct Cfg<128> {
    static constexpr int TH = 8, TW = 16, WM = 4, WN = 2, MT = 2, NT = 8;
};

// byte offset of half `hf` (channels 8 hf .. 8 hf + 7) of 32-byte row `r`
__device__ __forceinline__ uint32_t swz(int r, int hf) {
    return static_cast<uint32_t>(r * 32 + ((hf ^ ((r >> 2) & 1)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    // src_bytes 0 fills the 16 bytes with zeros and reads nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
                 : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float activate(float v, int act) {
    if (act == ACT_RELU) return fmaxf(v, 0.f);
    if (act == ACT_SIGMOID) return 1.f / (1.f + expf(-v));
    return v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <int NB, typename TOut>
__host__ __device__ constexpr int out_stride() {
    return NB + 16 / static_cast<int>(sizeof(TOut));  // + 16 bytes: rows 16 bytes apart in banks
}

template <int NB, typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_same_mma_k(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
                      const float* __restrict__ bias, TOut* __restrict__ y, int h, int wd, int cin,
                      int co, int kh, int kw, int act, int vec) {
    using C = Cfg<NB>;
    constexpr int TH = C::TH, TW = C::TW, MT = C::MT, NT = C::NT, SEGS = TW / 16;
    constexpr int OSTR = out_stride<NB, TOut>();
    extern __shared__ __align__(16) unsigned char smem[];

    const int lo_h = (kh - 1) / 2, lo_w = (kw - 1) / 2;
    const int sr = TH + kh - 1, sc = TW + kw - 1, taps = kh * kw;
    const int x_bytes = sr * sc * 32;
    const int stage_bytes = x_bytes + taps * NB * 32;
    const int slices = (cin + KS - 1) / KS, halves = (co + NB - 1) / NB;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp % C::WM, wn = warp / C::WM;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH, n = blockIdx.z;
    const __nv_bfloat16* xn = x + static_cast<long long>(n) * h * wd * cin;
    const uint32_t s_base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

    // slice s of N half nh into buffer buf: the input tile + halo, zero
    // outside the image and past Cin, and the slice's packed weights
    auto load_stage = [&](int nh, int s, int buf) {
        const uint32_t xs = s_base + buf * stage_bytes, ws = xs + x_bytes;
        const int c0 = s * KS;
        if (vec) {
            for (int i = tid; i < sr * sc * 2; i += THREADS) {
                const int p = i >> 1, hf = i & 1;
                const int r = p / sc, c = p - r * sc;
                const int gy = y0 + r - lo_h, gx = x0 + c - lo_w, ch = c0 + hf * 8;
                const bool ok = gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < cin;
                const __nv_bfloat16* src = ok ? xn + (static_cast<long long>(gy) * wd + gx) * cin + ch : x;
                cp_async16(xs + swz(p, hf), src, ok ? 16 : 0);
            }
        } else {
            unsigned char* xb = smem + buf * stage_bytes;
            for (int i = tid; i < sr * sc * KS; i += THREADS) {
                const int p = i / KS, k = i - p * KS;
                const int r = p / sc, c = p - r * sc;
                const int gy = y0 + r - lo_h, gx = x0 + c - lo_w, ch = c0 + k;
                __nv_bfloat16 v = __float2bfloat16_rn(0.f);
                if (gy >= 0 && gy < h && gx >= 0 && gx < wd && ch < cin)
                    v = xn[(static_cast<long long>(gy) * wd + gx) * cin + ch];
                *reinterpret_cast<__nv_bfloat16*>(xb + swz(p, k >> 3) + (k & 7) * 2) = v;
            }
        }
        const __nv_bfloat16* wsrc = wp + static_cast<long long>(nh * slices + s) * taps * NB * KS;
        for (int i = tid; i < taps * NB * 2; i += THREADS) cp_async16(ws + swz(i >> 1, i & 1), wsrc + i * 8, 16);
    };

    // ldmatrix row addresses: A rows are pixels (channels along k), B rows
    // are output channels (input channels along k)
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_hf = lane >> 4;
    const int b_row = (lane & 7) + (lane >> 4) * 8, b_hf = (lane >> 3) & 1;
    const int g = lane >> 2, q = lane & 3;

    for (int nh = 0; nh < halves; ++nh) {
        float acc[MT][NT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

        load_stage(nh, 0, 0);
        cp_async_commit();
        for (int s = 0; s < slices; ++s) {
            if (s + 1 < slices) load_stage(nh, s + 1, (s + 1) & 1);
            cp_async_commit();
            cp_async_wait_one();  // slice s has landed (this thread's copies)
            __syncthreads();      // ... and every thread's
            const uint32_t xs = s_base + (s & 1) * stage_bytes, ws = xs + x_bytes;
            for (int dy = 0; dy < kh; ++dy) {
                for (int dx = 0; dx < kw; ++dx) {
                    const int tap = dy * kw + dx;
                    uint32_t b[NT][2];
#pragma unroll
                    for (int j = 0; j < NT / 2; ++j) {
                        const int row = tap * NB + wn * NT * 8 + j * 16 + b_row;
                        ldmatrix_x4(ws + swz(row, b_hf), b[2 * j][0], b[2 * j][1], b[2 * j + 1][0],
                                    b[2 * j + 1][1]);
                    }
#pragma unroll
                    for (int i = 0; i < MT; ++i) {
                        const int mi = wm * MT + i, r = mi / SEGS, seg = mi % SEGS;
                        const int p = (r + dy) * sc + seg * 16 + dx + a_row;
                        uint32_t a[4];
                        ldmatrix_x4(xs + swz(p, a_hf), a[0], a[1], a[2], a[3]);
#pragma unroll
                        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
                    }
                }
            }
            __syncthreads();  // the buffer is free for the slice after next
        }

        // epilogue: f32 bias and activation, one rounding, staged in the
        // (now free) shared memory as (pixel, channel) rows
        TOut* s_out = reinterpret_cast<TOut*>(smem);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int nl = wn * NT * 8 + j * 8 + q * 2, o = nh * NB + nl;
            const float b0 = o < co ? bias[o] : 0.f, b1 = o + 1 < co ? bias[o + 1] : 0.f;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int mi = wm * MT + i, r = mi / SEGS, seg = mi % SEGS;
                const int lp = r * TW + seg * 16 + g;
                store2(s_out + lp * OSTR + nl, activate(acc[i][j][0] + b0, act),
                       activate(acc[i][j][1] + b1, act));
                store2(s_out + (lp + 8) * OSTR + nl, activate(acc[i][j][2] + b0, act),
                       activate(acc[i][j][3] + b1, act));
            }
        }
        __syncthreads();
        constexpr int CH = 16 / static_cast<int>(sizeof(TOut));  // outputs a 16-byte store
        const int nvalid = min(NB, co - nh * NB);
        TOut* yn = y + static_cast<long long>(n) * h * wd * co + nh * NB;
        if (co % CH == 0) {
            const int cpp = nvalid / CH;
            for (int i = tid; i < TH * TW * cpp; i += THREADS) {
                const int lp = i / cpp, k = i - lp * cpp;
                const int gy = y0 + lp / TW, gx = x0 + lp % TW;
                if (gy < h && gx < wd)
                    *reinterpret_cast<uint4*>(yn + (static_cast<long long>(gy) * wd + gx) * co + k * CH) =
                        *reinterpret_cast<const uint4*>(s_out + lp * OSTR + k * CH);
            }
        } else {
            for (int i = tid; i < TH * TW * nvalid; i += THREADS) {
                const int lp = i / nvalid, k = i - lp * nvalid;
                const int gy = y0 + lp / TW, gx = x0 + lp % TW;
                if (gy < h && gx < wd) yn[(static_cast<long long>(gy) * wd + gx) * co + k] = s_out[lp * OSTR + k];
            }
        }
        __syncthreads();  // s_out is the next half's stage buffer
    }
}

template <int NB, typename TOut>
int launch(const void* x, const void* wp, const float* b, void* y, int n, int h, int wd, int cin,
           int co, int kh, int kw, int act, cudaStream_t stream) {
    using C = Cfg<NB>;
    const int stage = ((C::TH + kh - 1) * (C::TW + kw - 1) + kh * kw * NB) * 32;
    const int out = C::TH * C::TW * out_stride<NB, TOut>() * static_cast<int>(sizeof(TOut));
    const int smem = 2 * stage > out ? 2 * stage : out;
    static int smem_allowed = 48 * 1024;  // the default limit of dynamic shared memory
    if (smem > smem_allowed) {
        const cudaError_t e = cudaFuncSetAttribute(conv2d_same_mma_k<NB, TOut>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        smem_allowed = smem;
    }
    const int vec = cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const dim3 grid((wd + C::TW - 1) / C::TW, (h + C::TH - 1) / C::TH, n);
    conv2d_same_mma_k<NB, TOut><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wp), b,
        static_cast<TOut*>(y), h, wd, cin, co, kh, kw, act, vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename TOut>
int dispatch(const void* x, const void* wp, const float* b, void* y, int n, int h, int wd, int cin,
             int co, int kh, int kw, int nb, int act, cudaStream_t s) {
    switch (nb) {
        case 16: return launch<16, TOut>(x, wp, b, y, n, h, wd, cin, co, kh, kw, act, s);
        case 32: return launch<32, TOut>(x, wp, b, y, n, h, wd, cin, co, kh, kw, act, s);
        case 64: return launch<64, TOut>(x, wp, b, y, n, h, wd, cin, co, kh, kw, act, s);
        case 128: return launch<128, TOut>(x, wp, b, y, n, h, wd, cin, co, kh, kw, act, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" {

// x (n, h, wd, cin) bf16 NHWC; wp the packed weights (ceil(co / nb),
// ceil(cin / 16), kh * kw, nb, 16) bf16 (ops/conv2d.pack_weights); b (co)
// f32; y (n, h, wd, co) bf16, or f32 when out_f32. nb in {16, 32, 64, 128},
// kh, kw <= 3, n <= 65535 (the wrapper checks). act: 0 none, 1 relu,
// 2 sigmoid.
int conv2d_same_mma_bf16(const void* x, const void* wp, const float* b, void* y, int out_f32, int n,
                         int h, int wd, int cin, int co, int kh, int kw, int nb, int act,
                         void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kh < 1 || kh > 3 || kw < 1 || kw > 3) return static_cast<int>(cudaErrorInvalidValue);
    if (out_f32) return dispatch<float>(x, wp, b, y, n, h, wd, cin, co, kh, kw, nb, act, s);
    return dispatch<__nv_bfloat16>(x, wp, b, y, n, h, wd, cin, co, kh, kw, nb, act, s);
}

}  // extern "C"
