// Stride-1 SAME 2D convolution with f32 operands and a fused bias +
// activation epilogue (ops/conv2d.py): K11's f32-operand route. The U-Net
// runs bf16 operands through csrc/conv2d_mma.cu on the tensor cores; this
// route keeps f32 operands exact on the FP32 cores (the tensor cores would
// take them only as TF32).
//
// Replaces, for f32 operands, the Pallas kernel of merfish3d_tpu/ops/conv2d.py:
//   K11 conv2d_lanepack_packed (_conv_scan_kernel)
//
// y[n, i, j, o] = act(b[o] + sum over (dy, dx, c) of
// x[n, i + dy - lo_h, j + dx - lo_w, c] * w[dy, dx, c, o]), zero outside the
// image, with SAME's lo = (k - 1) / 2 on each axis (the 2x2 decoder kernels
// take lo 0, hi 1). Any Cin and Co; k <= 3 on each axis. Every sum runs in
// f32 in another order than a CPU or cuDNN convolution.
//
// Bound: at 3x3 and 32 to 128 channels a convolution is bound by
// operations, here the FP32 cores' (67 TFLOP/s).
//
// Design: a block of 8 warps owns an 8-row x 128-column tile of output
// pixels and 16 output channels. Each thread holds 4 pixels of its row, 32
// columns apart (so a warp's shared-memory reads are 32 consecutive words),
// times the 16 channels: 64 f32 accumulators in registers. Input channels
// are staged 8 at a time: the input tile with its halo (8 channels x
// (8 + kh - 1) rows x (128 + kw - 1) columns, at most 41.6 KB) and the
// matching weight slice (kh*kw x 8 x 16, read as broadcast float4) sit in
// shared memory, so every loaded value feeds 16 (input) or 4 (weight) FMAs.
// Input is re-read once per 16-channel group of the output, mostly from L2.
//
// Plain C entry point; it returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;         // threads along x: one warp a row
constexpr int PX = 4;             // output pixels a thread, LANES apart in x
constexpr int TW = LANES * PX;    // output columns a block
constexpr int TH = 8;             // output rows a block, one warp each
constexpr int COT = 16;           // output channels a block and a thread
constexpr int CIC = 8;            // input channels staged a pass
constexpr int THREADS = LANES * TH;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

template <int KH, int KW>
__global__ void __launch_bounds__(THREADS, 2)
    conv2d_same_k(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                  float* __restrict__ y, int h, int wd, int cin, int co, int co_blocks, int act) {
    constexpr int LO_H = (KH - 1) / 2, LO_W = (KW - 1) / 2;
    constexpr int SR = TH + KH - 1, SC = TW + KW - 1;
    __shared__ float s_x[CIC][SR][SC];
    __shared__ __align__(16) float s_w[KH * KW][CIC][COT];

    const int lane = threadIdx.x, row = threadIdx.y;
    const int tid = row * LANES + lane;
    const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
    const int n = blockIdx.z / co_blocks;
    const int co0 = (blockIdx.z - n * co_blocks) * COT;
    const float* xn = x + static_cast<long long>(n) * h * wd * cin;

    float acc[PX][COT];
#pragma unroll
    for (int p = 0; p < PX; ++p)
#pragma unroll
        for (int o = 0; o < COT; ++o) acc[p][o] = 0.f;

    for (int c0 = 0; c0 < cin; c0 += CIC) {
        const int nc = min(CIC, cin - c0);
        __syncthreads();  // the previous pass has finished reading
        // input tile + halo, channel fastest (neighbouring threads read
        // neighbouring channels of one pixel); zero outside the image
        for (int i = tid; i < CIC * SR * SC; i += THREADS) {
            const int ci = i % CIC, pix = i / CIC;
            const int c = pix % SC, r = pix / SC;
            const int gy = y0 + r - LO_H, gx = x0 + c - LO_W;
            float v = 0.f;
            if (ci < nc && gy >= 0 && gy < h && gx >= 0 && gx < wd)
                v = xn[(static_cast<long long>(gy) * wd + gx) * cin + c0 + ci];
            s_x[ci][r][c] = v;
        }
        // the weights' (tap, ci, co) slice; HWIO in memory
        for (int i = tid; i < KH * KW * CIC * COT; i += THREADS) {
            const int o = i % COT, ci = (i / COT) % CIC, tap = i / (COT * CIC);
            float v = 0.f;
            if (ci < nc && co0 + o < co)
                v = w[(static_cast<long long>(tap) * cin + c0 + ci) * co + co0 + o];
            s_w[tap][ci][o] = v;
        }
        __syncthreads();
        for (int ci = 0; ci < nc; ++ci) {
#pragma unroll
            for (int dy = 0; dy < KH; ++dy) {
#pragma unroll
                for (int dx = 0; dx < KW; ++dx) {
                    float xv[PX];
#pragma unroll
                    for (int p = 0; p < PX; ++p) xv[p] = s_x[ci][row + dy][lane + p * LANES + dx];
                    const float4* wv = reinterpret_cast<const float4*>(s_w[dy * KW + dx][ci]);
#pragma unroll
                    for (int q = 0; q < COT / 4; ++q) {
                        const float4 w4 = wv[q];
#pragma unroll
                        for (int p = 0; p < PX; ++p) {
                            acc[p][4 * q + 0] = fmaf(xv[p], w4.x, acc[p][4 * q + 0]);
                            acc[p][4 * q + 1] = fmaf(xv[p], w4.y, acc[p][4 * q + 1]);
                            acc[p][4 * q + 2] = fmaf(xv[p], w4.z, acc[p][4 * q + 2]);
                            acc[p][4 * q + 3] = fmaf(xv[p], w4.w, acc[p][4 * q + 3]);
                        }
                    }
                }
            }
        }
    }

    // epilogue: f32 bias and activation
    const int gy = y0 + row;
    if (gy >= h) return;
    float b[COT];
#pragma unroll
    for (int o = 0; o < COT; ++o) b[o] = co0 + o < co ? bias[co0 + o] : 0.f;
#pragma unroll
    for (int p = 0; p < PX; ++p) {
        const int gx = x0 + lane + p * LANES;
        if (gx >= wd) continue;
        float* out = y + ((static_cast<long long>(n) * h + gy) * wd + gx) * co + co0;
#pragma unroll
        for (int o = 0; o < COT; ++o) {
            float v = acc[p][o] + b[o];
            if (act == ACT_RELU) {
                v = fmaxf(v, 0.f);
            } else if (act == ACT_SIGMOID) {
                v = 1.f / (1.f + expf(-v));
            }
            if (co0 + o < co) out[o] = v;
        }
    }
}

template <int KH, int KW>
int launch(const float* x, const float* w, const float* b, float* y, int n, int h, int wd, int cin,
           int co, int act, cudaStream_t stream) {
    const int co_blocks = (co + COT - 1) / COT;
    const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n * co_blocks);
    conv2d_same_k<KH, KW><<<grid, dim3(LANES, TH), 0, stream>>>(x, w, b, y, h, wd, cin, co, co_blocks, act);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n, h, wd, cin) and w (kh, kw, cin, co) f32, b (co) f32; y (n, h, wd,
// co) f32. act: 0 none, 1 relu, 2 sigmoid. n * ceil(co / 16) <= 65535 (the
// wrapper checks).
int conv2d_same_f32(const float* x, const float* w, const float* b, float* y, int n, int h, int wd,
                    int cin, int co, int kh, int kw, int act, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K11_CASE(KH, KW) \
    if (kh == KH && kw == KW) return launch<KH, KW>(x, w, b, y, n, h, wd, cin, co, act, s);
    K11_CASE(1, 1) K11_CASE(1, 2) K11_CASE(1, 3)
    K11_CASE(2, 1) K11_CASE(2, 2) K11_CASE(2, 3)
    K11_CASE(3, 1) K11_CASE(3, 2) K11_CASE(3, 3)
#undef K11_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
