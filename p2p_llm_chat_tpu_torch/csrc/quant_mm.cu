// Kernel A: w8a16 GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
//   out[M, O] bf16 = (x[M, H] bf16 . q[H, O] int8) * s[O] f32
//
// Replaces the Pallas kernels of p2p_llm_chat_tpu/ops/quant_mm.py:
// quant_matmul_stacked (bodies _qmm_kernel_1d_stacked / _qmm_kernel_2d_stacked)
// and quant_matmul (bodies _qmm_kernel_1d / _qmm_kernel). The stacked and
// 2-D forms are one entry point: the wrapper passes q and s already offset
// to the layer (a byte offset of layer*H*O), so no per-layer slice copy is
// ever made.
//
// Bound on an H100 SXM: at decode shapes (M <= 32) the int8 weight stream
// dominates — every weight byte is read once, f32 FMAs are far below the
// card's rate — so the bound is H*O bytes over 3.35 TB/s (llama3.1-8b:
// wgu 117 MB -> 35 us). At M = 512 (short-prompt prefill) the same FMAs
// run on the CUDA cores, far from the tensor-core rate; that shape is
// correct but slow, and is recorded as such.
//
// Design (simple first, made fast in a later change):
// - a block of 256 threads owns a BM x BO = 16 x 128 output tile and walks
//   its share of H in BK = 64 steps;
// - the int8 [BK, BO] tile is read with 16-byte coalesced loads (O is the
//   contiguous axis) into shared memory; x [BM, BK] is converted to f32 on
//   the way into shared memory; int8 -> f32 conversion happens in registers;
// - each thread accumulates a 2 x 4 sub-tile in f32; the per-output-channel
//   scale is applied once in the epilogue;
// - split-K over H: at O = 4096 a 128-wide tile gives only 32 blocks for
//   132 SMs, so the wrapper asks for `splits` slices of H; each slice
//   writes f32 partials to a workspace and a second small kernel sums them
//   in a fixed order (deterministic — no atomics) and applies the scale.
// Ragged M, H and O are masked, so tiny test shapes and O = 128256 both run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BO = 128;
constexpr int BK = 64;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
           float* __restrict__ ws, int M, int H, int O, int ktiles_per_split,
           int vec)
{
    __shared__ float xs[BM][BK];
    __shared__ __align__(16) int8_t qs[BK][BO];

    const int tid = threadIdx.x;
    const int o0 = blockIdx.x * BO;
    const int m0 = blockIdx.y * BM;
    const int split = blockIdx.z;
    const int nkt = (H + BK - 1) / BK;
    const int kt_begin = split * ktiles_per_split;
    const int kt_end = min(nkt, kt_begin + ktiles_per_split);

    const int tx = tid & 31;          // columns o0 + 4*tx .. +3
    const int ty = tid >> 5;          // rows m0 + 2*ty, +1
    float acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        // int8 tile [BK, BO]: 512 chunks of 16 bytes, two per thread.
        for (int c = tid; c < BK * BO / 16; c += THREADS) {
            const int kr = c / (BO / 16);
            const int cc = (c % (BO / 16)) * 16;
            const int k = k0 + kr;
            const int o = o0 + cc;
            int4 v = make_int4(0, 0, 0, 0);
            if (k < H) {
                const int8_t* src = q + (size_t)k * O + o;
                if (vec && o + 16 <= O) {
                    v = *reinterpret_cast<const int4*>(src);
                } else {
                    alignas(16) int8_t tmp[16];
#pragma unroll
                    for (int i = 0; i < 16; ++i)
                        tmp[i] = (o + i < O) ? src[i] : (int8_t)0;
                    v = *reinterpret_cast<const int4*>(tmp);
                }
            }
            *reinterpret_cast<int4*>(&qs[kr][cc]) = v;
        }
        // x tile [BM, BK] -> f32.
        for (int c = tid; c < BM * BK; c += THREADS) {
            const int mr = c / BK;
            const int kc = c % BK;
            const int m = m0 + mr;
            const int k = k0 + kc;
            xs[mr][kc] = (m < M && k < H)
                ? __bfloat162float(x[(size_t)m * H + k]) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            const char4 w = *reinterpret_cast<const char4*>(&qs[kk][4 * tx]);
            const float w0 = (float)w.x, w1 = (float)w.y;
            const float w2 = (float)w.z, w3 = (float)w.w;
            const float a0 = xs[2 * ty][kk];
            const float a1 = xs[2 * ty + 1][kk];
            acc[0][0] = fmaf(a0, w0, acc[0][0]);
            acc[0][1] = fmaf(a0, w1, acc[0][1]);
            acc[0][2] = fmaf(a0, w2, acc[0][2]);
            acc[0][3] = fmaf(a0, w3, acc[0][3]);
            acc[1][0] = fmaf(a1, w0, acc[1][0]);
            acc[1][1] = fmaf(a1, w1, acc[1][1]);
            acc[1][2] = fmaf(a1, w2, acc[1][2]);
            acc[1][3] = fmaf(a1, w3, acc[1][3]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int m = m0 + 2 * ty + r;
        if (m >= M) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int o = o0 + 4 * tx + c;
            if (o >= O) continue;
            if (ws != nullptr)
                ws[((size_t)split * M + m) * O + o] = acc[r][c];
            else
                out[(size_t)m * O + o] = __float2bfloat16(acc[r][c] * s[o]);
        }
    }
}

// Fixed-order sum of the split-K partials, then the per-channel scale.
__global__ void qmm_reduce(const float* __restrict__ ws,
                           const float* __restrict__ s,
                           __nv_bfloat16* __restrict__ out, int M, int O,
                           int splits)
{
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t n = (size_t)M * O;
    if (i >= n) return;
    float a = 0.f;
    for (int sp = 0; sp < splits; ++sp) a += ws[(size_t)sp * n + i];
    out[i] = __float2bfloat16(a * s[i % O]);
}

}  // namespace

extern "C" {

// x [M,H] bf16; q [H,O] int8 and s [O] f32 already offset to the layer;
// out [M,O] bf16; ws [splits,M,O] f32 (unused when splits == 1).
int qmm_launch(const void* x, const void* q, const void* s, void* out,
               void* ws, int M, int H, int O, int splits,
               int ktiles_per_split, int vec, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    dim3 grid((O + BO - 1) / BO, (M + BM - 1) / BM, splits);
    qmm_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out),
        splits > 1 ? static_cast<float*>(ws) : nullptr, M, H, O,
        ktiles_per_split, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n = (size_t)M * O;
    const int threads = 256;
    qmm_reduce<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        static_cast<const float*>(ws), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), M, O, splits);
    return (int)cudaGetLastError();
}

const char* qmm_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
