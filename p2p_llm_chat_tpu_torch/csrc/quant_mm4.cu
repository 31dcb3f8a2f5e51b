// Kernel C: w4a16 GEMM for Hopper (sm_90a), plain C interface for ctypes.
//
//   out[M, O] bf16 = sum_k x[M, k] bf16 * W[k, O],  summed in f32, with
//   W[k, o] = (nib(k, o) - 8) * s[k / G, o],  G = K / ng,
//
// where nib(k, o) is the low nibble of byte q[k, o] for k < K/2 and the
// high nibble of q[k - K/2, o] otherwise (the split-half packing of
// models/quant.pack4: q [K/2, O] int8, s [ng, O] f32).
//
// Replaces the Pallas kernels of p2p_llm_chat_tpu/ops/quant_mm.py:
// quant_matmul4 (_qmm4_kernel_1d), quant_matmul_stacked4
// (_qmm4_kernel_1d_stacked) and quant_matmul_experts_stacked4
// (_qmm4_kernel_experts_stacked), all sharing the body _qmm4_body. One
// entry point serves them: the wrapper passes q and s already offset to
// the layer (layer*(K/2)*O bytes, layer*ng*O floats), so no per-layer
// slice copy is made, and a batch (expert) index walks x [NE, C, K],
// q [NE, K/2, O], s [NE, ng, O] and out [NE, C, O] (batch 1 for the dense
// forms).
//
// Bound on an H100 SXM: at decode shapes (M <= 32) the packed weight
// stream dominates — K/2*O bytes plus 4*ng*O of scales, read once — so
// the bound is bytes over 3.35 TB/s (one mixtral-8x7b int4 decode layer
// streams ~741 MB of experts: 0.22 ms, reckoned from the data sheet). At
// M = 512 the FMAs run on the CUDA cores, far from the tensor-core rate;
// that shape is correct but slow, and is recorded as such.
//
// Design (simple first, made fast in a later change), kernel A's shape:
// - a block of 256 threads owns a BM x BO = 16 x 128 output tile and walks
//   its share of the K/2 packed rows in BKP = 32 steps; a step needs x's
//   columns [r0, r0+BKP) (low nibbles) and [K/2+r0, K/2+r0+BKP) (high);
// - the packed [BKP, BO] tile is read with 16-byte coalesced loads into
//   shared memory; nibbles are unpacked in registers from uint8 (the
//   bytes are never sign-extended);
// - the group scale: where every step lies inside one group for both
//   halves (G and K/2 multiples of BKP — every shape the port's quantizer
//   makes, including the odd group counts whose high half starts
//   mid-group), each thread keeps the step's low and high partial sums
//   apart and folds one scale into each per step, as the TPU kernel does
//   per segment. Otherwise (any other group that divides K) the scale is
//   folded per element;
// - split-K over the packed rows, chosen by the wrapper from (K, O, batch,
//   SM count) and never from M; partials go to an f32 workspace and a
//   second kernel sums them in a fixed order (deterministic, no atomics).
// Ragged M, K/2 and O are masked, so tiny test shapes run too.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BO = 128;
constexpr int BKP = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ float nib_lo(uint32_t b)
{
    return (float)((int)(b & 15u) - 8);
}

__device__ __forceinline__ float nib_hi(uint32_t b)
{
    return (float)((int)(b >> 4) - 8);
}

template <bool UNIFORM>
__global__ void __launch_bounds__(THREADS)
qmm4_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ q, const float* __restrict__ s,
            __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M,
            int K, int O, int ng, int splits, int ktiles_per_split, int vec)
{
    __shared__ float xs_lo[BM][BKP];
    __shared__ float xs_hi[BM][BKP];
    __shared__ __align__(16) uint8_t qs[BKP][BO];

    const int tid = threadIdx.x;
    const int Kh = K / 2;
    const int G = K / ng;
    const int o0 = blockIdx.x * BO;
    const int m0 = blockIdx.y * BM;
    const int b = blockIdx.z / splits;     // batch (expert) index
    const int split = blockIdx.z % splits;
    x += (size_t)b * M * K;
    q += (size_t)b * Kh * O;
    s += (size_t)b * ng * O;
    out += (size_t)b * M * O;
    const int nkt = (Kh + BKP - 1) / BKP;
    const int kt_begin = split * ktiles_per_split;
    const int kt_end = min(nkt, kt_begin + ktiles_per_split);

    const int tx = tid & 31;          // columns o0 + 4*tx .. +3
    const int ty = tid >> 5;          // rows m0 + 2*ty, +1
    // Scale columns, clamped so the masked edge never reads past O.
    int oc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) oc[c] = min(o0 + 4 * tx + c, O - 1);
    float acc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BKP;
        // Packed tile [BKP, BO]: 256 chunks of 16 bytes, one per thread.
        // Rows past K/2 hold 0x88 (both nibbles 8: weight 0).
        {
            const int kr = tid / (BO / 16);
            const int cc = (tid % (BO / 16)) * 16;
            const int k = k0 + kr;
            const int o = o0 + cc;
            int4 v = make_int4(0x88888888, 0x88888888, 0x88888888,
                               0x88888888);
            if (k < Kh) {
                const uint8_t* src = q + (size_t)k * O + o;
                if (vec && o + 16 <= O) {
                    v = *reinterpret_cast<const int4*>(src);
                } else {
                    alignas(16) uint8_t tmp[16];
#pragma unroll
                    for (int i = 0; i < 16; ++i)
                        tmp[i] = (o + i < O) ? src[i] : (uint8_t)0x88;
                    v = *reinterpret_cast<const int4*>(tmp);
                }
            }
            *reinterpret_cast<int4*>(&qs[kr][cc]) = v;
        }
        // x tiles [BM, BKP] for both halves -> f32 (0 past K/2 or M).
        for (int c = tid; c < BM * BKP; c += THREADS) {
            const int mr = c / BKP;
            const int kc = c % BKP;
            const int m = m0 + mr;
            const int k = k0 + kc;
            const bool ok = m < M && k < Kh;
            const __nv_bfloat16* row = x + (size_t)m * K;
            xs_lo[mr][kc] = ok ? __bfloat162float(row[k]) : 0.f;
            xs_hi[mr][kc] = ok ? __bfloat162float(row[Kh + k]) : 0.f;
        }
        __syncthreads();
        if (UNIFORM) {
            // The step's low rows lie in group k0/G and its high rows in
            // (K/2+k0)/G: sum each half apart, then scale once.
            float p_lo[2][4], p_hi[2][4];
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) p_lo[r][c] = p_hi[r][c] = 0.f;
#pragma unroll 8
            for (int kk = 0; kk < BKP; ++kk) {
                const uint32_t w =
                    *reinterpret_cast<const uint32_t*>(&qs[kk][4 * tx]);
                const float a0 = xs_lo[2 * ty][kk];
                const float a1 = xs_lo[2 * ty + 1][kk];
                const float h0 = xs_hi[2 * ty][kk];
                const float h1 = xs_hi[2 * ty + 1][kk];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t byte = (w >> (8 * c)) & 0xFFu;
                    const float lo = nib_lo(byte), hi = nib_hi(byte);
                    p_lo[0][c] = fmaf(a0, lo, p_lo[0][c]);
                    p_lo[1][c] = fmaf(a1, lo, p_lo[1][c]);
                    p_hi[0][c] = fmaf(h0, hi, p_hi[0][c]);
                    p_hi[1][c] = fmaf(h1, hi, p_hi[1][c]);
                }
            }
            const float* s_lo = s + (size_t)(k0 / G) * O;
            const float* s_hi = s + (size_t)((Kh + k0) / G) * O;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float sl = s_lo[oc[c]], sh = s_hi[oc[c]];
#pragma unroll
                for (int r = 0; r < 2; ++r)
                    acc[r][c] = fmaf(p_hi[r][c], sh,
                                     fmaf(p_lo[r][c], sl, acc[r][c]));
            }
        } else {
            const int kmax = min(BKP, Kh - k0);
            for (int kk = 0; kk < kmax; ++kk) {
                const uint32_t w =
                    *reinterpret_cast<const uint32_t*>(&qs[kk][4 * tx]);
                const float* s_lo = s + (size_t)((k0 + kk) / G) * O;
                const float* s_hi = s + (size_t)((Kh + k0 + kk) / G) * O;
                const float a0 = xs_lo[2 * ty][kk];
                const float a1 = xs_lo[2 * ty + 1][kk];
                const float h0 = xs_hi[2 * ty][kk];
                const float h1 = xs_hi[2 * ty + 1][kk];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t byte = (w >> (8 * c)) & 0xFFu;
                    const float lo = nib_lo(byte) * s_lo[oc[c]];
                    const float hi = nib_hi(byte) * s_hi[oc[c]];
                    acc[0][c] = fmaf(h0, hi, fmaf(a0, lo, acc[0][c]));
                    acc[1][c] = fmaf(h1, hi, fmaf(a1, lo, acc[1][c]));
                }
            }
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
                ws[((size_t)blockIdx.z * M + m) * O + o] = acc[r][c];
            else
                out[(size_t)m * O + o] = __float2bfloat16(acc[r][c]);
        }
    }
}

// Fixed-order sum of the split-K partials (already scaled).
// ws [batch, splits, M, O]; out [batch, M, O].
__global__ void qmm4_reduce(const float* __restrict__ ws,
                            __nv_bfloat16* __restrict__ out, int batch, int M,
                            int O, int splits)
{
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t n = (size_t)M * O;
    if (i >= (size_t)batch * n) return;
    const float* w = ws + (i / n) * splits * n + i % n;
    float a = 0.f;
    for (int sp = 0; sp < splits; ++sp) a += w[(size_t)sp * n];
    out[i] = __float2bfloat16(a);
}

}  // namespace

extern "C" {

// x [batch, M, K] bf16; q [batch, K/2, O] int8 and s [batch, ng, O] f32
// already offset to the layer; out [batch, M, O] bf16; ws [batch, splits,
// M, O] f32 (unused when splits == 1). `uniform` selects the per-step
// scale fold; the wrapper sets it only where (K/ng) % 32 == 0 and
// (K/2) % 32 == 0.
int qmm4_launch(const void* x, const void* q, const void* s, void* out,
                void* ws, int batch, int M, int K, int O, int ng, int splits,
                int ktiles_per_split, int vec, int uniform, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    dim3 grid((O + BO - 1) / BO, (M + BM - 1) / BM, batch * splits);
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* qp = static_cast<const uint8_t*>(q);
    const auto* sp = static_cast<const float*>(s);
    auto* op = static_cast<__nv_bfloat16*>(out);
    float* wp = splits > 1 ? static_cast<float*>(ws) : nullptr;
    if (uniform)
        qmm4_kernel<true><<<grid, THREADS, 0, st>>>(
            xp, qp, sp, op, wp, M, K, O, ng, splits, ktiles_per_split, vec);
    else
        qmm4_kernel<false><<<grid, THREADS, 0, st>>>(
            xp, qp, sp, op, wp, M, K, O, ng, splits, ktiles_per_split, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n = (size_t)batch * M * O;
    const int threads = 256;
    qmm4_reduce<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        wp, op, batch, M, O, splits);
    return (int)cudaGetLastError();
}

const char* qmm4_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
