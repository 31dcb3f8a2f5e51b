// Kernel B: paged decode attention for Hopper (sm_90a), plain C
// interface for ctypes. Two modes over one split-K kernel.
//
// Append mode (paged_append_launch) replaces
// p2p_llm_chat_tpu/ops/paged_attention.py _paged_attention_flash_append
// (:993, body _flash_append_kernel_body) and _paged_append_kernel_call
// (:331, the same function over an XLA-gathered window with
// selection-matmul GQA), and on this card also the XLA gather path that
// the TPU ran at short windows. For each row b, kv head g and each of its
// `rep` query heads:
//   s_t   = (q . k_t) / sqrt(D) * sk_t      for t < lengths[b]
//   s_cur = (q . k_cur) / sqrt(D)
//   out   = (sum_t e^{s_t-m} sv_t v_t + e^{s_cur-m} v_cur)
//         / (sum_t e^{s_t-m} + e^{s_cur-m})
// The current token is attended at full precision and is NOT in the pool
// (the model lands the whole step's k/v after the layer loop).
//
// Pool mode (paged_pool_launch) replaces _paged_attention_kernel (:160,
// grid (B, pages)) and _paged_attention_flash (:1086, a per-row DMA chunk
// loop), which compute one function, and serves the gather impl's int8
// pool (_paged_attention_gather_quant, :536): write-then-attend, the
// caller has written this step's k/v into the pool and passes lengths
// counting it, so
//   out = sum_t e^{s_t-m} sv_t v_t / sum_t e^{s_t-m}   for t < lengths[b]
// with no current-token term (sk = sv = 1 on bf16 pools).
//
// In both modes positions >= lengths[b] are skipped, never loaded and
// multiplied by 0: a garbage page may hold NaN or Inf.
//
// Bound on an H100 SXM: the pool read. At B = 8, W = 1024, Hkv = 8,
// D = 128 an int8 layer reads 16.8 MB of k/v (+ scales) -> ~5 us at
// 3.35 TB/s, a bf16 layer 33.6 MB -> ~10 us; the FLOPs (4 per k/v element
// per query head) are far below the card's rate.
//
// Design (the TPU kernels' VMEM budgets, DMA chunking and (B, pages)
// grid do not carry over: blocks here run in parallel, not in order):
// - grid (B, Hkv, splits): a block owns one kv head of one row and a
//   512-token share of its window, so long windows spread over many SMs
//   (split-K / flash-decoding); a block loads its `rep` query rows once;
// - the block walks its share in 32-token tiles through the page table;
//   k/v tiles arrive with 16-byte coalesced loads, are converted to f32
//   (int8 pools fold their per-token scales in here) into shared memory;
// - scores: one (query head, token) pair per thread; online softmax per
//   query head on one warp (the tile is exactly a warp wide); p.v with
//   threads along D;
// - partial (m, l, acc) go to an f32 workspace; a small combine kernel
//   merges the splits, in append mode seeded with the current token
//   (m = s_cur, l = 1, acc = v_cur), in pool mode from (m = -inf, l = 0,
//   acc = 0), normalises and stores bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_REP = 8;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v)
{
    return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ page_table, int pt_stride,
                    const int* __restrict__ lengths,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int layer, int N, int ps, int ps_pad, int Hkv, int rep,
                    int pages, int split_tokens, float scale)
{
    constexpr int VEC = 16 / (int)sizeof(T);     // elements per 16 B load
    constexpr int CPR = D / VEC;                 // 16 B chunks per token row
    constexpr int MAX_OUT = (MAX_REP * D + THREADS - 1) / THREADS;

    __shared__ float Qs[MAX_REP][D];
    __shared__ float Ks[TILE][D + 1];
    __shared__ float Vs[TILE][D];
    __shared__ float Ps[MAX_REP][TILE];
    __shared__ float alpha_s[MAX_REP];

    const int b = blockIdx.x;
    const int g = blockIdx.y;
    const int sp = blockIdx.z;
    const int splits = gridDim.z;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int Hq = Hkv * rep;

    int len = lengths[b];
    const int window = pages * ps;
    if (len > window) len = window;
    const int t_begin = sp * split_tokens;
    const int t_end = min(len, t_begin + split_tokens);

    for (int i = tid; i < rep * D; i += THREADS) {
        const int r = i / D, d = i % D;
        Qs[r][d] = __bfloat162float(q[((size_t)b * Hq + g * rep + r) * D + d]);
    }

    float acc[MAX_OUT];
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) acc[j] = 0.f;
    // Running softmax state of the query heads this warp reduces
    // (r = warp, warp + WARPS); lane-uniform.
    float m_run[MAX_REP / WARPS];
    float l_run[MAX_REP / WARPS];
#pragma unroll
    for (int i = 0; i < MAX_REP / WARPS; ++i) {
        m_run[i] = NEG;
        l_run[i] = 0.f;
    }

    const size_t layer_pages = (size_t)layer * N;
    for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
        const int nvalid = min(TILE, t_end - t0);
        __syncthreads();   // previous tile's readers are done
        for (int c = tid; c < nvalid * CPR; c += THREADS) {
            const int t = c / CPR;
            const int d0 = (c % CPR) * VEC;
            const int pos = t0 + t;
            const int page = page_table[(size_t)b * pt_stride + pos / ps];
            const int slot = pos % ps;
            const size_t row = ((layer_pages + page) * ps + slot) * Hkv + g;
            float sk = 1.f, sv = 1.f;
            if (ks != nullptr) {
                const size_t si = ((layer_pages + page) * Hkv + g) * ps_pad
                                  + slot;
                sk = ks[si];
                sv = vs[si];
            }
            const int4 kr = *reinterpret_cast<const int4*>(kp + row * D + d0);
            const int4 vr = *reinterpret_cast<const int4*>(vp + row * D + d0);
            const T* ke = reinterpret_cast<const T*>(&kr);
            const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                Ks[t][d0 + i] = to_f(ke[i]) * sk;
                Vs[t][d0 + i] = to_f(ve[i]) * sv;
            }
        }
        __syncthreads();
        // Scores: one (query head, token) pair per thread.
        for (int i = tid; i < rep * TILE; i += THREADS) {
            const int r = i / TILE, t = i % TILE;
            if (t < nvalid) {
                float dot = 0.f;
#pragma unroll 8
                for (int d = 0; d < D; ++d) dot = fmaf(Qs[r][d], Ks[t][d], dot);
                Ps[r][t] = dot * scale;
            }
        }
        __syncthreads();
        // Online softmax: one warp per query head, a lane per token.
#pragma unroll
        for (int i = 0; i < MAX_REP / WARPS; ++i) {
            const int r = warp + i * WARPS;
            if (r >= rep) break;
            const bool valid = lane < nvalid;
            const float s = valid ? Ps[r][lane] : NEG;
            const float m_new = fmaxf(m_run[i], warp_max(s));
            const float p = valid ? expf(s - m_new) : 0.f;
            const float a = expf(m_run[i] - m_new);
            l_run[i] = l_run[i] * a + warp_sum(p);
            m_run[i] = m_new;
            Ps[r][lane] = p;
            if (lane == 0) alpha_s[r] = a;
        }
        __syncthreads();
        // p . v: threads along D, so Vs reads are conflict-free.
#pragma unroll
        for (int j = 0; j < MAX_OUT; ++j) {
            const int idx = tid + j * THREADS;
            if (idx < rep * D) {
                const int r = idx / D, d = idx % D;
                float sum = 0.f;
                for (int t = 0; t < nvalid; ++t)
                    sum = fmaf(Ps[r][t], Vs[t][d], sum);
                acc[j] = acc[j] * alpha_s[r] + sum;
            }
        }
    }

    const size_t hbase = (size_t)b * Hq + (size_t)g * rep;
#pragma unroll
    for (int j = 0; j < MAX_OUT; ++j) {
        const int idx = tid + j * THREADS;
        if (idx < rep * D) {
            const int r = idx / D, d = idx % D;
            ws_acc[((hbase + r) * splits + sp) * D + d] = acc[j];
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < MAX_REP / WARPS; ++i) {
            const int r = warp + i * WARPS;
            if (r >= rep) break;
            ws_ml[((hbase + r) * splits + sp) * 2 + 0] = m_run[i];
            ws_ml[((hbase + r) * splits + sp) * 2 + 1] = l_run[i];
        }
    }
}

// Merge the splits and normalise; append mode (kc != nullptr) seeds the
// merge with the current token's term (m = s_cur, l = 1, acc = v_cur),
// pool mode starts from (m = -inf, l = 0, acc = 0). A row with nothing to
// attend (pool mode, lengths[b] = 0: outside the serving contract) gets
// zeros. Grid (B, Hq), one thread per element of D.
__global__ void paged_combine_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ kc,
                               const __nv_bfloat16* __restrict__ vc,
                               const float* __restrict__ ws_acc,
                               const float* __restrict__ ws_ml,
                               __nv_bfloat16* __restrict__ out,
                               int Hq, int Hkv, int D, int splits,
                               float scale)
{
    const int b = blockIdx.x;
    const int h = blockIdx.y;
    const int d = threadIdx.x;
    const int g = h / (Hq / Hkv);
    const size_t qi = ((size_t)b * Hq + h) * D;
    const size_t ki = ((size_t)b * Hkv + g) * D;
    const size_t wb = ((size_t)b * Hq + h) * splits;
    float s = 0.f;
    float m = NEG;
    if (kc != nullptr) {
        for (int i = 0; i < D; ++i)
            s = fmaf(__bfloat162float(q[qi + i]),
                     __bfloat162float(kc[ki + i]), s);
        s *= scale;
        m = s;
    }
    for (int sp = 0; sp < splits; ++sp) m = fmaxf(m, ws_ml[(wb + sp) * 2]);
    float den = 0.f;
    float num = 0.f;
    if (kc != nullptr) {
        const float pc = expf(s - m);
        den = pc;
        num = pc * __bfloat162float(vc[ki + d]);
    }
    for (int sp = 0; sp < splits; ++sp) {
        const float f = expf(ws_ml[(wb + sp) * 2] - m);
        den += ws_ml[(wb + sp) * 2 + 1] * f;
        num += ws_acc[(wb + sp) * D + d] * f;
    }
    out[qi + d] = __float2bfloat16(den > 0.f ? num / den : 0.f);
}

template <typename T, int D>
void launch_split(dim3 grid, cudaStream_t st, const void* q, const void* kp,
                  const void* vp, const void* ks, const void* vs,
                  const void* pt, int pt_stride, const void* lengths,
                  void* ws_acc, void* ws_ml, int layer, int N, int ps,
                  int ps_pad, int Hkv, int rep, int pages, int split_tokens,
                  float scale)
{
    paged_split_kernel<T, D><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt), pt_stride,
        static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), layer, N, ps, ps_pad, Hkv, rep, pages,
        split_tokens, scale);
}

// Both modes: the split kernel over the pool, then the combine (kc/vc
// null in pool mode).
int launch(const void* q, const void* kc, const void* vc, const void* kp,
           const void* vp, const void* ks, const void* vs, const void* pt,
           int pt_stride, const void* lengths, void* ws_acc, void* ws_ml,
           void* out, int B, int Hq, int Hkv, int D, int N, int ps,
           int ps_pad, int layer, int pages, int splits, int split_tokens,
           int quantized, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int rep = Hkv > 0 ? Hq / Hkv : 0;
    if (rep < 1 || rep > MAX_REP || rep * Hkv != Hq || split_tokens % TILE
            || (D != 32 && D != 64 && D != 128))
        return (int)cudaErrorInvalidValue;
    const float scale = 1.f / sqrtf((float)D);
    dim3 grid(B, Hkv, splits);
#define PA_ARGS grid, st, q, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc, \
    ws_ml, layer, N, ps, ps_pad, Hkv, rep, pages, split_tokens, scale
    if (quantized) {
        if (D == 32) launch_split<int8_t, 32>(PA_ARGS);
        else if (D == 64) launch_split<int8_t, 64>(PA_ARGS);
        else launch_split<int8_t, 128>(PA_ARGS);
    } else {
        if (D == 32) launch_split<__nv_bfloat16, 32>(PA_ARGS);
        else if (D == 64) launch_split<__nv_bfloat16, 64>(PA_ARGS);
        else launch_split<__nv_bfloat16, 128>(PA_ARGS);
    }
#undef PA_ARGS
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    paged_combine_kernel<<<dim3(B, Hq), D, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kc),
        static_cast<const __nv_bfloat16*>(vc),
        static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
        static_cast<__nv_bfloat16*>(out), Hq, Hkv, D, splits, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Append mode. q [B,Hq,D] bf16; kc/vc [B,Hkv,D] bf16; kp/vp
// [L,N,ps,Hkv,D] int8 (quantized != 0, with ks/vs [L,N,Hkv,ps_pad] f32)
// or bf16 (ks/vs null); pt [B,pt_stride] int32; lengths [B] int32 tokens
// in the pool, the current one not counted; ws_acc [B,Hq,splits,D] f32;
// ws_ml [B,Hq,splits,2] f32; out [B,Hq,D] bf16.
int paged_append_launch(const void* q, const void* kc, const void* vc,
                        const void* kp, const void* vp, const void* ks,
                        const void* vs, const void* pt, int pt_stride,
                        const void* lengths, void* ws_acc, void* ws_ml,
                        void* out, int B, int Hq, int Hkv, int D, int N,
                        int ps, int ps_pad, int layer, int pages,
                        int splits, int split_tokens, int quantized,
                        void* stream)
{
    if (kc == nullptr || vc == nullptr) return (int)cudaErrorInvalidValue;
    return launch(q, kc, vc, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc,
                  ws_ml, out, B, Hq, Hkv, D, N, ps, ps_pad, layer, pages,
                  splits, split_tokens, quantized, stream);
}

// Pool mode: the append mode's operands without kc/vc; lengths [B] counts
// the slot this step wrote.
int paged_pool_launch(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* pt,
                      int pt_stride, const void* lengths, void* ws_acc,
                      void* ws_ml, void* out, int B, int Hq, int Hkv, int D,
                      int N, int ps, int ps_pad, int layer, int pages,
                      int splits, int split_tokens, int quantized,
                      void* stream)
{
    return launch(q, nullptr, nullptr, kp, vp, ks, vs, pt, pt_stride,
                  lengths, ws_acc, ws_ml, out, B, Hq, Hkv, D, N, ps, ps_pad,
                  layer, pages, splits, split_tokens, quantized, stream);
}

const char* paged_append_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
