// Kernel D: causal GQA prefill attention with a query offset, for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces p2p_llm_chat_tpu/models/layers.py:226 attend_gqa_causal0, which
// is the Pallas library's TPU `flash_attention` reached through
// pl.pallas_call, and on this card also the reference's XLA paths around it
// (attend_gqa / flash_attend_gqa behind attend_gqa_auto): one kernel serves
// every prefill attention -- the whole prompt from position 0, a chunk of a
// chunked prefill at its offset, and a prefix-spliced suffix.
//
//   out[r, i, h] = softmax_j(q[r, i, h] . k[r, j, h / rep] / sqrt(D)) v[r, j]
//   over j <= q_offset + i and j < Skv
//
// q [R, Sq, Hq, D], k/v [R, Skv, Hkv, D], out [R, Sq, Hq, D], all bf16;
// D in {32, 64, 128}, rep = Hq / Hkv in 1..8. Scores, the running max and
// sum in f32; probabilities rounded to bf16 for the p.v product (the
// reference's contract: probs.astype(v.dtype) before the p.v einsum).
//
// Bound on an H100 SXM: operations. A whole prompt of S tokens needs
// 4 R Hq D S(S+1)/2 FLOPs (two products over the causal triangle), a chunk
// of C tokens at offset o needs 4 R Hq D (C o + C(C+1)/2); llama3.1-8b at
// S = 2048, R = 1 is ~34 GFLOP per layer, ~35 us at 989 TFLOP/s, against
// 8 MB of q/k/v/out (~2.5 us at 3.35 TB/s).
//
// Design (simple first; wgmma and TMA are later work):
// - grid (q tiles, Hkv, R); a block owns one q tile of one kv-head group,
//   so the group's `rep` query heads share every k/v tile it loads. Each
//   warp owns 16 query rows of one head (QW warps per head, QW = 4 / rep
//   rounded down, at least 1; a q tile is 16 QW positions). Heavier tiles
//   (later positions) are launched first.
// - the block walks k/v in fixed 64-position tiles at absolute offsets from
//   position 0, with an online softmax per row; it stops at the tile that
//   holds its last query position, so tiles wholly past it are never
//   loaded (the causal triangle's upper half costs nothing).
// - tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate): q
//   fragments stay in registers for the whole walk; k tiles are read as
//   B fragments straight from row-major shared memory, v tiles are stored
//   transposed so their B fragments are 32-bit loads too; the f32 score
//   fragments become the p.v A fragments in registers (no shared memory
//   round trip for the probabilities).
//
// Two properties callers rely on (chunked prefill and the prefix path):
// - Rows do not depend on chunking. A row's result depends only on its
//   absolute position and the k/v it can see: kv tiles sit at absolute
//   offsets, each output element is its own dot product, reductions over a
//   tile's columns run in a fixed per-column order, and a tile wholly
//   masked for a row leaves its (m, l, acc) exactly unchanged (the tile's
//   max is -inf, so alpha = exp2(0) = 1 and every p = exp2(-inf) = 0). So a
//   chunk call at offset o gives bitwise the rows of the whole-prompt call.
// - Garbage is never multiplied. Kv positions past the block's last query
//   position, or at j >= Skv, are never loaded: their shared-memory slots
//   are zero-filled. A chunk carry holds unwritten slots there (possibly
//   NaN), and 0 * NaN would poison the p.v sum (kernel B's rule). Inside a
//   loaded tile, positions past one row's limit were written by this call
//   or an earlier one, so there a masked p = 0 is safe.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BKV = 64;          // kv positions per tile
constexpr int MAX_WARPS = 8;
constexpr int MAX_REP = 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi)
{
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x = lo (low bits)
    return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v)
{
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v)
{
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// mma.sync m16n8k16 fragment layout (lane = 4 gid + tig):
//   A (16x16, row): a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid, 2tig+8..),
//                   a3 (gid+8, 2tig+8..)
//   B (16x8, col):  b0 (k 2tig..+1, n gid), b1 (k 2tig+8..+1, n gid)
//   C (16x8):       c0,c1 (gid, 2tig..+1), c2,c3 (gid+8, 2tig..+1)
template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS)
prefill_attn_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                    int Hq, int Hkv, int rep, int QW, int q_offset,
                    float scale_log2)
{
    constexpr int KS = D + 8;        // k row stride (halves): conflict-free
    constexpr int VS = BKV + 8;      // transposed-v row stride (halves)
    constexpr int NT = BKV / 8;      // score n-tiles per kv tile
    constexpr int KD = D / 16;       // k-steps of q . k
    constexpr int ND = D / 8;        // output n-tiles
    // bf16 bit patterns (uint16) in shared memory.
    __shared__ __align__(16) uint16_t k_s[BKV * KS];
    __shared__ __align__(16) uint16_t vt_s[D * VS];

    const int BQ = 16 * QW;
    const int nqt = (Sq + BQ - 1) / BQ;
    const int qt = nqt - 1 - (int)blockIdx.x;         // heavy tiles first
    const int g = blockIdx.y;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int h = g * rep + warp / QW;
    const int p0 = qt * BQ + (warp % QW) * 16;        // warp's first row

    const int q0 = qt * BQ;
    const int last_local = min(q0 + BQ, Sq) - 1;
    const int kv_end = min(q_offset + last_local + 1, Skv);
    const int ntiles = (kv_end + BKV - 1) / BKV;

    // q fragments for the whole walk (rows past Sq read as 0).
    uint32_t qa[KD][4];
    {
        const int r0 = p0 + gid, r1 = r0 + 8;
        const uint32_t* q0p = reinterpret_cast<const uint32_t*>(
            q + (((size_t)b * Sq + r0) * Hq + h) * D);
        const uint32_t* q1p = reinterpret_cast<const uint32_t*>(
            q + (((size_t)b * Sq + r1) * Hq + h) * D);
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
            const int c = (ks * 16 + 2 * tig) / 2;
            qa[ks][0] = r0 < Sq ? q0p[c] : 0u;
            qa[ks][1] = r1 < Sq ? q1p[c] : 0u;
            qa[ks][2] = r0 < Sq ? q0p[c + 4] : 0u;
            qa[ks][3] = r1 < Sq ? q1p[c + 4] : 0u;
        }
    }
    const int qpos0 = q_offset + p0 + gid;            // absolute positions
    const int qpos1 = qpos0 + 8;

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
        o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

    const size_t kv_row = (size_t)Hkv * D;            // elements per position
    const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_row + (size_t)g * D;
    const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_row + (size_t)g * D;

    for (int t = 0; t < ntiles; ++t) {
        const int j0 = t * BKV;
        __syncthreads();             // the previous tile's reads are done
        // k: row-major, neighbouring threads on neighbouring 16-byte chunks.
        for (int c = tid; c < BKV * (D / 8); c += nthreads) {
            const int row = c / (D / 8), d0 = (c % (D / 8)) * 8;
            const int j = j0 + row;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (j < kv_end)
                val = *reinterpret_cast<const uint4*>(kb + j * kv_row + d0);
            *reinterpret_cast<uint4*>(&k_s[row * KS + d0]) = val;
        }
        // v: transposed into vt_s[d][position]; neighbouring threads on
        // neighbouring positions so the 16-bit stores do not collide.
        for (int c = tid; c < BKV * (D / 8); c += nthreads) {
            const int row = c % BKV, d0 = (c / BKV) * 8;
            const int j = j0 + row;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (j < kv_end)
                val = *reinterpret_cast<const uint4*>(vb + j * kv_row + d0);
            const uint16_t* e = reinterpret_cast<const uint16_t*>(&val);
#pragma unroll
            for (int i = 0; i < 8; ++i) vt_s[(d0 + i) * VS + row] = e[i];
        }
        __syncthreads();

        // s = q . k^T over the tile: 16 rows x 64 positions per warp.
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            const uint16_t* kr = &k_s[(nt * 8 + gid) * KS + 2 * tig];
#pragma unroll
            for (int ks = 0; ks < KD; ++ks) {
                const uint32_t b0 =
                    *reinterpret_cast<const uint32_t*>(kr + ks * 16);
                const uint32_t b1 =
                    *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
                mma_bf16(s[nt], qa[ks], b0, b1);
            }
        }
        // Scale into log2 units and mask; row max over the tile.
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = j0 + nt * 8 + 2 * tig + (c & 1);
                const int lim = c < 2 ? qpos0 : qpos1;
                const bool vis = j <= lim && j < kv_end;
                s[nt][c] = vis ? s[nt][c] * scale_log2 : -INFINITY;
            }
            mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        // A row with nothing visible yet keeps m = -inf; shift by 0 then
        // (every p is 0 and alpha multiplies zeros).
        const float sh0 = mn0 == -INFINITY ? 0.f : mn0;
        const float sh1 = mn1 == -INFINITY ? 0.f : mn1;
        const float al0 = m0 == -INFINITY ? 0.f : exp2f(m0 - mn0);
        const float al1 = m1 == -INFINITY ? 0.f : exp2f(m1 - mn1);
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            s[nt][0] = exp2f(s[nt][0] - sh0);
            s[nt][1] = exp2f(s[nt][1] - sh0);
            s[nt][2] = exp2f(s[nt][2] - sh1);
            s[nt][3] = exp2f(s[nt][3] - sh1);
            sum0 += s[nt][0] + s[nt][1];
            sum1 += s[nt][2] + s[nt][3];
        }
        l0 = l0 * al0 + quad_sum(sum0);
        l1 = l1 * al1 + quad_sum(sum1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
            o[dn][0] *= al0;
            o[dn][1] *= al0;
            o[dn][2] *= al1;
            o[dn][3] *= al1;
        }
        // o += p . v: the score fragments of n-tiles 2kk, 2kk+1 are the A
        // fragment of k-step kk.
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
            for (int dn = 0; dn < ND; ++dn) {
                const uint16_t* vr =
                    &vt_s[(dn * 8 + gid) * VS + kk * 16 + 2 * tig];
                const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vr);
                const uint32_t b1 =
                    *reinterpret_cast<const uint32_t*>(vr + 8);
                mma_bf16(o[dn], pa, b0, b1);
            }
        }
    }

    const int r0 = p0 + gid, r1 = r0 + 8;
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
        const int d = dn * 8 + 2 * tig;
        if (r0 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (((size_t)b * Sq + r0) * Hq + h) * D + d) =
                __floats2bfloat162_rn(o[dn][0] * inv0, o[dn][1] * inv0);
        if (r1 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(
                out + (((size_t)b * Sq + r1) * Hq + h) * D + d) =
                __floats2bfloat162_rn(o[dn][2] * inv1, o[dn][3] * inv1);
    }
}

template <int D>
void launch(dim3 grid, int threads, cudaStream_t st, const void* q,
            const void* k, const void* v, void* out, int Sq, int Skv, int Hq,
            int Hkv, int rep, int QW, int q_offset, float scale_log2)
{
    prefill_attn_kernel<D><<<grid, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, Hkv, rep, QW,
        q_offset, scale_log2);
}

}  // namespace

extern "C" {

// q [R,Sq,Hq,D] bf16; k/v [R,Skv,Hkv,D] bf16; out [R,Sq,Hq,D] bf16; all
// contiguous. Query i sits at absolute position q_offset + i.
int prefill_attention_launch(const void* q, const void* k, const void* v,
                             void* out, int R, int Sq, int Skv, int Hq,
                             int Hkv, int D, int q_offset, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int rep = Hkv > 0 ? Hq / Hkv : 0;
    if (rep < 1 || rep > MAX_REP || rep * Hkv != Hq || R < 1 || Sq < 1
        || Skv < 1 || q_offset < 0)
        return (int)cudaErrorInvalidValue;
    const int QW = rep >= 4 ? 1 : 4 / rep;
    const int BQ = 16 * QW;
    const dim3 grid((Sq + BQ - 1) / BQ, Hkv, R);
    const int threads = 32 * rep * QW;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
#define PF_ARGS grid, threads, st, q, k, v, out, Sq, Skv, Hq, Hkv, rep, QW, \
    q_offset, scale_log2
    if (D == 32) launch<32>(PF_ARGS);
    else if (D == 64) launch<64>(PF_ARGS);
    else if (D == 128) launch<128>(PF_ARGS);
    else return (int)cudaErrorInvalidValue;
#undef PF_ARGS
    return (int)cudaGetLastError();
}

const char* prefill_attention_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
