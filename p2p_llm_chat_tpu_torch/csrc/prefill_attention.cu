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
// 8 MB of q/k/v/out (~2.5 us at 3.35 TB/s). The design keeps the tensor
// cores fed: k/v tiles are shared by every head of a group and many query
// rows, their copies run ahead of the products, and every operand reaches
// the tensor cores by ldmatrix or straight from registers.
//
// Design (FlashAttention-2 on mma.sync m16n8k16, bf16 in, f32 accumulate;
// wgmma, TMA and warp specialisation are later work):
// - GQA-packed q tiles, chosen per call. Grid (Hkv * R, q tiles): a block
//   owns BQ = 16 QW query positions of all `rep` heads of one kv-head
//   group, on rep * QW warps of 16 consecutive positions of one head, so
//   16 rep QW rows share every k/v tile it loads. QW is the largest power
//   of two with rep QW <= 8 whose grid still puts a block on every SM,
//   else 1 (q_tile_warps): a 2048-token llama prompt runs 128-row blocks,
//   a 256-row chunk 64-row blocks (128 blocks for 132 SMs). The heaviest q
//   tiles (the latest positions) sit on the lowest blockIdx.y and launch
//   first.
// - An asynchronous k/v ring: STAGES slots of [64, D] k and v tiles in
//   dynamic shared memory (rows padded by 16 bytes so ldmatrix's eight
//   rows fall in distinct banks), filled by 16-byte cp.async.cg copies
//   issued STAGES - 1 tiles ahead of the tile being multiplied and spread
//   over the k-steps of its q . k product, one barrier per tile. The q
//   rows arrive the same way, once.
// - Operands by ldmatrix: q A fragments (ldmatrix.x4, kept in registers
//   for the whole walk), k B fragments (ldmatrix.x4 on row-major k), v B
//   fragments (ldmatrix.x4.trans on row-major v: no transposition pass),
//   each k-step's B fragments loaded while the previous k-step's products
//   run. The f32 score fragments become the p.v A fragments in registers.
// - The block walks kv tiles at absolute offsets of 64 from position 0 up
//   to the tile holding its last query position (the causal triangle's
//   upper half is never loaded). A warp skips a tile wholly past its rows
//   and masks only a tile that crosses its diagonal or kv_end.
//
// The log-sum-exp (a ring hop's softmax statistics, parallel/ring.py):
// with a non-null `lse` the epilogue also writes, per query row,
//   lse[r, h, i] = log sum_j exp(q[r, i, h] . k[r, j, h / rep] / sqrt(D))
// over the same visible j (natural log, f32, [R, Hq, Sq]) from the row's
// running max and sum, (m + log2 l) ln 2 in the walk's log2 units. A null
// pointer (every other caller) writes nothing else and leaves the
// output's arithmetic as it is.
//
// Two properties callers rely on (chunked prefill and the prefix path):
// - Rows do not depend on the call. A row's result depends only on its
//   absolute position and the k/v it can see: kv tiles sit at absolute
//   offsets, each output element is its own dot product, reductions over a
//   tile's columns run in a fixed per-column order, and a tile wholly
//   masked for a row leaves its (m, l, acc) exactly unchanged (the tile's
//   max is -inf, so alpha = exp2(0) = 1 and every p = exp2(-inf) = 0), the
//   same as a tile its warp skips. Nothing in a row's order depends on Sq,
//   q_offset, R or the q tile, so a chunk call at offset o gives bitwise
//   the rows of the whole-prompt call (tests/test_torch_kernel_d_plan.py
//   emulates the order; chip_smoke.py checks the bits on the card).
// - Garbage is never multiplied. Kv positions past the block's last query
//   position, or at j >= Skv, are never read: cp.async's source size is 0
//   there and the slot is zero-filled. A chunk carry holds unwritten slots
//   there (possibly NaN), and 0 * NaN would poison the p.v sum (kernel B's
//   rule). Inside a loaded tile, positions past one row's limit were
//   written by this call or an earlier one, so there a masked p = 0 is
//   safe.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int BKV = 64;          // kv positions per tile
constexpr int STAGES = 4;        // k/v tiles in the ring
constexpr int MAX_WARPS = 8;
constexpr int MAX_REP = 8;
constexpr int MAX_DEVICES = 64;

// Dynamic shared memory of a block of `nw` warps: its q rows, then the
// ring (per stage a k tile, then a v tile), every row padded to D + 8.
template <int D>
constexpr int smem_bytes(int nw)
{
    return (16 * nw + 2 * STAGES * BKV) * (D + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy: `bytes` (0 or 16) from src, the rest of the
// 16 zero-filled. src must be 16-byte aligned (and valid even when bytes
// is 0; then nothing is read from it).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p)
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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
// ldmatrix.x4: lanes 8i..8i+7 address the eight 16-byte rows of matrix i,
// and register i of lane (4 gid + tig) holds row gid, elements 2tig..+1
// of matrix i (.trans: elements [2tig..+1][gid] of the stored matrix).
template <int D>
__global__ void __launch_bounds__(32 * MAX_WARPS)
prefill_attn_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Skv, int Hq,
                    int Hkv, int rep, int QW, int q_offset,
                    float scale_log2)
{
    constexpr int RS = D + 8;        // shared row stride (halves)
    constexpr int CH = D / 8;        // 16-byte chunks per row
    constexpr int NT = BKV / 8;      // score n-tiles per kv tile
    constexpr int KD = D / 16;       // k-steps of q . k
    constexpr int ND = D / 8;        // output n-tiles
    constexpr int TILE = BKV * RS;   // halves per k or v tile
    // bf16 bit patterns (uint16) in shared memory.
    extern __shared__ __align__(16) uint16_t smem[];
    const int nw = blockDim.x >> 5;
    uint16_t* const q_s = smem;                    // [16 nw][RS]
    uint16_t* const ring = smem + 16 * nw * RS;    // STAGES x (k, v) tiles

    const int BQ = 16 * QW;
    const int qt = gridDim.y - 1 - (int)blockIdx.y;   // heavy tiles first
    const int g = blockIdx.x % Hkv;
    const int b = blockIdx.x / Hkv;
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
    // The warp's last absolute position (-1: it holds no row of the call).
    const int warp_last = p0 < Sq ? q_offset + min(p0 + 15, Sq - 1) : -1;

    // q rows of every warp (rows past Sq zero-filled), one group.
    for (int c = tid; c < 16 * nw * CH; c += nthreads) {
        const int row = c / CH, ch = c % CH;
        const int w = row >> 4;
        const int p = q0 + (w % QW) * 16 + (row & 15);
        const bool ok = p < Sq;
        const __nv_bfloat16* src =
            ok ? q + (((size_t)b * Sq + p) * Hq + g * rep + w / QW) * D
                     + ch * 8
               : q;
        cp_async16(q_s + row * RS + ch * 8, src, ok ? 16 : 0);
    }
    cp_async_commit();

    const size_t kv_row = (size_t)Hkv * D;            // elements per position
    const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_row + (size_t)g * D;
    const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_row + (size_t)g * D;
    // Part `part` of `parts` of tile t into its ring slot (the parts
    // split each thread's copies); slots at j >= kv_end are zero-filled
    // and never read.
    auto load_tile = [&](int t, int part, int parts) {
        uint16_t* ks = ring + (t % STAGES) * 2 * TILE;
        uint16_t* vs = ks + TILE;
        for (int c = tid + part * nthreads; c < BKV * CH;
             c += parts * nthreads) {
            const int row = c / CH, ch = c % CH;
            const int j = t * BKV + row;
            const bool ok = j < kv_end;
            const size_t off = ok ? (size_t)j * kv_row + ch * 8 : 0;
            cp_async16(ks + row * RS + ch * 8, kb + off, ok ? 16 : 0);
            cp_async16(vs + row * RS + ch * 8, vb + off, ok ? 16 : 0);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ntiles) load_tile(s, 0, 1);
        cp_async_commit();           // one group per tile, empty or not
    }

    cp_async_wait<STAGES - 1>();     // the q group has landed
    __syncthreads();
    uint32_t qa[KD][4];
    {
        const uint16_t* qr =
            q_s + (warp * 16 + (lane & 15)) * RS + 8 * (lane >> 4);
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) ldmatrix_x4(qa[ks], qr + ks * 16);
    }
    const int qpos0 = q_offset + p0 + gid;            // absolute positions
    const int qpos1 = qpos0 + 8;
    const int lim0 = min(qpos0, kv_end - 1);          // last visible j
    const int lim1 = min(qpos1, kv_end - 1);

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[ND][4];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
        o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

    // A lane's ldmatrix.x4 row within a tile (halves): the B fragments
    // (b0, b1) of two n-tiles at one k-step. k rows are n: matrix i is
    // n-tile i / 2, k-half i % 2; v rows are k (.trans): matrix i is
    // k-half i % 2, n-tile i / 2.
    const int k_lane = ((lane & 7) + 8 * (lane >> 4)) * RS
                       + 8 * ((lane >> 3) & 1);
    const int v_lane = ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS
                       + 8 * (lane >> 4);

    for (int t = 0; t < ntiles; ++t) {
        cp_async_wait<STAGES - 2>();   // tile t has landed (this thread's)
        __syncthreads();               // ... everyone's; slot t-1 is free
        // Tile t + STAGES - 1 is copied in KD parts, one beside each
        // k-step of the q . k product, so that no burst of copies holds
        // the warp back from its products.
        const int tn = t + STAGES - 1 < ntiles ? t + STAGES - 1 : -1;
        const int j0 = t * BKV;
        if (j0 > warp_last) {          // wholly past this warp's rows
            if (tn >= 0) load_tile(tn, 0, 1);
            cp_async_commit();
            continue;
        }
        const uint16_t* kt = ring + (t % STAGES) * 2 * TILE;
        const uint16_t* vt = kt + TILE;

        // s = q . k^T over the tile: 16 rows x 64 positions per warp. The
        // B fragments of a k-step are loaded while the previous k-step's
        // products run (two buffers), so ldmatrix latency stays hidden.
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        uint32_t bk[2][NT / 2][4];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np)
            ldmatrix_x4(bk[0][np], kt + np * 16 * RS + k_lane);
#pragma unroll
        for (int ks = 0; ks < KD; ++ks) {
            if (tn >= 0) load_tile(tn, ks, KD);
            if (ks + 1 < KD) {
#pragma unroll
                for (int np = 0; np < NT / 2; ++np)
                    ldmatrix_x4(bk[(ks + 1) & 1][np],
                                kt + np * 16 * RS + (ks + 1) * 16 + k_lane);
            }
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                const uint32_t (&f)[4] = bk[ks & 1][np];
                mma_bf16(s[2 * np], qa[ks], f[0], f[1]);
                mma_bf16(s[2 * np + 1], qa[ks], f[2], f[3]);
            }
        }
        cp_async_commit();
        // Scale into log2 units and mask (only a tile that crosses the
        // warp's diagonal or kv_end has masked entries); row max.
        const bool masked = j0 + BKV - 1 > q_offset + p0
                            || j0 + BKV > kv_end;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = j0 + nt * 8 + 2 * tig + (c & 1);
                const bool vis = !masked || j <= (c < 2 ? lim0 : lim1);
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
        // fragment of k-step kk; v's B fragments are double-buffered as
        // k's.
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
        uint32_t bv[2][ND / 2][4];
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp)
            ldmatrix_x4_trans(bv[0][dp], vt + dp * 16 + v_lane);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
            if (kk + 1 < BKV / 16) {
#pragma unroll
                for (int dp = 0; dp < ND / 2; ++dp)
                    ldmatrix_x4_trans(bv[(kk + 1) & 1][dp],
                                      vt + (kk + 1) * 16 * RS + dp * 16
                                      + v_lane);
            }
#pragma unroll
            for (int dp = 0; dp < ND / 2; ++dp) {
                const uint32_t (&f)[4] = bv[kk & 1][dp];
                mma_bf16(o[2 * dp], pa[kk], f[0], f[1]);
                mma_bf16(o[2 * dp + 1], pa[kk], f[2], f[3]);
            }
        }
    }

    const int r0 = p0 + gid, r1 = r0 + 8;
    if (lse != nullptr && tig == 0) {  // the quad's lanes hold one m, l
        constexpr float LN2 = 0.6931471805599453f;
        float* const lr = lse + ((size_t)b * Hq + h) * Sq;
        if (r0 < Sq) lr[r0] = (m0 + log2f(l0)) * LN2;
        if (r1 < Sq) lr[r1] = (m1 + log2f(l1)) * LN2;
    }
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

int sm_count()
{
    static int sms[MAX_DEVICES] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
        return 0;
    if (sms[dev] == 0
            && cudaDeviceGetAttribute(&sms[dev],
                                      cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
        return 0;
    return sms[dev];
}

// Warps per head of a call's q tile (BQ = 16 QW positions): the largest
// power of two with rep QW <= MAX_WARPS whose grid has at least one block
// per SM, else 1. It never changes a row's arithmetic.
int q_tile_warps(int R, int Sq, int Hkv, int rep, int sms)
{
    int qw = 1;
    while (2 * qw * rep <= MAX_WARPS) qw *= 2;
    for (; qw > 1; qw /= 2) {
        const long long tiles = (Sq + 16LL * qw - 1) / (16LL * qw);
        if (tiles * Hkv * R >= sms) break;
    }
    return qw;
}

template <int D>
cudaError_t launch(dim3 grid, int nw, cudaStream_t st, const void* q,
                   const void* k, const void* v, void* out, void* lse,
                   int Sq, int Skv, int Hq, int Hkv, int rep, int QW,
                   int q_offset, float scale_log2)
{
    // Above 48 KB a launch needs the opt-in, once per device, at the
    // largest block's size.
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(prefill_attn_kernel<D>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes<D>(MAX_WARPS));
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    prefill_attn_kernel<D><<<grid, 32 * nw, smem_bytes<D>(nw), st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq,
        Skv, Hq, Hkv, rep, QW, q_offset, scale_log2);
    return cudaGetLastError();
}

bool geometry_ok(int R, int Sq, int Skv, int Hq, int Hkv, int D,
                 int q_offset)
{
    const int rep = Hkv > 0 ? Hq / Hkv : 0;
    return rep >= 1 && rep <= MAX_REP && rep * Hkv == Hq && R >= 1
           && Sq >= 1 && Skv >= 1 && q_offset >= 0
           && (D == 32 || D == 64 || D == 128)
           && (long long)Hkv * R <= 0x7fffffffLL && Sq <= 16 * 65535;
}

// Check the geometry, plan the q tile and launch (lse may be null).
int run(const void* q, const void* k, const void* v, void* out, void* lse,
        int R, int Sq, int Skv, int Hq, int Hkv, int D, int q_offset,
        void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (!geometry_ok(R, Sq, Skv, Hq, Hkv, D, q_offset))
        return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    const int rep = Hq / Hkv;
    const int QW = q_tile_warps(R, Sq, Hkv, rep, sms);
    const int BQ = 16 * QW;
    const dim3 grid(Hkv * R, (Sq + BQ - 1) / BQ);
    const int nw = rep * QW;
    const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
#define PF_ARGS grid, nw, st, q, k, v, out, lse, Sq, Skv, Hq, Hkv, rep, \
    QW, q_offset, scale_log2
    if (D == 32) return (int)launch<32>(PF_ARGS);
    if (D == 64) return (int)launch<64>(PF_ARGS);
    return (int)launch<128>(PF_ARGS);
#undef PF_ARGS
}

}  // namespace

extern "C" {

// q [R,Sq,Hq,D] bf16; k/v [R,Skv,Hkv,D] bf16; out [R,Sq,Hq,D] bf16; all
// contiguous. Query i sits at absolute position q_offset + i.
int prefill_attention_launch(const void* q, const void* k, const void* v,
                             void* out, int R, int Sq, int Skv, int Hq,
                             int Hkv, int D, int q_offset, void* stream)
{
    return run(q, k, v, out, nullptr, R, Sq, Skv, Hq, Hkv, D, q_offset,
               stream);
}

// The same call that also writes lse [R,Hq,Sq] f32, each query row's
// natural-log log-sum-exp of its scaled, masked scores.
int prefill_attention_launch_lse(const void* q, const void* k,
                                 const void* v, void* out, void* lse, int R,
                                 int Sq, int Skv, int Hq, int Hkv, int D,
                                 int q_offset, void* stream)
{
    if (lse == nullptr) return (int)cudaErrorInvalidValue;
    return run(q, k, v, out, lse, R, Sq, Skv, Hq, Hkv, D, q_offset, stream);
}

// The q tile a launch of this geometry runs on the current device:
// *qw = warps per head (the tile is 16 qw positions of every head of a
// group, rep qw warps) and *smem = the block's dynamic shared memory.
int prefill_attention_plan(int R, int Sq, int Hq, int Hkv, int D, int* qw,
                           int* smem)
{
    if (!geometry_ok(R, Sq, 1, Hq, Hkv, D, 0))
        return (int)cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms < 1) return (int)cudaErrorInvalidDevice;
    const int rep = Hq / Hkv;
    *qw = q_tile_warps(R, Sq, Hkv, rep, sms);
    const int nw = rep * *qw;
    *smem = D == 32 ? smem_bytes<32>(nw)
          : D == 64 ? smem_bytes<64>(nw) : smem_bytes<128>(nw);
    return 0;
}

const char* prefill_attention_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
