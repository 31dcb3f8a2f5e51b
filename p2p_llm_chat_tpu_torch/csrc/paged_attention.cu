// Kernel B: paged decode attention for Hopper (sm_90a), plain C
// interface for ctypes. Three modes over one split kernel and two
// combines.
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
// Verify mode (paged_verify_launch) computes what the reference's
// paged_attention_verify_append (ops/paged_attention.py:635-690, XLA, no
// Pallas) computes for speculative decoding: S candidate positions per row
// attend the pool window (the same positions t < lengths[b] for every j)
// plus the block's own k/v, which is not in the pool, at full precision:
//   s_t = (q_j . k_t) / sqrt(D) * sk_t                  for t < lengths[b]
//   s_i = (q_j . kb_i) / sqrt(D)     where mask[b, j, i] (default i <= j)
//   out_j = (sum_t e^{s_t-m} sv_t v_t + sum_i e^{s_i-m} vb_i)
//         / (sum_t e^{s_t-m} + sum_i e^{s_i-m})
// It runs the same split kernel over the pool with the S x rep query rows
// of a kv group packed into full 16-row A tiles (one block per 16 rows,
// ROWS = 16; the decode modes keep 8-row tiles with rows 8..15 zero), and
// its own combine, which seeds each row with the block's S masked scores.
// The pool window is read once per 16 query rows (twice at S = 8, rep =
// 4: the second read mostly from L2).
//
// In every mode positions >= lengths[b] are never loaded and never
// multiplied by 0: a garbage page may hold NaN or Inf.
//
// Bound on an H100 SXM: the pool read. At B = 8, W = 1024, Hkv = 8,
// D = 128 an int8 layer reads 16.8 MB of k/v + 0.5 MB of scales -> 5.2 us
// at 3.35 TB/s, a bf16 layer 33.6 MB -> 10.1 us. The products are 4 FLOPs
// per k/v element and query head, ~0.27 GFLOP a layer: nothing on tensor
// cores, but ~150 M lane-operations on the CUDA cores, which would cap
// the kernel near its byte bound. So both products run on tensor cores,
// and the design's aim is to have the whole window in flight at once.
//
// Design (mma.sync m16n8k16 bf16 -> f32 with cp.async rings; TMA, wgmma
// and a persistent grid are later work):
// - Grid (slices, Hkv, B). A block owns one kv head of one row and one
//   slice of SLICE tokens at fixed absolute positions [sp SLICE,
//   (sp + 1) SLICE). A slice wholly past the row's length exits at once
//   and the combine reads only the live slices, so nothing of a row's
//   arithmetic depends on B, on the window's page count or on other rows:
//   a row's output is bitwise the same at B = 1 and B = 8, and at a window
//   of W or 2W.
// - The block's 4 warps deal the slice's chunks (32 tokens on int8 pools,
//   16 on bf16) in turn: warp w walks chunks w, w + 4, ... on its own ring
//   of STAGES slots in dynamic shared memory (its own cp.async groups and
//   __syncwarp, no block barrier in the walk). A slot holds the raw pool
//   bytes (int8 or bf16) of the chunk's k rows and v rows (rows padded by
//   16 bytes so ldmatrix's eight rows fall in distinct banks) and, on int8
//   pools, its k and v scales. The slice's page table entries are read
//   once into shared memory, beside the row's length; slots past the
//   length are zero-filled (cp.async src-size 0) and never read from the
//   pool. int8 pools have every chunk of the slice in flight before the
//   first wait (76.8 KB a block at D = 128, three blocks an SM); bf16
//   pools two chunks a warp, refilled as they are used (70.7 KB). Any
//   page size works (a chunk may straddle pages; one division a chunk).
// - GQA packed on tensor cores: the group's rep <= 8 query heads are rows
//   0..rep-1 of the 16-row A operand (rows 8..15 always zero, so only the
//   accumulators of rows 0..7 are kept), loaded once into registers.
//   q . k takes k's B fragments by ldmatrix (non-trans), p . v takes v's
//   by ldmatrix.trans. int8 tiles become exact bf16 in registers
//   (i8x4_to_bf16x4, no int->float instruction): over int8 viewed as b16
//   pairs, ldmatrix hands a lane 4 consecutive d of one token (q . k
//   permutes its contraction order inside each 16-wide k-step to match,
//   q's fragments likewise) and ldmatrix.trans hands it 2 d of 2 tokens
//   (one byte_perm makes the two B fragments of an even and an odd d
//   column; the output columns are mapped back at the end).
// - Online softmax on the score fragments with quad reductions, in log2
//   units; int8 k scales multiply the scores, int8 v scales the
//   probabilities of the numerator only, which are then rounded to bf16
//   and fed straight back as p . v's A fragments. The denominator sums
//   the unscaled f32 probabilities.
// - The block's warps merge their (m, l, acc) in warp order through
//   shared memory into an f32 workspace [B, Hq, slices, D] (+ m, l). A
//   second kernel merges the live slices in slice order, seeded in append
//   mode with the current token (m = s_cur, l = 1, acc = v_cur; s_cur
//   computed once per (b, h) with a warp reduction), normalises and
//   stores bf16. It is launched as a programmatic dependent of the split
//   kernel (its blocks are resident before the split ends and wait for
//   its completion). No atomics, no data-dependent order: reruns are
//   bitwise equal, and both launches are capturable in a CUDA graph (the
//   wrapper allocates the workspace).
//
// Measured (chip_smoke.py's kernel_b and kernel_b_pool phases, one
// 32-layer llama3.1-8b step at B = 8, W = 1024 replayed from a CUDA
// graph; NVIDIA H100 80GB HBM3, 700 W): append mode on an int8 pool
// 0.47-0.49 ms (bound 0.167), pool mode on a bf16 pool 0.55-0.58 ms
// (bound 0.322), against 1.5-1.7 ms for SDPA over a pre-gathered window;
// verify mode, one llama3.1-8b spec verify at B = 8, S = 8, W = 1024 on
// an int8 pool, 1.11 ms (bound 0.178) against 2.2 ms for SDPA over the
// pre-gathered window plus the block (chip_smoke.py's kernel_b_verify).
// Timed cut-downs of this source (PERF.md, kernel B) put an int8 layer at
// 4.4 us for the launches, the prologue and the combine alone; 10.8 us
// with the reads but not the walk's arithmetic (the 17.3 MB in ~6.4 us,
// 2.7 TB/s); 12.5 us with the arithmetic on zero-filled chunks but no
// reads; 15 us for the kernel. What bounds it now is the walk's
// arithmetic (int8 conversion, mma.sync, softmax at ~2 warps a
// scheduler) after the chunks land together, not the pool read. Slices
// of 128 tokens, 8 warps a block, 16-token int8 chunks and a plain
// combine launch were each slower.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int SLICE = 256;       // tokens per block (paged_slice_tokens)
constexpr int NW = 4;            // warps per block
constexpr int THREADS = 32 * NW;
constexpr int MAX_REP = 8;
constexpr int MAX_S = 64;           // verify mode's block positions per row
constexpr int MAX_DEVICES = 64;
constexpr float LOG2E = 1.4426950408889634f;

// Per pool type: the chunk, the ring depth, and a slot's bytes (k rows,
// v rows, then the chunk's k and v scales on int8 pools).
template <typename T, int D>
struct Ring {
    // Tokens per warp step: two k-steps of p . v on int8 pools (four
    // independent q . k chains), one on bf16 pools, whose twice larger
    // slots would leave one block an SM.
    static constexpr int CHUNK = sizeof(T) == 1 ? 32 : 16;
    static constexpr int RSB = D * (int)sizeof(T) + 16;   // row stride, bytes
    static constexpr int SCALES = sizeof(T) == 1 ? 2 * CHUNK * 4 : 0;
    static constexpr int SLOT = 2 * CHUNK * RSB + SCALES;
    // int8: a warp's whole share of the slice (2 chunks) in flight at
    // once, 76.8 KB a block at D = 128, three blocks an SM; bf16: two of
    // its 4 chunks (70.7 KB, three blocks an SM), refilled as they are
    // used.
    static constexpr int PER_WARP = SLICE / (CHUNK * NW);
    static constexpr int STAGES =
        sizeof(T) == 1 || PER_WARP < 2 ? PER_WARP : 2;
    static constexpr int SMEM = NW * STAGES * SLOT + SLICE * 4;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy: `bytes` (0 or 16) from src, the rest
// zero-filled; src must be valid and aligned even when bytes is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

// c0, c1 (row gid) += A . B over one m16n8k16 step; A's rows 8..15 are
// zero (a1 = a3 = 0), so the row gid + 8 results are dropped.
__device__ __forceinline__ void mma_top(float& c0, float& c1, uint32_t a0,
                                        uint32_t a2, uint32_t b0, uint32_t b1)
{
    float d2, d3;
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
        : "+f"(c0), "+f"(c1), "=f"(d2), "=f"(d3)
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f));
}

// c (rows gid, gid + 8) += A . B over one m16n8k16 step, every row live:
// c[0..1] row gid, c[2..3] row gid + 8; a[0], a[1] row gid (k 2tig.., k
// 2tig + 8..), a[2], a[3] row gid + 8.
__device__ __forceinline__ void mma_full(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[2]), "r"(a[1]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The walk's product for RH row halves a lane holds (RH = 1: rows 0..7
// of the A tile, rows 8..15 zero; RH = 2: all 16 rows).
template <int RH>
__device__ __forceinline__ void mma_rows(float (&c)[2 * RH],
                                         const uint32_t (&a)[2 * RH],
                                         uint32_t b0, uint32_t b1)
{
    if constexpr (RH == 1) {
        mma_top(c[0], c[1], a[0], a[1], b0, b1);
    } else {
        mma_full(c, a, b0, b1);
    }
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

// Four int8 (bytes 0..3 of w) to bf16, exactly: (byte 0, byte 1) in lo,
// (byte 2, byte 3) in hi, the lower byte in the lower half. Each byte
// + 128 is placed in the mantissa of 2^23 and 2^23 + 128 subtracted
// (quant_mm.cu's trick); the f32 result is an integer, exact in bf16.
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo,
                                               uint32_t& hi)
{
    const uint32_t u = w ^ 0x80808080u;
    const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)), 8388736.f);
    const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)), 8388736.f);
    const float f2 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)), 8388736.f);
    const float f3 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)), 8388736.f);
    lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// mma.sync m16n8k16 fragment layout (lane = 4 gid + tig):
//   A (16x16, row): a0 (gid, 2tig..+1), a1 (gid+8, 2tig..), a2 (gid, 2tig+8..),
//                   a3 (gid+8, 2tig+8..)
//   B (16x8, col):  b0 (k 2tig..+1, n gid), b1 (k 2tig+8..+1, n gid)
//   C (16x8):       c0,c1 (gid, 2tig..+1), c2,c3 (gid+8, 2tig..+1)
// ldmatrix.x4: lanes 8i..8i+7 address the eight 16-byte rows of matrix i,
// and register i of lane (4 gid + tig) holds row gid, b16 elements
// 2tig..+1 of matrix i (.trans: elements [2tig..+1][gid]).
//
// Where each operand element sits (a chunk's token t = 8 nt + column):
//   bf16 pools: k-step ks contracts d = 16 ks + k; output n-tile n,
//     column c is d = 8 n + c (kernel D's layout).
//   int8 pools: k-step ks's k indices (2tig, 2tig+1, 2tig+8, 2tig+9) are
//     d = 16 ks + 4tig + (0, 1, 2, 3); output n-tiles 2j and 2j+1,
//     column c, are d = 16 j + 2c and 16 j + 2c + 1.
template <typename T, int D, int ROWS>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kp, const T* __restrict__ vp,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ page_table, int pt_stride,
                   const int* __restrict__ lengths,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int layer, int N, int ps, int ps_pad, int Hkv, int rep,
                   int S, int pages, float scale_log2)
{
    using R = Ring<T, D>;
    constexpr int CHUNK = R::CHUNK;
    constexpr bool I8 = sizeof(T) == 1;
    constexpr int RSB = R::RSB;
    constexpr int STAGES = R::STAGES;
    constexpr int CPR = D * (int)sizeof(T) / 16;   // 16 B chunks per row
    constexpr int KD = D / 16;                     // k-steps of q . k
    constexpr int ND = D / 8;                      // output n-tiles
    constexpr int NT = CHUNK / 8;                  // score n-tiles
    constexpr int KS = CHUNK / 16;                 // k-steps of p . v
    constexpr int RH = ROWS / 8;                   // row halves a lane holds
    extern __shared__ __align__(16) unsigned char smem[];

    const int sp = blockIdx.x;
    const int groups = gridDim.y / Hkv;            // row groups of ROWS
    const int g = blockIdx.y / groups;
    const int rg = blockIdx.y % groups;
    const int b = blockIdx.z;
    const int splits = gridDim.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int Hq = Hkv * rep;
    // Tile row r is query row ROWS rg + r of the group's S x rep rows
    // (position j = row / rep, head g rep + row % rep); rows past S rep
    // are zero and never stored.
    const int rows = min(ROWS, S * rep - ROWS * rg);
    auto q_index = [&](int r) {                    // [B, S, Hq] index
        const int row = ROWS * rg + r;
        return ((size_t)b * S + row / rep) * Hq + (size_t)g * rep + row % rep;
    };

    // The slice's page table entries, once, read beside the row's length
    // (one round trip, not two).
    const int t_begin = sp * SLICE;
    int* const pt_s = reinterpret_cast<int*>(smem + NW * STAGES * R::SLOT);
    const int pfirst = t_begin / ps;
    const int npages = min((t_begin + SLICE - 1) / ps, pages - 1) - pfirst + 1;
    const int len = min(lengths[b], pages * ps);
    for (int i = tid; i < npages; i += THREADS)
        pt_s[i] = page_table[(size_t)b * pt_stride + pfirst + i];
    if (t_begin >= len) return;                    // never read: skipped
    const int t_end = min(len, t_begin + SLICE);
    __syncthreads();

    unsigned char* const ring = smem + warp * STAGES * R::SLOT;
    const size_t layer_pages = (size_t)layer * N;
    // This warp's chunks: c = warp + NW i at tokens [t_begin + CHUNK c,
    // + CHUNK); the live ones (start < len) form a prefix.
    const int first = t_begin + CHUNK * warp;
    const int nchunks = first < t_end
        ? (t_end - first + CHUNK * NW - 1) / (CHUNK * NW) : 0;

    auto issue = [&](int i) {
        unsigned char* slot = ring + (i % STAGES) * R::SLOT;
        const int pos0 = first + i * CHUNK * NW;
        // Token t's page (layer-offset) and slot: one division per chunk,
        // then a carry for each page boundary the chunk crosses.
        const int p0 = pos0 / ps - pfirst;
        const int s0 = pos0 % ps;
        auto locate = [&](int t, size_t& page, int& sl) {
            int pi = p0;
            sl = s0 + t;
            while (sl >= ps) {
                sl -= ps;
                ++pi;
            }
            page = layer_pages + pt_s[pi];
        };
        for (int e = lane; e < CHUNK * CPR; e += 32) {
            const int t = e / CPR, ch = e % CPR;
            const bool live = pos0 + t < len;
            size_t off = ch * 16;
            if (live) {
                size_t page;
                int sl;
                locate(t, page, sl);
                off += ((page * ps + sl) * Hkv + g) * D * sizeof(T);
            }
            const int n = live ? 16 : 0;
            cp_async16(slot + t * RSB + ch * 16,
                       reinterpret_cast<const unsigned char*>(kp) + off, n);
            cp_async16(slot + (CHUNK + t) * RSB + ch * 16,
                       reinterpret_cast<const unsigned char*>(vp) + off, n);
        }
        // The chunk's k scales, then its v scales.
        for (int e = lane; I8 && e < 2 * CHUNK; e += 32) {
            const int t = e % CHUNK;
            const bool live = pos0 + t < len;
            size_t si = 0;
            if (live) {
                size_t page;
                int sl;
                locate(t, page, sl);
                si = (page * Hkv + g) * ps_pad + sl;
            }
            float* dst = reinterpret_cast<float*>(slot + 2 * CHUNK * RSB);
            cp_async4(dst + e, (e < CHUNK ? ks : vs) + si, live ? 4 : 0);
        }
    };

#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
        if (st < nchunks) issue(st);
        cp_async_commit();           // one group per chunk, empty or not
    }
    // The combine may launch now; it waits for this grid to complete.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    // q's A fragments (row gid + 8 h in slots 2 h, 2 h + 1; rows past
    // `rows` zero), in registers for the whole walk.
    uint32_t qa[KD][2 * RH];
#pragma unroll
    for (int h = 0; h < RH; ++h) {
        const int r = gid + 8 * h;
        const bool row_ok = r < rows;
        const __nv_bfloat16* qr = q + q_index(row_ok ? r : 0) * D;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t a0 = 0, a2 = 0;
            if (row_ok) {
                if (I8) {
                    const uint2 w = *reinterpret_cast<const uint2*>(
                        qr + 16 * kk + 4 * tig);
                    a0 = w.x;
                    a2 = w.y;
                } else {
                    a0 = *reinterpret_cast<const uint32_t*>(
                        qr + 16 * kk + 2 * tig);
                    a2 = *reinterpret_cast<const uint32_t*>(
                        qr + 16 * kk + 2 * tig + 8);
                }
            }
            qa[kk][2 * h] = a0;
            qa[kk][2 * h + 1] = a2;
        }
    }

    // Row gid + 8 h's running max (log2) and sum; o[n][2 h + c] its
    // output column c of n-tile n.
    float m[RH], l[RH];
    float o[ND][2 * RH];
#pragma unroll
    for (int h = 0; h < RH; ++h) {
        m[h] = -INFINITY;
        l[h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 2 * RH; ++c) o[n][c] = 0.f;

    // A lane's ldmatrix row address within a slot (bytes), for n-tiles /
    // k-steps (0, 1) of a 16-token group:
    //   bf16 k: matrix i = (n-tile i >> 1, k-half i & 1);
    //   int8 k: matrix i = (n-tile i & 1, k-step 2 kp + (i >> 1));
    //   v (both): matrix i = (tokens 8 (i & 1).., d block i >> 1).
    const int mi = lane >> 3, mr = lane & 7;
    const int k_lane = I8 ? (8 * (mi & 1) + mr) * RSB + 16 * (mi >> 1)
                          : (8 * (mi >> 1) + mr) * RSB + 16 * (mi & 1);
    const int v_lane = (CHUNK + 8 * (mi & 1) + mr) * RSB + 16 * (mi >> 1);

    for (int i = 0; i < nchunks; ++i) {
        cp_async_wait<STAGES - 1>();   // chunk i has landed (this lane's)
        __syncwarp();                  // ... every lane's
        const unsigned char* slot = ring + (i % STAGES) * R::SLOT;
        const int pos0 = first + i * CHUNK * NW;

        // s = q . k over the chunk's tokens (NT n-tiles of 8); the
        // n-tiles' accumulations interleave, each in k-step order.
        float s[NT][2 * RH];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int c = 0; c < 2 * RH; ++c) s[nt][c] = 0.f;
        if (I8) {
#pragma unroll
            for (int kp2 = 0; kp2 < KD / 2; ++kp2) {
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t f[4];
                    ldmatrix_x4(f, slot + k_lane + np * 16 * RSB + 32 * kp2);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        uint32_t b0, b1;
                        i8x4_to_bf16x4(f[j], b0, b1);
                        const int kk = 2 * kp2 + (j >> 1);
                        const int nt = 2 * np + (j & 1);
                        mma_rows<RH>(s[nt], qa[kk], b0, b1);
                    }
                }
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
                for (int np = 0; np < NT / 2; ++np) {
                    uint32_t f[4];
                    ldmatrix_x4(f, slot + k_lane + np * 16 * RSB + 32 * kk);
                    mma_rows<RH>(s[2 * np], qa[kk], f[0], f[1]);
                    mma_rows<RH>(s[2 * np + 1], qa[kk], f[2], f[3]);
                }
            }
        }

        // Scale (k scales on int8 pools), mask past the length, softmax.
        const float* sc = reinterpret_cast<const float*>(
            slot + 2 * CHUNK * RSB);
        uint32_t pa[NT][RH];             // p . v's A: row half h, n-tile nt
#pragma unroll
        for (int h = 0; h < RH; ++h) {
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int t = 8 * nt + 2 * tig + c;
                    const float sk = I8 ? sc[t] : 1.f;
                    float& x = s[nt][2 * h + c];
                    x = pos0 + t < len ? x * sk * scale_log2 : -INFINITY;
                    mx = fmaxf(mx, x);
                }
            }
            mx = quad_max(mx);
            const float mn = fmaxf(m[h], mx);   // finite: token pos0 is live
            const float al = m[h] == -INFINITY ? 0.f : exp2f(m[h] - mn);
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                float p[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    p[c] = exp2f(s[nt][2 * h + c] - mn);
                    sum += p[c];
                    if (I8) p[c] *= sc[CHUNK + 8 * nt + 2 * tig + c];
                }
                pa[nt][h] = pack_bf16(p[0], p[1]);
            }
            l[h] = l[h] * al + quad_sum(sum);
            m[h] = mn;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                o[n][2 * h] *= al;
                o[n][2 * h + 1] *= al;
            }
        }

        // o += p . v, KS k-steps of 16 tokens; an ldmatrix.x4.trans covers
        // 32 d of int8 rows, 16 d of bf16 rows.
#pragma unroll
        for (int kt = 0; kt < KS; ++kt) {
            uint32_t a[2 * RH];
#pragma unroll
            for (int h = 0; h < RH; ++h) {
                a[2 * h] = pa[2 * kt][h];
                a[2 * h + 1] = pa[2 * kt + 1][h];
            }
#pragma unroll
            for (int jp = 0; jp < (I8 ? D / 32 : D / 16); ++jp) {
                uint32_t f[4];
                ldmatrix_x4_trans(f, slot + v_lane + kt * 16 * RSB + 32 * jp);
                if (I8) {
                    // f[0], f[1]: tokens 0-7 / 8-15 of d block 2 jp; f[2],
                    // f[3] of block 2 jp + 1. byte_perm pairs two tokens
                    // of one d: (even d, odd d) -> n-tiles (2j, 2j + 1).
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        uint32_t e0, o0, e1, o1;
                        i8x4_to_bf16x4(__byte_perm(f[2 * hh], 0, 0x3120), e0,
                                       o0);
                        i8x4_to_bf16x4(__byte_perm(f[2 * hh + 1], 0, 0x3120),
                                       e1, o1);
                        const int j = 2 * jp + hh;
                        mma_rows<RH>(o[2 * j], a, e0, e1);
                        mma_rows<RH>(o[2 * j + 1], a, o0, o1);
                    }
                } else {
                    // d 16 jp.. -> n-tile 2 jp, d 16 jp + 8.. -> 2 jp + 1.
                    mma_rows<RH>(o[2 * jp], a, f[0], f[1]);
                    mma_rows<RH>(o[2 * jp + 1], a, f[2], f[3]);
                }
            }
        }
        __syncwarp();                  // every lane is done with the slot
        if (i + STAGES < nchunks) issue(i + STAGES);
        cp_async_commit();
    }

    // Merge the warps in warp order through shared memory (the ring is
    // free once every warp is past its walk).
    cp_async_wait<0>();
    __syncthreads();
    float* const ml_s = reinterpret_cast<float*>(smem);       // [NW][ROWS][2]
    float* const acc_s = ml_s + NW * ROWS * 2;                // [NW][ROWS][D]
#pragma unroll
    for (int h = 0; h < RH; ++h) {
        const int r = gid + 8 * h;
        if (r >= rows) continue;
        if (tig == 0) {
            ml_s[(warp * ROWS + r) * 2] = m[h];
            ml_s[(warp * ROWS + r) * 2 + 1] = l[h];
        }
        float* acc = acc_s + (warp * ROWS + r) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            if (I8) {
                const int d = 16 * (n >> 1) + 4 * tig + (n & 1);
                acc[d] = o[n][2 * h];
                acc[d + 2] = o[n][2 * h + 1];
            } else {
                const int d = 8 * n + 2 * tig;
                acc[d] = o[n][2 * h];
                acc[d + 1] = o[n][2 * h + 1];
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < rows * D; e += THREADS) {
        const int r = e / D, d = e % D;
        float mb = -INFINITY;
#pragma unroll
        for (int w = 0; w < NW; ++w)
            mb = fmaxf(mb, ml_s[(w * ROWS + r) * 2]);
        float acc = 0.f, lb = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            const float f = exp2f(ml_s[(w * ROWS + r) * 2] - mb);
            acc += acc_s[(w * ROWS + r) * D + d] * f;
            lb += ml_s[(w * ROWS + r) * 2 + 1] * f;
        }
        const size_t wi = q_index(r) * splits + sp;
        ws_acc[wi * D + d] = acc;
        if (d == 0) {
            ws_ml[wi * 2] = mb;
            ws_ml[wi * 2 + 1] = lb;
        }
    }
}

// Merge the live slices in slice order and normalise; append mode
// (kc != nullptr) seeds the merge with the current token's term
// (m = s_cur, l = 1, acc = v_cur), pool mode starts from (m = -inf,
// l = 0, acc = 0). A row with nothing to attend (pool mode, lengths[b]
// = 0: outside the serving contract) gets zeros. Grid (B, Hq), one thread
// per element of D; s_cur is one dot product per (b, h), reduced over the
// block's warps in a fixed order.
__global__ void paged_combine_kernel(const __nv_bfloat16* __restrict__ q,
                                     const __nv_bfloat16* __restrict__ kc,
                                     const __nv_bfloat16* __restrict__ vc,
                                     const int* __restrict__ lengths,
                                     const float* __restrict__ ws_acc,
                                     const float* __restrict__ ws_ml,
                                     __nv_bfloat16* __restrict__ out,
                                     int Hq, int Hkv, int D, int splits,
                                     int window, float scale_log2)
{
    __shared__ float part[4];
    const int b = blockIdx.x;
    const int h = blockIdx.y;
    const int d = threadIdx.x;
    const int g = h / (Hq / Hkv);
    const size_t qi = ((size_t)b * Hq + h) * D;
    const size_t ki = ((size_t)b * Hkv + g) * D;
    const size_t wb = ((size_t)b * Hq + h) * splits;
    const int live = (min(lengths[b], window) + SLICE - 1) / SLICE;
    float m = -INFINITY, s = 0.f;
    if (kc != nullptr) {
        float x = __bfloat162float(q[qi + d]) * __bfloat162float(kc[ki + d]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
        if ((d & 31) == 0) part[d >> 5] = x;
        __syncthreads();
        x = part[0];
        for (int w = 1; w < D / 32; ++w) x += part[w];
        s = x * scale_log2;
        m = s;
    }
    // The split grid's workspace is complete and visible past this point
    // (a no-op when launched without the programmatic dependency).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    // Unrolled so that the loads of several slices are in flight at once.
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) m = fmaxf(m, ws_ml[(wb + sp) * 2]);
    float den = 0.f, num = 0.f;
    if (kc != nullptr) {
        den = exp2f(s - m);
        num = den * __bfloat162float(vc[ki + d]);
    }
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) {
        const float f = exp2f(ws_ml[(wb + sp) * 2] - m);
        den += ws_ml[(wb + sp) * 2 + 1] * f;
        num += ws_acc[(wb + sp) * D + d] * f;
    }
    out[qi + d] = __float2bfloat16(den > 0.f ? num / den : 0.f);
}

// Verify mode's combine: the live slices of each query row merged in
// slice order after the in-register block, then normalised. Grid (B S,
// Hq), one thread per element of D. The block's S scores of query
// position j are computed here at full precision (f32 dot products of the
// bf16 q and k_blk, reduced over the block's warps in a fixed order); a
// block position i enters where mask[b, j, i] != 0 (mask null: i <= j).
__global__ void paged_verify_combine_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kb,
    const __nv_bfloat16* __restrict__ vb, const unsigned char* __restrict__ mask,
    const int* __restrict__ lengths, const float* __restrict__ ws_acc,
    const float* __restrict__ ws_ml, __nv_bfloat16* __restrict__ out, int S,
    int Hq, int Hkv, int D, int splits, int window, float scale_log2)
{
    __shared__ float part[4][MAX_S];
    __shared__ float sb[MAX_S];
    const int b = blockIdx.x / S;
    const int j = blockIdx.x % S;
    const int h = blockIdx.y;
    const int d = threadIdx.x;
    const int g = h / (Hq / Hkv);
    const size_t qi = ((size_t)blockIdx.x * Hq + h) * D;
    const size_t wb = ((size_t)blockIdx.x * Hq + h) * splits;
    const float qd = __bfloat162float(q[qi + d]);
    for (int i = 0; i < S; ++i) {
        float x = qd * __bfloat162float(
            kb[(((size_t)b * S + i) * Hkv + g) * D + d]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
        if ((d & 31) == 0) part[d >> 5][i] = x;
    }
    __syncthreads();
    for (int i = d; i < S; i += D) {
        float x = part[0][i];
        for (int w = 1; w < D / 32; ++w) x += part[w][i];
        const bool on = mask != nullptr
            ? mask[((size_t)b * S + j) * S + i] != 0 : i <= j;
        sb[i] = on ? x * scale_log2 : -INFINITY;
    }
    __syncthreads();
    float m = -INFINITY;
    for (int i = 0; i < S; ++i) m = fmaxf(m, sb[i]);
    // The split grid's workspace is complete and visible past this point.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int live = (min(lengths[b], window) + SLICE - 1) / SLICE;
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) m = fmaxf(m, ws_ml[(wb + sp) * 2]);
    float den = 0.f, num = 0.f;
    for (int i = 0; i < S; ++i) {
        if (sb[i] == -INFINITY) continue;
        const float p = exp2f(sb[i] - m);
        den += p;
        num += p * __bfloat162float(vb[(((size_t)b * S + i) * Hkv + g) * D
                                       + d]);
    }
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) {
        const float f = exp2f(ws_ml[(wb + sp) * 2] - m);
        den += ws_ml[(wb + sp) * 2 + 1] * f;
        num += ws_acc[(wb + sp) * D + d] * f;
    }
    out[qi + d] = __float2bfloat16(num / den);
}

template <typename T, int D, int ROWS>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q,
                         const void* kp, const void* vp, const void* ks,
                         const void* vs, const void* pt, int pt_stride,
                         const void* lengths, void* ws_acc, void* ws_ml,
                         int layer, int N, int ps, int ps_pad, int Hkv,
                         int rep, int S, int pages, float scale_log2)
{
    // Above 48 KB a launch needs the opt-in, once per device.
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(paged_split_kernel<T, D, ROWS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Ring<T, D>::SMEM);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    paged_split_kernel<T, D, ROWS><<<grid, THREADS, Ring<T, D>::SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt), pt_stride,
        static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), layer, N, ps, ps_pad, Hkv, rep, S, pages,
        scale_log2);
    return cudaGetLastError();
}

// The split kernel over the pool for S query positions per row: rows of
// ROWS (8: decode modes, S = 1; 16: verify mode) per block.
template <int ROWS>
cudaError_t launch_pool_walk(const void* q, const void* kp, const void* vp,
                             const void* ks, const void* vs, const void* pt,
                             int pt_stride, const void* lengths, void* ws_acc,
                             void* ws_ml, int B, int S, int Hkv, int rep,
                             int D, int N, int ps, int ps_pad, int layer,
                             int pages, int splits, int quantized,
                             cudaStream_t st, float scale_log2)
{
    const int groups = (S * rep + ROWS - 1) / ROWS;
    const dim3 grid(splits, Hkv * groups, B);
#define PA_ARGS grid, st, q, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc, \
    ws_ml, layer, N, ps, ps_pad, Hkv, rep, S, pages, scale_log2
    if (quantized) {
        if (D == 32) return launch_split<int8_t, 32, ROWS>(PA_ARGS);
        if (D == 64) return launch_split<int8_t, 64, ROWS>(PA_ARGS);
        return launch_split<int8_t, 128, ROWS>(PA_ARGS);
    }
    if (D == 32) return launch_split<__nv_bfloat16, 32, ROWS>(PA_ARGS);
    if (D == 64) return launch_split<__nv_bfloat16, 64, ROWS>(PA_ARGS);
    return launch_split<__nv_bfloat16, 128, ROWS>(PA_ARGS);
#undef PA_ARGS
}

bool bad_geometry(int B, int Hq, int Hkv, int D, int ps, int pages,
                  int splits, int quantized, const void* ks, const void* vs)
{
    const int rep = Hkv > 0 ? Hq / Hkv : 0;
    return rep < 1 || rep > MAX_REP || rep * Hkv != Hq || B < 1 || ps < 1
        || pages < 1 || (long long)splits * SLICE < (long long)pages * ps
        || (D != 32 && D != 64 && D != 128)
        || (quantized && (ks == nullptr || vs == nullptr));
}

// A programmatic dependent of the split kernel: the combine's blocks
// start while the split's last blocks run and wait (griddepcontrol.wait)
// for the split grid's completion and its writes.
template <typename... Params, typename... Args>
cudaError_t launch_combine(void (*kernel)(Params...), dim3 grid, int D,
                           cudaStream_t st, Args... args)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(D);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// Append and pool modes: the split kernel over the pool, then the combine
// (kc/vc null in pool mode).
int launch(const void* q, const void* kc, const void* vc, const void* kp,
           const void* vp, const void* ks, const void* vs, const void* pt,
           int pt_stride, const void* lengths, void* ws_acc, void* ws_ml,
           void* out, int B, int Hq, int Hkv, int D, int N, int ps,
           int ps_pad, int layer, int pages, int splits, int quantized,
           void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (bad_geometry(B, Hq, Hkv, D, ps, pages, splits, quantized, ks, vs))
        return (int)cudaErrorInvalidValue;
    const float scale_log2 = LOG2E / sqrtf((float)D);
    cudaError_t err = launch_pool_walk<8>(
        q, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc, ws_ml, B, 1, Hkv,
        Hq / Hkv, D, N, ps, ps_pad, layer, pages, splits, quantized, st,
        scale_log2);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_combine(
        paged_combine_kernel, dim3(B, Hq), D, st,
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kc),
        static_cast<const __nv_bfloat16*>(vc),
        static_cast<const int*>(lengths),
        static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
        static_cast<__nv_bfloat16*>(out), Hq, Hkv, D, splits, pages * ps,
        scale_log2);
}

}  // namespace

extern "C" {

// Append mode. q [B,Hq,D] bf16; kc/vc [B,Hkv,D] bf16; kp/vp
// [L,N,ps,Hkv,D] int8 (quantized != 0, with ks/vs [L,N,Hkv,ps_pad] f32)
// or bf16 (ks/vs null); pt [B,pt_stride] int32; lengths [B] int32 tokens
// in the pool, the current one not counted; ws_acc [B,Hq,splits,D] f32;
// ws_ml [B,Hq,splits,2] f32; out [B,Hq,D] bf16. splits * SLICE
// (paged_slice_tokens) must cover pages * ps.
int paged_append_launch(const void* q, const void* kc, const void* vc,
                        const void* kp, const void* vp, const void* ks,
                        const void* vs, const void* pt, int pt_stride,
                        const void* lengths, void* ws_acc, void* ws_ml,
                        void* out, int B, int Hq, int Hkv, int D, int N,
                        int ps, int ps_pad, int layer, int pages,
                        int splits, int quantized, void* stream)
{
    if (kc == nullptr || vc == nullptr) return (int)cudaErrorInvalidValue;
    return launch(q, kc, vc, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc,
                  ws_ml, out, B, Hq, Hkv, D, N, ps, ps_pad, layer, pages,
                  splits, quantized, stream);
}

// Pool mode: the append mode's operands without kc/vc; lengths [B] counts
// the slot this step wrote.
int paged_pool_launch(const void* q, const void* kp, const void* vp,
                      const void* ks, const void* vs, const void* pt,
                      int pt_stride, const void* lengths, void* ws_acc,
                      void* ws_ml, void* out, int B, int Hq, int Hkv, int D,
                      int N, int ps, int ps_pad, int layer, int pages,
                      int splits, int quantized, void* stream)
{
    return launch(q, nullptr, nullptr, kp, vp, ks, vs, pt, pt_stride,
                  lengths, ws_acc, ws_ml, out, B, Hq, Hkv, D, N, ps, ps_pad,
                  layer, pages, splits, quantized, stream);
}

// Verify mode. q [B,S,Hq,D] bf16 (S query positions per row); kb/vb
// [B,S,Hkv,D] bf16 (the block's own k/v, not in the pool); mask [B,S,S]
// uint8 (nonzero = position j attends block position i) or null for the
// chain i <= j; the pool operands as in append mode, lengths [B] tokens
// in the pool (the block not counted); ws_acc [B,S,Hq,splits,D] f32;
// ws_ml [B,S,Hq,splits,2] f32; out [B,S,Hq,D] bf16. 1 <= S <= MAX_S.
int paged_verify_launch(const void* q, const void* kb, const void* vb,
                        const void* mask, const void* kp, const void* vp,
                        const void* ks, const void* vs, const void* pt,
                        int pt_stride, const void* lengths, void* ws_acc,
                        void* ws_ml, void* out, int B, int S, int Hq, int Hkv,
                        int D, int N, int ps, int ps_pad, int layer,
                        int pages, int splits, int quantized, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (kb == nullptr || vb == nullptr || S < 1 || S > MAX_S
            || bad_geometry(B, Hq, Hkv, D, ps, pages, splits, quantized, ks,
                            vs))
        return (int)cudaErrorInvalidValue;
    const float scale_log2 = LOG2E / sqrtf((float)D);
    cudaError_t err = launch_pool_walk<16>(
        q, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc, ws_ml, B, S, Hkv,
        Hq / Hkv, D, N, ps, ps_pad, layer, pages, splits, quantized, st,
        scale_log2);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_combine(
        paged_verify_combine_kernel, dim3(B * S, Hq), D, st,
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kb),
        static_cast<const __nv_bfloat16*>(vb),
        static_cast<const unsigned char*>(mask),
        static_cast<const int*>(lengths),
        static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
        static_cast<__nv_bfloat16*>(out), S, Hq, Hkv, D, splits, pages * ps,
        scale_log2);
}

// The largest block verify mode takes (positions per row).
int paged_verify_max_s() { return MAX_S; }

// Tokens per slice: the workspace holds ceil(pages * ps / SLICE) slices
// per (row, query head).
int paged_slice_tokens() { return SLICE; }

// The split kernel's dynamic shared memory per block (bytes) for a pool
// type and head width, or -1 for an unsupported pair.
int paged_split_smem(int quantized, int D)
{
    if (D == 32) return quantized ? Ring<int8_t, 32>::SMEM
                                  : Ring<__nv_bfloat16, 32>::SMEM;
    if (D == 64) return quantized ? Ring<int8_t, 64>::SMEM
                                  : Ring<__nv_bfloat16, 64>::SMEM;
    if (D == 128) return quantized ? Ring<int8_t, 128>::SMEM
                                   : Ring<__nv_bfloat16, 128>::SMEM;
    return -1;
}

const char* paged_append_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
