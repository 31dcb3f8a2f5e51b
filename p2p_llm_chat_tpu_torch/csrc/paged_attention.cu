// Kernel B: paged decode attention for Hopper (sm_90a), plain C
// interface for ctypes. Three modes: append and pool modes over one split
// kernel and its combine, and verify mode over a kernel of its own and
// its merge.
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
// Pallas) computes, for speculative verify, tree verify, a session wake's
// suffix forward (S up to 256) and the resident drafter's catch-up feeds
// (S up to 512): S positions per row attend the pool window (the same
// positions t < lengths[b] for every j) plus the block's own k/v, which is
// not in the pool, at full precision:
//   s_t = (q_j . k_t) / sqrt(D) * sk_t                  for t < lengths[b]
//   s_i = (q_j . kb_i) / sqrt(D)     where mask[b, j, i] (default i <= j)
//   out_j = (sum_t e^{s_t-m} sv_t v_t + sum_i e^{s_i-m} vb_i)
//         / (sum_t e^{s_t-m} + sum_i e^{s_i-m})
// In every mode positions >= lengths[b] are never loaded and never
// multiplied by 0: a garbage page may hold NaN or Inf.
//
// Bound on an H100 SXM, decode modes: the pool read. At B = 8, W = 1024,
// Hkv = 8, D = 128 an int8 layer reads 16.8 MB of k/v + 0.5 MB of scales
// -> 5.2 us at 3.35 TB/s, a bf16 layer 33.6 MB -> 10.1 us. The products
// are 4 FLOPs per k/v element and query head, ~0.27 GFLOP a layer: nothing
// on tensor cores, but ~150 M lane-operations on the CUDA cores, which
// would cap the kernel near its byte bound. So both products run on
// tensor cores, and the design's aim is to have the whole window in
// flight at once.
//
// Decode design (mma.sync m16n8k16 bf16 -> f32 with cp.async rings; TMA,
// wgmma and a persistent grid are later work):
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
// (bound 0.322), against 1.5-1.7 ms for SDPA over a pre-gathered window.
// Timed cut-downs of this source (PERF.md, kernel B) put an int8 layer at
// 4.4 us for the launches, the prologue and the combine alone; 10.8 us
// with the reads but not the walk's arithmetic (the 17.3 MB in ~6.4 us,
// 2.7 TB/s); 12.5 us with the arithmetic on zero-filled chunks but no
// reads; 15 us for the kernel. What bounds it now is the walk's
// arithmetic (int8 conversion, mma.sync, softmax at ~2 warps a
// scheduler) after the chunks land together, not the pool read. Slices
// of 128 tokens, 8 warps a block, 16-token int8 chunks and a plain
// combine launch were each slower.
//
// Verify mode's bound: operations at a wake (R = 1, S = 256, W = 2048,
// llama3.1-8b: 8.6 GFLOP a layer, 8.7 us at 989 TFLOP/s, against 4.2 MB
// of int8 window), bytes at a spec tick (B = 8, S = 8, W = 1024: 17.3 MB
// of int8 window and scales, 5.2 us). It replaces the first verify mode,
// a reuse of the decode split kernel with 16-row tiles, which read and
// converted the window once per 16 query rows (64 times a kv head at a
// wake) and left the block's k/v to its combine: one thread per element
// of D, S serial dot products and a serial p . v loop over S per
// (position, head).
//
// Verify design (mma.sync m16n8k16 bf16 -> f32):
// - Grid (q tiles, slices + 1, B Hkv). The S x rep query rows of a kv
//   head are packed (row r = position r / rep, head g rep + r % rep) into
//   tiles of VQ = 64 rows; a block owns one tile and one slice, its 4
//   warps 16 rows each with q's A fragments in registers. q tiles of one
//   slice launch side by side, so the window's re-reads come from L2.
// - Slices y < splits are the window's, of verify_slice(S) tokens (256
//   at S <= 64 for the spread of a spec tick, 1024 above) at fixed
//   absolute positions; a slice wholly past lengths[b] exits at once.
//   Slice y = splits is the block's own k/v [B, S, Hkv, D], walked up to
//   the tile's last position under the chain mask (a warp skips chunks
//   wholly past its rows), or whole under a [B, S, S] tree mask.
// - One ring of VSTAGES 64-token chunks for the whole block, filled by
//   cp.async from a token table the block builds once (each position's
//   pool row and scale index), one barrier a chunk: every warp reads each
//   chunk from shared memory by ldmatrix (k) and ldmatrix.trans (v), as
//   kernel D does. On int8 pools the raw chunk lands in the ring and the
//   block converts it once into a bf16 tile (exact, i8x4_to_bf16x4), a
//   second barrier; the k and v scales stay in the ring slot. The k tile
//   is row-major [64][D] bf16 with 16-byte row padding.
// - Online softmax per row in log2 units on the score fragments: the max
//   on the unscaled scores (times the k scales on int8 pools), each p one
//   FFMA and one ex2.approx, the lanes' share of the sum reduced once at
//   the end, o rescaled only when some row's max moved. Window: v scales
//   on the numerator's probabilities, which are rounded to bf16 for
//   p . v (as the decode modes). The block's p . v keeps the plain
//   version's f32 accuracy: p is split into a bf16 high part and a bf16
//   low part, two products (p - hi - lo is below 2^-16 p).
// - Each block writes its rows' (m, l, acc) to the workspace
//   [B, S, Hq, splits + 1, D] (+ m, l); the merge (a programmatic
//   dependent launch, one warp per (row, position, head)) takes the live
//   window slices in slice order, then the block's partial, and
//   normalises. No atomics, nothing ordered by B or the window: reruns,
//   each row at B = 1 and at a window of 2W are bitwise equal. The
//   workspace at the widest call, B = 8, S = 512, W = 4096, is 340.8 MB
//   for llama3.1-8b (Hq 32, D 128) and 85.2 MB for draft-400m (Hq 8).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; device time of 32 layers
// replayed from CUDA graphs, the parent's and this kernel in one call;
// split kernel + the merge's time past its end by torch.profiler): a
// wake on an int8 pool 15.45 ms (split 5.12, combine 10.44) -> 2.46
// (2.28 + 0.20), on the bf16 dense cache 16.32 (5.91 + 10.42) -> 2.29
// (2.06 + 0.19), against 2.21 for SDPA over the pre-gathered window; a
// spec tick 1.137 -> 0.839, A8's S = 5 verify 1.170 -> 0.774. ptxas: 226
// (bf16) and 238 (int8) registers at D = 128, no spills, two blocks an
// SM. Cut-downs of this source at the wake put the split kernel at 1.02
// ms with no walk arithmetic at all, 1.96 without the softmax, 2.13
// without the products, 2.29 whole: the softmax and ldmatrix path at two
// warps a scheduler bounds it, not the tensor cores. Measured no better:
// 8 warps with 128-row tiles (half the ring traffic), ldmatrix double
// buffering, a 2-stage ring at 3 blocks an SM, 512-token slices, two
// m-tiles a warp (255 registers and spills), 32-token chunks with q in
// shared memory, and wgmma for q . k (A from registers, the k tile as B
// in the no-swizzle K-major layout): bitwise the same, 6-14% slower,
// since a synchronous warpgroup product costs every warp, dead rows too,
// plus proxy fences, and overlapping it with the softmax needs a second
// score buffer the registers do not leave room for.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int SLICE = 256;       // tokens per block (paged_slice_tokens)
constexpr int NW = 4;            // warps per block
constexpr int THREADS = 32 * NW;
constexpr int MAX_REP = 8;
// Verify mode's block positions per row: a speculative block (<= 64), a
// session wake's suffix bucket (<= 256) or a drafter's catch-up feed
// (<= 512, the reference's cap).
constexpr int MAX_S = 512;
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

// Verify mode's tiles: VQ packed query rows a block (16 a warp), chunks
// of VCH positions in a ring of VSTAGES, window slices of at most
// VSLICE_MAX tokens.
constexpr int VQ = 16 * NW;
constexpr int VCH = 64;
constexpr int VSTAGES = 3;
constexpr int VSLICE_MAX = 1024;

// Window slice length for S block positions (paged_verify_slice_tokens):
// fixed by S alone, never by B or the window.
constexpr int verify_slice(int S) { return S <= 64 ? 256 : VSLICE_MAX; }

// Verify mode's dynamic shared memory: a ring of VSTAGES bf16 chunks (k
// tile, v tile) for bf16 pools and for the block's own k/v; on int8 pools
// the window walks a raw ring (k, v bytes, then the chunk's k and v
// scales) and converts each chunk into one bf16 tile. The slice's token
// table (pool rows; scale indices on int8 pools) follows the window's
// ring; the block's own walk uses neither.
template <int D, bool I8>
struct VSmem {
    static constexpr int RS = D + 8;                  // tile row, halves
    static constexpr int TILE = VCH * RS;             // halves a k or v tile
    static constexpr int BF_RING = VSTAGES * 2 * TILE * 2;
    static constexpr int I8_SLOT = 2 * VCH * D + 2 * VCH * 4;
    static constexpr int I8_CVT = VSTAGES * I8_SLOT;  // the bf16 tile's offset
    static constexpr int I8_RING = I8_CVT + 2 * TILE * 2;
    static constexpr int TABLE = I8 ? I8_RING : BF_RING;
    static constexpr int WIN = TABLE + VSLICE_MAX * 4 * (I8 ? 2 : 1);
    static constexpr int BYTES = WIN > BF_RING ? WIN : BF_RING;
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

// c += A . B over one m16n8k16 step, every row live: a[0..3] = a0..a3,
// c[0..1] row gid, c[2..3] row gid + 8.
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
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

// (lo, hi) as bf16 pairs: the rounded pair, and the rounded remainder.
__device__ __forceinline__ void pack_bf16_split(float lo, float hi,
                                                uint32_t& top, uint32_t& rest)
{
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    const float2 f = __bfloat1622float2(p);
    top = *reinterpret_cast<const uint32_t*>(&p);
    rest = pack_bf16(lo - f.x, hi - f.y);
}

__device__ __forceinline__ float ex2(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
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
// Where each operand element sits in the decode modes' split kernel (a
// chunk's token t = 8 nt + column):
//   bf16 pools: k-step ks contracts d = 16 ks + k; output n-tile n,
//     column c is d = 8 n + c (kernel D's layout).
//   int8 pools: k-step ks's k indices (2tig, 2tig+1, 2tig+8, 2tig+9) are
//     d = 16 ks + 4tig + (0, 1, 2, 3); output n-tiles 2j and 2j+1,
//     column c, are d = 16 j + 2c and 16 j + 2c + 1.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ kp, const T* __restrict__ vp,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   const int* __restrict__ page_table, int pt_stride,
                   const int* __restrict__ lengths,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int layer, int N, int ps, int ps_pad, int Hkv, int rep,
                   int pages, float scale_log2)
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
    constexpr int ROWS = 8;                        // A tile rows kept
    extern __shared__ __align__(16) unsigned char smem[];

    const int sp = blockIdx.x;
    const int g = blockIdx.y;
    const int b = blockIdx.z;
    const int splits = gridDim.x;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int Hq = Hkv * rep;
    // Tile row r < rep is query head g rep + r; rows rep..15 are zero and
    // never stored.
    const int rows = rep;
    auto q_index = [&](int r) {                    // [B, Hq] index
        return (size_t)b * Hq + (size_t)g * rep + r;
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

    // q's A fragments (row gid; rows past `rows` zero), in registers for
    // the whole walk.
    uint32_t qa[KD][2];
    {
        const bool row_ok = gid < rows;
        const __nv_bfloat16* qr = q + q_index(row_ok ? gid : 0) * D;
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
            qa[kk][0] = a0;
            qa[kk][1] = a2;
        }
    }

    // Row gid's running max (log2) and sum; o[n][c] its output column c
    // of n-tile n.
    float m = -INFINITY, l = 0.f;
    float o[ND][2];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = 0.f;

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
        float s[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = 0.f;
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
                        mma_top(s[nt][0], s[nt][1], qa[kk][0], qa[kk][1], b0,
                                b1);
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
                    mma_top(s[2 * np][0], s[2 * np][1], qa[kk][0], qa[kk][1],
                            f[0], f[1]);
                    mma_top(s[2 * np + 1][0], s[2 * np + 1][1], qa[kk][0],
                            qa[kk][1], f[2], f[3]);
                }
            }
        }

        // Scale (k scales on int8 pools), mask past the length, softmax.
        const float* sc = reinterpret_cast<const float*>(
            slot + 2 * CHUNK * RSB);
        uint32_t pa[NT];                 // p . v's A: n-tile nt
        {
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int t = 8 * nt + 2 * tig + c;
                    const float sk = I8 ? sc[t] : 1.f;
                    float& x = s[nt][c];
                    x = pos0 + t < len ? x * sk * scale_log2 : -INFINITY;
                    mx = fmaxf(mx, x);
                }
            }
            mx = quad_max(mx);
            const float mn = fmaxf(m, mx);      // finite: token pos0 is live
            const float al = m == -INFINITY ? 0.f : exp2f(m - mn);
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                float p[2];
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    p[c] = exp2f(s[nt][c] - mn);
                    sum += p[c];
                    if (I8) p[c] *= sc[CHUNK + 8 * nt + 2 * tig + c];
                }
                pa[nt] = pack_bf16(p[0], p[1]);
            }
            l = l * al + quad_sum(sum);
            m = mn;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                o[n][0] *= al;
                o[n][1] *= al;
            }
        }

        // o += p . v, KS k-steps of 16 tokens; an ldmatrix.x4.trans covers
        // 32 d of int8 rows, 16 d of bf16 rows.
#pragma unroll
        for (int kt = 0; kt < KS; ++kt) {
            const uint32_t a0 = pa[2 * kt], a2 = pa[2 * kt + 1];
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
                        mma_top(o[2 * j][0], o[2 * j][1], a0, a2, e0, e1);
                        mma_top(o[2 * j + 1][0], o[2 * j + 1][1], a0, a2, o0,
                                o1);
                    }
                } else {
                    // d 16 jp.. -> n-tile 2 jp, d 16 jp + 8.. -> 2 jp + 1.
                    mma_top(o[2 * jp][0], o[2 * jp][1], a0, a2, f[0], f[1]);
                    mma_top(o[2 * jp + 1][0], o[2 * jp + 1][1], a0, a2, f[2],
                            f[3]);
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
    if (gid < rows) {
        const int r = gid;
        if (tig == 0) {
            ml_s[(warp * ROWS + r) * 2] = m;
            ml_s[(warp * ROWS + r) * 2 + 1] = l;
        }
        float* acc = acc_s + (warp * ROWS + r) * D;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            if (I8) {
                const int d = 16 * (n >> 1) + 4 * tig + (n & 1);
                acc[d] = o[n][0];
                acc[d + 2] = o[n][1];
            } else {
                const int d = 8 * n + 2 * tig;
                acc[d] = o[n][0];
                acc[d + 1] = o[n][1];
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

// One chunk of VCH key positions for the 16 rows a warp holds (lane rows
// gid, gid + 8): s = q . k over the chunk's bf16 k tile, the online
// softmax, o += p . v over its v tile. KIND 0: a window chunk of a bf16
// pool; 1: of an int8 pool (k scales sk[c] on the scores, v scales sv[c]
// on the numerator's probabilities); 2: the block's own k/v (p split
// into bf16 high and low parts, two products). Key column c is position
// x0 + c; where `masked`, row h sees it iff x0 + c <= lim[h] and, with a
// tree mask, mrow[h][x0 + c] != 0. m is in log2 units; l holds the
// lane's own share of the row's sum (the caller adds the quad's up once,
// at the end). A chunk wholly masked for a row leaves its (m, l, o)
// exactly as they were.
template <int D, int KIND>
__device__ __forceinline__ void attend_chunk(
    const uint16_t* kt, const uint16_t* vt, const float* sk, const float* sv,
    const uint32_t (&qa)[D / 16][4], float (&o)[D / 8][4], float (&m)[2],
    float (&l)[2], int lane, bool masked, int x0, const int (&lim)[2],
    const unsigned char* const (&mrow)[2], float scale_log2)
{
    constexpr int RS = D + 8, KD = D / 16, ND = D / 8, NT = VCH / 8;
    const int tig = lane & 3;
    // A lane's ldmatrix.x4 row within a tile (halves): k rows are n, so
    // matrix i is n-tile i / 2, k-half i % 2; v rows are k (.trans), so
    // matrix i is k-half i % 2, n-tile i / 2 (kernel D's maps).
    const int k_lane = ((lane & 7) + 8 * (lane >> 4)) * RS
                       + 8 * ((lane >> 3) & 1);
    const int v_lane = ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS
                       + 8 * (lane >> 4);

    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            uint32_t f[4];
            ldmatrix_x4(f, kt + np * 16 * RS + kk * 16 + k_lane);
            mma16(s[2 * np], qa[kk], f[0], f[1]);
            mma16(s[2 * np + 1], qa[kk], f[2], f[3]);
        }
    }

    // Scores stay unscaled (times the k scales on int8 pools): the max is
    // taken on them (scale_log2 > 0), and each p = 2^(x scale - max) is
    // one FFMA and one ex2.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int col = 8 * nt + 2 * tig + (c & 1);
            const int h = c >> 1;
            float x = KIND == 1 ? s[nt][c] * sk[col] : s[nt][c];
            if (masked) {
                const int pos = x0 + col;
                bool vis = pos <= lim[h];
                if (KIND == 2 && mrow[h] != nullptr)
                    vis = vis && mrow[h][pos] != 0;
                if (!vis) x = -INFINITY;
            }
            s[nt][c] = x;
            mx[h] = fmaxf(mx[h], x);
        }
    }
    float sh[2], al[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]) * scale_log2);
        // A row with nothing visible yet keeps m = -inf; shift by 0 then
        // (every p is 0 and alpha multiplies zeros).
        sh[h] = mn == -INFINITY ? 0.f : mn;
        al[h] = m[h] == -INFINITY ? 0.f : ex2(m[h] - mn);
        m[h] = mn;
        l[h] *= al[h];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const float p = ex2(fmaf(s[nt][c], scale_log2, -sh[c >> 1]));
            l[c >> 1] += p;
            s[nt][c] = KIND == 1 ? p * sv[8 * nt + 2 * tig + (c & 1)] : p;
        }
    }
    // Rescale o only where some row's max moved (alpha = 1 is exact).
    if (__any_sync(0xffffffffu, al[0] != 1.f || al[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            o[n][0] *= al[0];
            o[n][1] *= al[0];
            o[n][2] *= al[1];
            o[n][3] *= al[1];
        }
    }

    // o += p . v: the score fragments of n-tiles 2 kk, 2 kk + 1 are the A
    // fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t pa[4], pr[4];
        if (KIND == 2) {
            pack_bf16_split(s[2 * kk][0], s[2 * kk][1], pa[0], pr[0]);
            pack_bf16_split(s[2 * kk][2], s[2 * kk][3], pa[1], pr[1]);
            pack_bf16_split(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pr[2]);
            pack_bf16_split(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pr[3]);
        } else {
            pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
            pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
            pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
            pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
            uint32_t f[4];
            ldmatrix_x4_trans(f, vt + kk * 16 * RS + dp * 16 + v_lane);
            mma16(o[2 * dp], pa, f[0], f[1]);
            mma16(o[2 * dp + 1], pa, f[2], f[3]);
            if (KIND == 2) {
                mma16(o[2 * dp], pr, f[0], f[1]);
                mma16(o[2 * dp + 1], pr, f[2], f[3]);
            }
        }
    }
}

// Verify mode. Block (qt, y, b Hkv + g): packed rows [VQ qt, VQ qt + VQ)
// of kv head g of row b; y < splits walks window slice y, y = splits the
// block's own k/v. Writes the rows' partial (m, l, acc) at partial index
// y of the workspace [B, S, Hq, splits + 1, D] (+ [.., 2]).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
paged_verify_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kb,
                    const __nv_bfloat16* __restrict__ vb,
                    const unsigned char* __restrict__ mask,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ page_table, int pt_stride,
                    const int* __restrict__ lengths,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int layer, int N, int ps, int ps_pad, int Hkv, int rep,
                    int S, int pages, int slice, float scale_log2)
{
    constexpr bool I8 = sizeof(T) == 1;
    using V = VSmem<D, I8>;
    constexpr int RS = V::RS, TILE = V::TILE;
    constexpr int KD = D / 16, ND = D / 8;
    extern __shared__ __align__(16) unsigned char smem[];

    const int qt = blockIdx.x;
    const int sp = blockIdx.y;
    const int P = gridDim.y;                       // window slices + 1
    const bool blk = sp == P - 1;
    const int b = blockIdx.z / Hkv, g = blockIdx.z % Hkv;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tig = lane & 3;
    const int Hq = Hkv * rep;
    const int nrows = S * rep;
    const int wrow = VQ * qt + 16 * warp;          // the warp's first row
    auto q_index = [&](int r) {                    // [B, S, Hq] index
        return ((size_t)b * S + r / rep) * Hq + (size_t)g * rep + r % rep;
    };

    // The walk: chunks of VCH positions of the window slice [t_begin,
    // t_end), or of the block [0, S).
    const int len = min(lengths[b], pages * ps);
    const int t_begin = sp * slice;
    if (!blk && t_begin >= len) return;            // never read: skipped
    const int n_tok = blk ? S : min(len, t_begin + slice) - t_begin;
    int nch = (n_tok + VCH - 1) / VCH;
    if (blk && mask == nullptr)                    // up to the tile's last j
        nch = (min(VQ * qt + VQ, nrows) - 1) / rep / VCH + 1;

    uint16_t* const ring16 = reinterpret_cast<uint16_t*>(smem);
    uint32_t* const row_s = reinterpret_cast<uint32_t*>(smem + V::TABLE);
    uint32_t* const sidx_s = row_s + VSLICE_MAX;
    const T* const kl = kp + (size_t)layer * N * ps * Hkv * D;
    const T* const vl = vp + (size_t)layer * N * ps * Hkv * D;
    const size_t sc_layer = (size_t)layer * N * Hkv * ps_pad;
    if (!blk) {
        // Each position's pool row (and scale index), once for the slice.
        for (int t = tid; t < n_tok; t += THREADS) {
            const int pos = t_begin + t;
            const int pi = pos / ps;
            const uint32_t pg = page_table[(size_t)b * pt_stride + pi];
            const uint32_t sl = pos - pi * ps;
            row_s[t] = (pg * ps + sl) * Hkv + g;
            if (I8) sidx_s[t] = (pg * Hkv + g) * ps_pad + sl;
        }
        __syncthreads();
    }

    // Chunk c into its ring slot: positions past the walk's end are
    // zero-filled and never read from memory.
    auto issue = [&](int c) {
        const int t0 = VCH * c;
        if (blk || !I8) {
            uint16_t* const kt = ring16 + (c % VSTAGES) * 2 * TILE;
            uint16_t* const vt = kt + TILE;
            constexpr int CPR = D / 8;             // 16 B pieces a row
            for (int e = tid; e < VCH * CPR; e += THREADS) {
                const int t = e / CPR, ch = e % CPR;
                const bool ok = t0 + t < n_tok;
                size_t off = ch * 8;
                const __nv_bfloat16 *ksrc, *vsrc;
                if (blk) {
                    if (ok) off += (((size_t)b * S + t0 + t) * Hkv + g) * D;
                    ksrc = kb + off;
                    vsrc = vb + off;
                } else {
                    if (ok) off += (size_t)row_s[t0 + t] * D;
                    ksrc = reinterpret_cast<const __nv_bfloat16*>(kl) + off;
                    vsrc = reinterpret_cast<const __nv_bfloat16*>(vl) + off;
                }
                cp_async16(kt + t * RS + ch * 8, ksrc, ok ? 16 : 0);
                cp_async16(vt + t * RS + ch * 8, vsrc, ok ? 16 : 0);
            }
        } else {
            unsigned char* const slot = smem + (c % VSTAGES) * V::I8_SLOT;
            constexpr int CPR = D / 16;
            for (int e = tid; e < VCH * CPR; e += THREADS) {
                const int t = e / CPR, ch = e % CPR;
                const bool ok = t0 + t < n_tok;
                const size_t off = ch * 16
                                   + (ok ? (size_t)row_s[t0 + t] * D : 0);
                cp_async16(slot + t * D + ch * 16,
                           reinterpret_cast<const unsigned char*>(kl) + off,
                           ok ? 16 : 0);
                cp_async16(slot + (VCH + t) * D + ch * 16,
                           reinterpret_cast<const unsigned char*>(vl) + off,
                           ok ? 16 : 0);
            }
            // The chunk's k scales, then its v scales.
            float* const sc = reinterpret_cast<float*>(slot + 2 * VCH * D);
            for (int e = tid; e < 2 * VCH; e += THREADS) {
                const int t = e % VCH;
                const bool ok = t0 + t < n_tok;
                const size_t si = sc_layer + (ok ? sidx_s[t0 + t] : 0);
                cp_async4(sc + e, (e < VCH ? ks : vs) + si, ok ? 4 : 0);
            }
        }
    };
#pragma unroll
    for (int st = 0; st < VSTAGES - 1; ++st) {
        if (st < nch) issue(st);
        cp_async_commit();           // one group per chunk, empty or not
    }
    // The merge may launch now; it waits for this grid to complete.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

    // The warp's rows: q's A fragments (rows past S rep zero) in registers
    // for the whole walk, and each lane row's visibility limit.
    const int r0 = wrow + gid, r1 = r0 + 8;
    const bool ok0 = r0 < nrows, ok1 = r1 < nrows;
    uint32_t qa[KD][4];
    {
        const __nv_bfloat16* q0 = q + q_index(ok0 ? r0 : 0) * D + 2 * tig;
        const __nv_bfloat16* q1 = q + q_index(ok1 ? r1 : 0) * D + 2 * tig;
        auto ld = [](const __nv_bfloat16* p, bool ok) {
            return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
        };
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            qa[kk][0] = ld(q0 + 16 * kk, ok0);
            qa[kk][1] = ld(q1 + 16 * kk, ok1);
            qa[kk][2] = ld(q0 + 16 * kk + 8, ok0);
            qa[kk][3] = ld(q1 + 16 * kk + 8, ok1);
        }
    }
    const int j0 = min(r0 / rep, S - 1), j1 = min(r1 / rep, S - 1);
    int lim[2];
    const unsigned char* mrow[2] = {nullptr, nullptr};
    if (!blk) {
        lim[0] = lim[1] = len - 1;
    } else if (mask == nullptr) {
        lim[0] = j0;
        lim[1] = j1;
    } else {
        lim[0] = lim[1] = S - 1;
        mrow[0] = mask + ((size_t)b * S + j0) * S;
        mrow[1] = mask + ((size_t)b * S + j1) * S;
    }
    // The warp's last position (-1: it holds no row).
    const int wlast = wrow < nrows ? min(wrow + 15, nrows - 1) / rep : -1;

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int c = 0; c < nch; ++c) {
        cp_async_wait<VSTAGES - 2>();  // chunk c has landed (this thread's)
        __syncthreads();               // ... everyone's; slot c - 1 is free
        if (c + VSTAGES - 1 < nch) issue(c + VSTAGES - 1);
        cp_async_commit();
        const int x0 = blk ? VCH * c : t_begin + VCH * c;
        if (blk) {
            // Under the chain mask a warp skips chunks wholly past its rows.
            const uint16_t* kt = ring16 + (c % VSTAGES) * 2 * TILE;
            if (wlast < 0 || (mask == nullptr && x0 > wlast)) continue;
            attend_chunk<D, 2>(kt, kt + TILE, nullptr, nullptr, qa, o, m, l,
                               lane, true, x0, lim, mrow, scale_log2);
        } else if constexpr (I8) {
            // Convert the raw chunk into the bf16 tile once for the block;
            // the scales stay in the slot until it is refilled.
            const unsigned char* raw = smem + (c % VSTAGES) * V::I8_SLOT;
            uint16_t* const cvt = reinterpret_cast<uint16_t*>(
                smem + V::I8_CVT);
            constexpr int UPR = D / 16;            // 16 B units a raw row
            for (int u = tid; u < 2 * VCH * UPR; u += THREADS) {
                const int t = u / UPR, pc = u % UPR;   // t < 2 VCH: k, v
                const uint4 w = *reinterpret_cast<const uint4*>(
                    raw + t * D + pc * 16);
                uint32_t h[8];
                i8x4_to_bf16x4(w.x, h[0], h[1]);
                i8x4_to_bf16x4(w.y, h[2], h[3]);
                i8x4_to_bf16x4(w.z, h[4], h[5]);
                i8x4_to_bf16x4(w.w, h[6], h[7]);
                uint16_t* dst = cvt + (t / VCH) * TILE + (t % VCH) * RS
                                + pc * 16;
                *reinterpret_cast<uint4*>(dst) =
                    make_uint4(h[0], h[1], h[2], h[3]);
                *reinterpret_cast<uint4*>(dst + 8) =
                    make_uint4(h[4], h[5], h[6], h[7]);
            }
            __syncthreads();
            if (wlast < 0) continue;
            const float* sc = reinterpret_cast<const float*>(
                raw + 2 * VCH * D);
            attend_chunk<D, 1>(cvt, cvt + TILE, sc, sc + VCH, qa, o, m, l,
                               lane, x0 + VCH > len, x0, lim, mrow,
                               scale_log2);
        } else {
            const uint16_t* kt = ring16 + (c % VSTAGES) * 2 * TILE;
            if (wlast < 0) continue;
            attend_chunk<D, 0>(kt, kt + TILE, nullptr, nullptr, qa, o, m, l,
                               lane, x0 + VCH > len, x0, lim, mrow,
                               scale_log2);
        }
    }

    // The rows' partials, unnormalised, at partial index sp.
    l[0] = quad_sum(l[0]);                         // the lanes' shares
    l[1] = quad_sum(l[1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (!(h ? ok1 : ok0)) continue;
        const size_t wi = q_index(h ? r1 : r0) * P + sp;
        float* acc = ws_acc + wi * D + 2 * tig;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<float2*>(acc + 8 * n) =
                make_float2(o[n][2 * h], o[n][2 * h + 1]);
        if (tig == 0) {
            ws_ml[wi * 2] = m[h];
            ws_ml[wi * 2 + 1] = l[h];
        }
    }
}

// Verify mode's merge: for each (row, position, head), the live window
// slices in slice order, then the block's partial (index P - 1), then the
// division. One warp a (row, position, head), D / 32 elements a lane.
template <int D>
__global__ void __launch_bounds__(THREADS)
paged_verify_merge_kernel(const int* __restrict__ lengths,
                          const float* __restrict__ ws_acc,
                          const float* __restrict__ ws_ml,
                          __nv_bfloat16* __restrict__ out, int nrows,
                          int SHq, int P, int window, int slice)
{
    constexpr int E = D / 32;
    const int row = blockIdx.x * NW + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= nrows) return;
    const int live = (min(lengths[row / SHq], window) + slice - 1) / slice;
    // The split grid's workspace is complete and visible past this point.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const float* ml = ws_ml + (size_t)row * P * 2;
    const float* acc = ws_acc + (size_t)row * P * D + lane * E;
    float mx = ml[2 * (P - 1)];
    for (int sp = 0; sp < live; ++sp) mx = fmaxf(mx, ml[2 * sp]);
    float den = 0.f, num[E];
#pragma unroll
    for (int e = 0; e < E; ++e) num[e] = 0.f;
    auto take = [&](int sp) {
        const float f = exp2f(ml[2 * sp] - mx);
        den += ml[2 * sp + 1] * f;
        float a[E];
        if constexpr (E == 4) {
            const float4 v = *reinterpret_cast<const float4*>(acc + sp * D);
            a[0] = v.x;
            a[1] = v.y;
            a[2] = v.z;
            a[3] = v.w;
        } else if constexpr (E == 2) {
            const float2 v = *reinterpret_cast<const float2*>(acc + sp * D);
            a[0] = v.x;
            a[1] = v.y;
        } else {
            a[0] = acc[sp * D];
        }
#pragma unroll
        for (int e = 0; e < E; ++e) num[e] += a[e] * f;
    };
    for (int sp = 0; sp < live; ++sp) take(sp);
    take(P - 1);
    __nv_bfloat16* dst = out + (size_t)row * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = __float2bfloat16(num[e] / den);
}

// Above 48 KB a launch needs the opt-in, once per device and kernel.
template <typename K>
cudaError_t opt_in(K* kernel, int bytes, bool (&done)[MAX_DEVICES])
{
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (!done[dev]) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
        done[dev] = true;
    }
    return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_split(dim3 grid, cudaStream_t st, const void* q,
                         const void* kp, const void* vp, const void* ks,
                         const void* vs, const void* pt, int pt_stride,
                         const void* lengths, void* ws_acc, void* ws_ml,
                         int layer, int N, int ps, int ps_pad, int Hkv,
                         int rep, int pages, float scale_log2)
{
    static bool opted_in[MAX_DEVICES] = {};
    cudaError_t err = opt_in(paged_split_kernel<T, D>, Ring<T, D>::SMEM,
                             opted_in);
    if (err != cudaSuccess) return err;
    paged_split_kernel<T, D><<<grid, THREADS, Ring<T, D>::SMEM, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt), pt_stride,
        static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), layer, N, ps, ps_pad, Hkv, rep, pages,
        scale_log2);
    return cudaGetLastError();
}

// The decode modes' split kernel over the pool: one block per (slice, kv
// head, row).
cudaError_t launch_pool_walk(const void* q, const void* kp, const void* vp,
                             const void* ks, const void* vs, const void* pt,
                             int pt_stride, const void* lengths, void* ws_acc,
                             void* ws_ml, int B, int Hkv, int rep, int D,
                             int N, int ps, int ps_pad, int layer, int pages,
                             int splits, int quantized, cudaStream_t st,
                             float scale_log2)
{
    const dim3 grid(splits, Hkv, B);
#define PA_ARGS grid, st, q, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc, \
    ws_ml, layer, N, ps, ps_pad, Hkv, rep, pages, scale_log2
    if (quantized) {
        if (D == 32) return launch_split<int8_t, 32>(PA_ARGS);
        if (D == 64) return launch_split<int8_t, 64>(PA_ARGS);
        return launch_split<int8_t, 128>(PA_ARGS);
    }
    if (D == 32) return launch_split<__nv_bfloat16, 32>(PA_ARGS);
    if (D == 64) return launch_split<__nv_bfloat16, 64>(PA_ARGS);
    return launch_split<__nv_bfloat16, 128>(PA_ARGS);
#undef PA_ARGS
}

bool bad_geometry(int B, int Hq, int Hkv, int D, int ps, int pages,
                  int splits, int slice, int quantized, const void* ks,
                  const void* vs)
{
    const int rep = Hkv > 0 ? Hq / Hkv : 0;
    return rep < 1 || rep > MAX_REP || rep * Hkv != Hq || B < 1 || ps < 1
        || pages < 1 || (long long)splits * slice < (long long)pages * ps
        || (D != 32 && D != 64 && D != 128)
        || (quantized && (ks == nullptr || vs == nullptr));
}

// A programmatic dependent of the split kernel: the combine's blocks
// start while the split's last blocks run and wait (griddepcontrol.wait)
// for the split grid's completion and its writes.
template <typename... Params, typename... Args>
cudaError_t launch_combine(void (*kernel)(Params...), dim3 grid, int threads,
                           cudaStream_t st, Args... args)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
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
    if (bad_geometry(B, Hq, Hkv, D, ps, pages, splits, SLICE, quantized, ks,
                     vs))
        return (int)cudaErrorInvalidValue;
    const float scale_log2 = LOG2E / sqrtf((float)D);
    cudaError_t err = launch_pool_walk(
        q, kp, vp, ks, vs, pt, pt_stride, lengths, ws_acc, ws_ml, B, Hkv,
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

template <typename T, int D>
cudaError_t launch_verify(dim3 grid, cudaStream_t st, const void* q,
                          const void* kb, const void* vb, const void* mask,
                          const void* kp, const void* vp, const void* ks,
                          const void* vs, const void* pt, int pt_stride,
                          const void* lengths, void* ws_acc, void* ws_ml,
                          void* out, int B, int S, int Hkv, int rep, int N,
                          int ps, int ps_pad, int layer, int pages,
                          int splits, int slice, float scale_log2)
{
    static bool opted_in[MAX_DEVICES] = {};
    constexpr int smem = VSmem<D, sizeof(T) == 1>::BYTES;
    cudaError_t err = opt_in(paged_verify_kernel<T, D>, smem, opted_in);
    if (err != cudaSuccess) return err;
    paged_verify_kernel<T, D><<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(kb),
        static_cast<const __nv_bfloat16*>(vb),
        static_cast<const unsigned char*>(mask), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(pt), pt_stride,
        static_cast<const int*>(lengths), static_cast<float*>(ws_acc),
        static_cast<float*>(ws_ml), layer, N, ps, ps_pad, Hkv, rep, S, pages,
        slice, scale_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int nrows = B * S * Hkv * rep;
    return launch_combine(
        paged_verify_merge_kernel<D>, dim3((nrows + NW - 1) / NW), THREADS,
        st, static_cast<const int*>(lengths),
        static_cast<const float*>(ws_acc), static_cast<const float*>(ws_ml),
        static_cast<__nv_bfloat16*>(out), nrows, S * Hkv * rep, splits + 1,
        pages * ps, slice);
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
// in the pool (the block not counted); splits = ceil(pages * ps /
// paged_verify_slice_tokens(S)) window slices; ws_acc
// [B,S,Hq,splits+1,D] f32; ws_ml [B,S,Hq,splits+1,2] f32; out
// [B,S,Hq,D] bf16. 1 <= S <= MAX_S.
int paged_verify_launch(const void* q, const void* kb, const void* vb,
                        const void* mask, const void* kp, const void* vp,
                        const void* ks, const void* vs, const void* pt,
                        int pt_stride, const void* lengths, void* ws_acc,
                        void* ws_ml, void* out, int B, int S, int Hq, int Hkv,
                        int D, int N, int ps, int ps_pad, int layer,
                        int pages, int splits, int quantized, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int slice = verify_slice(S);
    if (kb == nullptr || vb == nullptr || S < 1 || S > MAX_S
            || bad_geometry(B, Hq, Hkv, D, ps, pages, splits, slice,
                            quantized, ks, vs)
            || (long long)(splits - 1) * slice >= (long long)pages * ps
            || splits + 1 > 65535 || (long long)B * Hkv > 65535
            || (long long)N * ps * Hkv > 0xffffffffLL
            || (long long)N * Hkv * ps_pad > 0xffffffffLL)
        return (int)cudaErrorInvalidValue;
    const float scale_log2 = LOG2E / sqrtf((float)D);
    const int rep = Hq / Hkv;
    const dim3 grid((S * rep + VQ - 1) / VQ, splits + 1, B * Hkv);
#define PV_ARGS grid, st, q, kb, vb, mask, kp, vp, ks, vs, pt, pt_stride, \
    lengths, ws_acc, ws_ml, out, B, S, Hkv, rep, N, ps, ps_pad, layer, \
    pages, splits, slice, scale_log2
    if (quantized) {
        if (D == 32) return (int)launch_verify<int8_t, 32>(PV_ARGS);
        if (D == 64) return (int)launch_verify<int8_t, 64>(PV_ARGS);
        return (int)launch_verify<int8_t, 128>(PV_ARGS);
    }
    if (D == 32) return (int)launch_verify<__nv_bfloat16, 32>(PV_ARGS);
    if (D == 64) return (int)launch_verify<__nv_bfloat16, 64>(PV_ARGS);
    return (int)launch_verify<__nv_bfloat16, 128>(PV_ARGS);
#undef PV_ARGS
}

// The largest block verify mode takes (positions per row).
int paged_verify_max_s() { return MAX_S; }

// Verify mode's window slice at S block positions (tokens).
int paged_verify_slice_tokens(int S) { return verify_slice(S); }

// Verify mode's dynamic shared memory per block (bytes) for a pool type
// and head width, or -1 for an unsupported pair.
int paged_verify_smem(int quantized, int D)
{
    if (D == 32) return quantized ? VSmem<32, true>::BYTES
                                  : VSmem<32, false>::BYTES;
    if (D == 64) return quantized ? VSmem<64, true>::BYTES
                                  : VSmem<64, false>::BYTES;
    if (D == 128) return quantized ? VSmem<128, true>::BYTES
                                   : VSmem<128, false>::BYTES;
    return -1;
}

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
