// Kernel C: w4a16 GEMM on bf16 tensor cores for Hopper (sm_90a), plain C
// interface for ctypes.
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
// Exactness: a nibble value in [-8, 7] is exact in bf16 and a bf16 x bf16
// product is exact in f32, so mma.sync bf16 -> f32 on (x, nib - 8) sums
// the plain version's products in f32 up to summation order; each group
// scale is applied in f32 after the sum over a segment that lies inside
// one group, as _qmm4_body folds it.
//
// Bound on an H100 SXM: at decode shapes (M <= 32) the packed weight
// stream — K/2*O bytes plus 4*ng*O of scales, read once — over 3.35 TB/s
// (one mixtral-8x7b int4 decode layer streams ~741 MB of experts: 0.22
// ms). At a 256-row chunk, operations: 2*M*K*O over 989 TFLOP/s. What
// holds this design below that: mma.sync (not wgmma), a 16-row tile half
// empty at M = 8, and the split-K partials' round trip.
//
// Two routes, chosen by plan_of from the shape alone (qmm4_plan reports
// the choice): the tensor-core kernel qmm4_mma_kernel where 64 divides
// both the group G and K/2 (every grouping the port's quantizer makes),
// else the CUDA-core kernel qmm4_fma_kernel.
//
// Design (mma.sync with a cp.async ring; wgmma and TMA are later work):
// - a block owns a BM x 128 output tile: BM = 16 (4 warps, each 16 x 32)
//   for M <= 16, BM = 64 (8 warps, each 32 x 32) for M <= 64, else BM =
//   128 (8 warps, each 64 x 32);
// - the block walks its share of the K/2 packed rows in BKP = 64-row
//   tiles through a shared-memory ring (4 stages; 3 at BM = 128) filled by
//   16-byte cp.async.cg copies of the packed tile [64, 128] int8 and of x's
//   two halves, columns [r0, r0+64) and [K/2+r0, K/2+r0+64), as bf16 [BM,
//   64] tiles. Each thread copies fixed chunks (addresses advance by a
//   tile), and x rows past M are zeroed once and never copied. Ragged
//   edges past K/2 and O are zero-filled through cp.async's source size
//   (the plan gives this route only K/2 a multiple of 64, but no read
//   relies on that): x is zero past M and K/2, so a zero weight byte
//   there (weight -8, finite) adds nothing. Where 16-byte alignment fails
//   (x unaligned; O not a multiple of 16 or q unaligned) the stage is
//   filled by plain masked loads;
// - the B operand: ldmatrix.x4.trans reads the packed bytes as
//   b16 pairs of columns, so each lane holds, for k rows 2t and 2t+1, the
//   bytes of columns 2j and 2j+1; shifts and masks put two nibbles under
//   the bf16 exponent of 128 (0x4300 | u = 128 + u exactly) and one packed
//   fma subtracts 136: B fragments straight from registers, no int->float
//   instruction and no bf16 tile in shared memory. One 32-bit register
//   gives the low- and high-half fragments of an even and an odd column,
//   so a warp's 32 columns are four n8 tiles of interleaved columns (each
//   thread ends with 4 adjacent columns per 16). (A bf16 shared tile per
//   stage, kernel A's route, was timed against this and lost: PERF.md);
// - the group scale, folded per 64-row tile: its low rows [r0, r0+64) lie
//   in group r0/G and its high rows in (K/2 + r0)/G. The low-half
//   products go to one mma accumulator, then acc = fma(p, s_lo, acc); the
//   high half the same with s_hi;
// - the K order (64-row tiles, 16-row steps, low half before high,
//   ascending) never depends on M or the row tile, and the split-K
//   plan (ops/quant_mm.split_plan, in 64-row tiles) depends on the
//   weight's shape, the batch and the card only, so a row's result does
//   not depend on how many rows share its call;
// - split-K writes f32 partials (already scaled) to a workspace and
//   qmm4_reduce sums them in a fixed order (no atomics: reruns are bitwise
//   identical);
// - the expert grid puts (expert, split) on blockIdx.z. Every expert's
//   weight is streamed whatever its bucket holds (the reference's dropless
//   decode design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;        // output columns per block
constexpr int BKP = 64;        // packed rows per ring stage (ops/quant_mm._BKP)
constexpr int QS = BN + 16;    // packed row stride in bytes (144: ldmatrix
                               // rows on distinct banks)
constexpr int XS = BKP + 8;    // x row stride in halves (144 B)

template <int BM> struct Tile;
template <> struct Tile<16> { static constexpr int WM = 1, WN = 4, STAGES = 4; };
template <> struct Tile<64> { static constexpr int WM = 2, WN = 4, STAGES = 4; };
template <> struct Tile<128> { static constexpr int WM = 2, WN = 4, STAGES = 3; };

// A ring stage: the packed tile [BKP][QS], then x's low and high halves
// [2][BM][XS] bf16.
template <int BM>
__host__ __device__ constexpr int stage_bytes()
{
    return BKP * QS + 2 * BM * XS * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy: `bytes` (0 or 16) from src, the rest of the
// 16 zero-filled. src must be 16-byte aligned (and valid even when bytes
// is 0).
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
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The nibbles in bits [0, 4) and [16, 20) of v, u0 and u1 in [0, 15], as
// the bf16 pair (u0 - 8, u1 - 8), low half first. 0x4300 | u is the bf16
// 128 + u exactly (under the exponent of 2^7 the 7-bit mantissa steps by
// 1), and 1 * (128 + u) + (-136) = u - 8 is exact in bf16 — for every byte
// (tests/test_torch_kernel_c_plan.py emulates it over all 256; chip_smoke's
// kernel_c phase checks it on the card).
__device__ __forceinline__ uint32_t nib2_bf16x2(uint32_t v)
{
    const uint32_t u = (v & 0x000F000Fu) | 0x43004300u;
    uint32_t r;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(r) : "r"(u), "r"(0x3F803F80u), "r"(0xC308C308u));
    return r;
}

// mma.sync m16n8k16 fragment layout (lane = 4 g + t):
//   A (16x16, row): a0 (g, 2t..+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..+1, n g), b1 (k 2t+8..+1, n g)
//   C (16x8):       c0,c1 (g, 2t..+1), c2,c3 (g+8, 2t..+1)
// The column of accumulator element c (0 or 1) of n8 tile nt, relative to
// the warp's first column: tile 2j + e holds columns 16 j + 2 n + e, so
// lane t's columns are 16 j + 4t .. 4t+3.
__device__ __forceinline__ int col_of(int nt, int c, int t)
{
    return 16 * (nt >> 1) + 4 * t + 2 * c + (nt & 1);
}

// VX: x 16-byte aligned (K/2 is a multiple of 16 on this route, so each
// 16-byte chunk of a row lies wholly inside or outside a half); VW: O %
// 16 == 0 and q 16-byte aligned. Runtime flags, uniform per launch.
template <int BM>
__global__ void __launch_bounds__(32 * Tile<BM>::WM * Tile<BM>::WN)
qmm4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ q, const float* __restrict__ s,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                int M, int K, int O, int ng, int splits,
                int ktiles_per_split, bool vx, bool vw)
{
    constexpr int WN = Tile<BM>::WN;
    constexpr int STAGES = Tile<BM>::STAGES;
    constexpr int THREADS = 32 * Tile<BM>::WM * WN;
    constexpr int TM = BM / Tile<BM>::WM;     // warp tile rows (16, 32, 64)
    constexpr int TN = BN / WN;               // warp tile columns (32)
    constexpr int MT = TM / 16, NT = TN / 8;
    constexpr int SB = stage_bytes<BM>();
    extern __shared__ __align__(16) unsigned char smem[];

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;
    const int b = blockIdx.z / splits;     // batch (expert) index
    const int sp = blockIdx.z % splits;
    const int Kh = K / 2;
    const int G = K / ng;
    const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + (size_t)b * M * K;
    q += (size_t)b * Kh * O;
    s += (size_t)b * ng * O;
    out += (size_t)b * M * O;
    const int nkt = (Kh + BKP - 1) / BKP;
    const int kt0 = sp * ktiles_per_split;
    const int n = min(nkt, kt0 + ktiles_per_split) - kt0;

    // The copy plan: each thread copies the same 16-byte column chunk of
    // packed rows qr, qr + QR, ... of a tile, and the same 8-column chunk
    // of x rows xr, xr + XR, ... of both halves. x rows past M are zeroed
    // once, below, and never copied (at decode half the 16-row tile).
    constexpr int QR = THREADS / (BN / 16);
    constexpr int XR = THREADS / (BKP / 8);
    static_assert(BKP % QR == 0 && BM % XR == 0, "copy plan");
    const int qr = tid / (BN / 16), qc = (tid % (BN / 16)) * 16;
    const bool qc_in = n0 + qc < O;
    const uint8_t* qsrc = q + (size_t)qr * O + n0 + qc;
    const int xr = tid / (BKP / 8), xc = (tid % (BKP / 8)) * 8;
    const int mrows = min(BM, M - m0);

    auto load_tile = [&](int kt, int st) {
        unsigned char* base = smem + st * SB;
        const int r0 = kt * BKP;
        const uint8_t* src = qsrc + (size_t)r0 * O;
#pragma unroll
        for (int j = 0; j < BKP / QR; ++j) {
            const int r = qr + j * QR;
            const uint8_t* from = src + (size_t)j * QR * O;
            unsigned char* dst = base + r * QS + qc;
            const bool rin = r0 + r < Kh;
            if (vw) {
                const bool in = rin && qc_in;
                cp_async16(dst, in ? from : q, in ? 16 : 0);
            } else {
                alignas(16) uint8_t v[16];
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    v[i] = (rin && n0 + qc + i < O) ? from[i] : 0;
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
            }
        }
        uint16_t* xd = reinterpret_cast<uint16_t*>(base + BKP * QS);
        const bool kin = r0 + xc < Kh;    // vx: a chunk is wholly in or out
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < BM / XR; ++j) {
                const int r = xr + j * XR;
                if (r >= mrows) continue;
                const uint16_t* from = xb + (size_t)(m0 + r) * K + h * Kh + r0 + xc;
                uint16_t* dst = xd + (h * BM + r) * XS + xc;
                if (vx) {
                    cp_async16(dst, kin ? from : xb, kin ? 16 : 0);
                } else {
                    alignas(16) uint16_t v[8];
#pragma unroll
                    for (int i = 0; i < 8; ++i)
                        v[i] = r0 + xc + i < Kh ? from[i] : 0;
                    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
                }
            }
    };
    if (mrows < BM) {
        for (int c = tid; c < STAGES * 2 * BM * (BKP / 8); c += THREADS) {
            const int st = c / (2 * BM * (BKP / 8));
            const int rc = c % (2 * BM * (BKP / 8));
            const int hr = rc / (BKP / 8);               // h * BM + row
            if (hr % BM < mrows) continue;
            uint16_t* xd = reinterpret_cast<uint16_t*>(smem + st * SB + BKP * QS);
            *reinterpret_cast<uint4*>(xd + hr * XS + (rc % (BKP / 8)) * 8) =
                make_uint4(0u, 0u, 0u, 0u);
        }
    }

    float acc[MT][NT][4], p[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    const int cw = n0 + wn * TN;               // the warp's first column

    // The group scales of the thread's 8 columns for the tile at packed row
    // r, low half then high half: loaded one tile ahead of the fold that
    // uses them, so the fold does not wait on L2.
    auto load_scales = [&](int r, float (&d)[2][NT][2]) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float* srow = s + (size_t)((h * Kh + r) / G) * O;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    const int o = cw + col_of(nt, c, t);
                    d[h][nt][c] = o < O ? __ldg(srow + o) : 0.f;
                }
        }
    };
    const int r_end = min(Kh, (kt0 + n) * BKP);   // past the split's rows
    float sc[2][NT][2], sn[2][NT][2] = {};
    if (n > 0) load_scales(kt0 * BKP, sc);

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n) load_tile(kt0 + i, i);
        cp_async_commit();
    }
    for (int i = 0; i < n; ++i) {
        // Tile i has landed; after the barrier every warp is done with
        // iteration i-1, whose ring stage the next copy reuses.
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (i + STAGES - 1 < n)
            load_tile(kt0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
        cp_async_commit();
        const unsigned char* qt = smem + (i % STAGES) * SB;
        const uint16_t* xt = reinterpret_cast<const uint16_t*>(qt + BKP * QS);
        const int r0 = (kt0 + i) * BKP;
        if (r0 + BKP < r_end) load_scales(r0 + BKP, sn);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) p[mt][nt][e] = 0.f;
#pragma unroll
            for (int k16 = 0; k16 < BKP; k16 += 16) {
                uint32_t a[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
                    ldmatrix_x4(a[mt], xt + (h * BM + wm * TM + mt * 16
                                             + (lane & 15)) * XS
                                          + k16 + (lane >> 4) * 8);
                uint32_t bf[NT][2];
#pragma unroll
                for (int jb = 0; jb < TN / 32; ++jb) {
                    // Matrices: rows k16+0..7 / +8..15 of byte columns
                    // 0..15, then of 16..31; r[i] byte order (k 2t, col
                    // 2j), (2t, 2j+1), (2t+1, 2j), (2t+1, 2j+1).
                    uint32_t r[4];
                    ldmatrix_x4_trans(r, qt + (k16 + (lane & 7)
                                               + ((lane >> 3) & 1) * 8) * QS
                                            + wn * TN + jb * 32
                                            + (lane >> 4) * 16);
                    const int sh = 4 * h;
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        uint32_t (&e)[2] = bf[4 * jb + 2 * j];
                        uint32_t (&o)[2] = bf[4 * jb + 2 * j + 1];
                        e[0] = nib2_bf16x2(r[2 * j] >> sh);
                        e[1] = nib2_bf16x2(r[2 * j + 1] >> sh);
                        o[0] = nib2_bf16x2(r[2 * j] >> (sh + 8));
                        o[1] = nib2_bf16x2(r[2 * j + 1] >> (sh + 8));
                    }
                }
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int nt = 0; nt < NT; ++nt)
                        mma_bf16(p[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        acc[mt][nt][e] = fmaf(p[mt][nt][e], sc[h][nt][e & 1],
                                              acc[mt][nt][e]);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                for (int c = 0; c < 2; ++c) sc[h][nt][c] = sn[h][nt][c];
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = m0 + wm * TM + mt * 16 + g + 8 * (e >> 1);
                const int o = cw + col_of(nt, e & 1, t);
                if (m >= M || o >= O) continue;
                if (ws != nullptr)
                    ws[((size_t)blockIdx.z * M + m) * O + o] = acc[mt][nt][e];
                else
                    out[(size_t)m * O + o] = __float2bfloat16(acc[mt][nt][e]);
            }
}

// Groupings the tensor-core kernel does not take (G or K/2 not a multiple
// of 64): f32 FMAs on the CUDA cores, a 16 x 128 tile per 256 threads in
// 32-row steps, each weight scaled per element. The split plan counts
// 64-row tiles, as for qmm4_mma_kernel. Masked loads; rows past K/2 hold
// 0x88 (weight 0).
constexpr int FM = 16;
constexpr int FKP = 32;
constexpr int FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
qmm4_fma_kernel(const __nv_bfloat16* __restrict__ x,
                const uint8_t* __restrict__ q, const float* __restrict__ s,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int M,
                int K, int O, int ng, int splits, int ktiles_per_split, int vec)
{
    __shared__ float xs_lo[FM][FKP];
    __shared__ float xs_hi[FM][FKP];
    __shared__ __align__(16) uint8_t qs[FKP][BN];

    const int tid = threadIdx.x;
    const int Kh = K / 2;
    const int G = K / ng;
    const int o0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * FM;
    const int b = blockIdx.z / splits;     // batch (expert) index
    const int split = blockIdx.z % splits;
    x += (size_t)b * M * K;
    q += (size_t)b * Kh * O;
    s += (size_t)b * ng * O;
    out += (size_t)b * M * O;
    const int nkt = (Kh + FKP - 1) / FKP;
    const int kt_begin = split * ktiles_per_split * (BKP / FKP);
    const int kt_end = min(nkt, kt_begin + ktiles_per_split * (BKP / FKP));

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
        const int k0 = kt * FKP;
        // Packed tile [FKP, BN]: 256 chunks of 16 bytes, one per thread.
        {
            const int kr = tid / (BN / 16);
            const int cc = (tid % (BN / 16)) * 16;
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
        // x tiles [FM, FKP] for both halves -> f32 (0 past K/2 or M).
        for (int c = tid; c < FM * FKP; c += FTHREADS) {
            const int mr = c / FKP;
            const int kc = c % FKP;
            const int m = m0 + mr;
            const int k = k0 + kc;
            const bool ok = m < M && k < Kh;
            const __nv_bfloat16* row = x + (size_t)m * K;
            xs_lo[mr][kc] = ok ? __bfloat162float(row[k]) : 0.f;
            xs_hi[mr][kc] = ok ? __bfloat162float(row[Kh + k]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(FKP, Kh - k0);
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
                const float lo = (float)((int)(byte & 15u) - 8) * s_lo[oc[c]];
                const float hi = (float)((int)(byte >> 4) - 8) * s_hi[oc[c]];
                acc[0][c] = fmaf(h0, hi, fmaf(a0, lo, acc[0][c]));
                acc[1][c] = fmaf(h1, hi, fmaf(a1, lo, acc[1][c]));
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

// The route and row tile of an M-row call on a (K, ng) weight, from the
// shape alone: 64-row segments on the tensor cores where 64 divides both
// G and K/2, in row tiles of 16, 64 or 128 picked from M; else the
// CUDA-core kernel (seg 0) in 16-row tiles.
struct Plan { int seg, bm; };

Plan plan_of(int M, int K, int ng)
{
    if ((K / ng) % BKP || (K / 2) % BKP) return {0, FM};
    return {BKP, M <= 16 ? 16 : M <= 64 ? 64 : 128};
}

bool shape_ok(int M, int K, int ng)
{
    return M >= 1 && K >= 2 && K % 2 == 0 && ng >= 1 && K % ng == 0;
}

template <int BM>
cudaError_t launch_mma(cudaStream_t st, const void* x, const void* q,
                       const void* s, void* out, float* ws, int batch, int M,
                       int K, int O, int ng, int splits, int per, bool vx,
                       bool vw)
{
    constexpr int threads = 32 * Tile<BM>::WM * Tile<BM>::WN;
    constexpr int smem = Tile<BM>::STAGES * stage_bytes<BM>();
    // Above 48 KB a launch needs the opt-in, once per device.
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(qmm4_mma_kernel<BM>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
    qmm4_mma_kernel<BM><<<grid, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), ws,
        M, K, O, ng, splits, per, vx, vw);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan of an M-row call on a (K, ng) weight: *seg 64 (tensor cores)
// or 0 (CUDA cores), from (K, ng) alone, and the row tile *bm.
int qmm4_plan(int M, int K, int ng, int* seg, int* bm)
{
    if (!shape_ok(M, K, ng)) return (int)cudaErrorInvalidValue;
    const Plan p = plan_of(M, K, ng);
    *seg = p.seg;
    *bm = p.bm;
    return 0;
}

// x [batch, M, K] bf16; q [batch, K/2, O] int8 and s [batch, ng, O] f32
// already offset to the layer; out [batch, M, O] bf16; ws [batch, splits,
// M, O] f32 (unused when splits == 1); ktiles_per_split counts 64-row
// packed tiles. vec: the wrapper's O % 16 == 0 and q 16-byte aligned
// (checked again here). seg: the segment qmm4_plan gave the wrapper for
// (K, ng); a launch whose seg is not its plan's is refused.
int qmm4_launch(const void* x, const void* q, const void* s, void* out,
                void* ws, int batch, int M, int K, int O, int ng, int splits,
                int ktiles_per_split, int vec, int seg, void* stream)
{
    if (batch < 1 || !shape_ok(M, K, ng) || O < 1 || splits < 1
            || ktiles_per_split < 1
            || (long long)splits * ktiles_per_split * BKP < K / 2
            || (splits > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;
    const Plan p = plan_of(M, K, ng);
    if (seg != p.seg) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const bool vw = vec && O % 16 == 0
        && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
    cudaError_t err;
    if (p.seg == 0) {
        dim3 grid((O + BN - 1) / BN, (M + FM - 1) / FM, batch * splits);
        qmm4_fma_kernel<<<grid, FTHREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const uint8_t*>(q), static_cast<const float*>(s),
            static_cast<__nv_bfloat16*>(out), part, M, K, O, ng, splits,
            ktiles_per_split, (int)vw);
        err = cudaGetLastError();
    } else {
        const bool vx = reinterpret_cast<uintptr_t>(x) % 16 == 0;
        auto launch = p.bm == 16 ? &launch_mma<16>
                    : p.bm == 64 ? &launch_mma<64> : &launch_mma<128>;
        err = launch(st, x, q, s, out, part, batch, M, K, O, ng, splits,
                     ktiles_per_split, vx, vw);
    }
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n = (size_t)batch * M * O;
    const int threads = 256;
    qmm4_reduce<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(out), batch, M, O, splits);
    return (int)cudaGetLastError();
}

const char* qmm4_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
