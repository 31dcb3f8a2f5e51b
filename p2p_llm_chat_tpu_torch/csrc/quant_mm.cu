// Kernel A: w8a16 GEMM on bf16 tensor cores for Hopper (sm_90a), plain C
// interface for ctypes.
//
//   out[M, O] bf16 = (x[M, H] bf16 . q[H, O] int8) * s[O] f32
//
// Replaces the Pallas kernels of p2p_llm_chat_tpu/ops/quant_mm.py:
// quant_matmul_stacked (bodies _qmm_kernel_1d_stacked / _qmm_kernel_2d_stacked)
// and quant_matmul (bodies _qmm_kernel_1d / _qmm_kernel). The stacked and
// 2-D forms are one entry point: the wrapper passes q and s already offset
// to the layer (a byte offset of layer*H*O), so no per-layer slice copy is
// ever made. A second entry point, qmm_experts_launch, replaces
// quant_matmul_experts_stacked (body _qmm_kernel_experts_stacked): the
// same kernel over a batch (expert) index, out[e] = x[e] . q[e] * s[e]
// with x [NE, C, H], q [NE, H, O] and s [NE, 1, O] at the layer's offset
// of an [L, NE, H, O] pool. A dense launch is batch 1.
//
// Exactness: an int8 value is exact in bf16 (8 significant bits) and a
// bf16 x bf16 product is exact in f32, so mma.sync bf16 -> f32 on
// (x, bf16(q)) computes the plain version's f32 sum up to summation order;
// the per-column scale is applied once, after the sum.
//
// Bound on an H100 SXM: at decode shapes (M <= 32) the int8 weight stream
// (H*O bytes over 3.35 TB/s; llama3.1-8b wgu 117 MB -> 35 us). At a
// 256-row prefill chunk, operations: 2*M*H*O over 989 TFLOP/s (llama3.1-8b,
// 32 layers: 3.6 ms), about 1.7x the weight stream. What holds this design
// below that: mma.sync (not wgmma), the shared-memory traffic of the
// conversion pass and of ldmatrix, and the split-K partials' round trip.
//
// Design (mma.sync with a cp.async ring; wgmma and TMA are later work):
// - a block owns a BM x 128 output tile: BM = 16 (4 warps, each 16 x 32)
//   for M <= 16, BM = 64 (8 warps, each 32 x 32) for M <= 64, else
//   BM = 128 (8 warps, each 64 x 32), so a 256-row chunk streams each
//   weight byte twice (from device memory or L2), not 16 times;
// - the block walks its share of H in BK = 64 steps through a shared-
//   memory ring (4 stages; 3 at BM = 128, to keep two blocks on an SM)
//   filled by 16-byte cp.async.cg copies of the x tile [BM, 64] bf16 and
//   the weight tile [64, 128] int8, several tiles ahead of the one being
//   multiplied (commit_group / wait_group). Ragged edges are zero-filled
//   through cp.async's source size; where 16-byte alignment fails (H not
//   a multiple of 8 or x unaligned; O not a multiple of 16 or q
//   unaligned) the same stage is filled by plain masked loads instead;
// - the B operand, route (a): each arrived int8 stage is converted once to
//   a bf16 [64, 128+8] shared tile (the +8 pad makes every ldmatrix
//   conflict-free), and B fragments come from ldmatrix.x4.trans; A
//   fragments from ldmatrix.x4 on the padded x rows. The conversion is an
//   exact integer trick (i8x4_to_bf16x4), no int->float instruction. Two
//   bf16 tiles alternate: tile k+1 is converted while tile k is
//   multiplied, so one barrier per K step serves both;
// - mma.sync.m16n8k16 bf16 with f32 accumulators; the K order (64-wide
//   tiles, 16-wide steps, ascending) never depends on M or on BM, and the
//   split-K plan (ops/quant_mm.split_plan) depends on the weight's shape,
//   the batch and the card only, so a row's result does not depend on how
//   many rows share its call;
// - split-K over H fills the SMs: each split writes f32 partials to a
//   workspace, and qmm_reduce sums them in a fixed order (no atomics, so
//   reruns are bitwise identical) and applies the scale;
// - the expert grid puts (expert, split) on blockIdx.z. Every expert's
//   weight is streamed whatever its bucket holds (the reference's dropless
//   decode design).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;          // output columns per block
constexpr int BK = 64;           // contraction step (ops/quant_mm._BK)
constexpr int XS = BK + 8;       // x row stride in halves (144 B)
constexpr int WS = BN + 8;       // bf16 weight row stride in halves (272 B)

// Per row tile: warps along M and N, and the depth of the cp.async ring.
template <int BM> struct Tile;
template <> struct Tile<16> { static constexpr int WM = 1, WN = 4, STAGES = 4; };
template <> struct Tile<64> { static constexpr int WM = 2, WN = 4, STAGES = 4; };
template <> struct Tile<128> { static constexpr int WM = 2, WN = 4, STAGES = 3; };

// The ring, then two bf16 weight tiles (one converted while the other is
// multiplied).
template <int BM>
constexpr int smem_bytes()
{
    return Tile<BM>::STAGES * (BM * XS * 2 + BK * BN) + 2 * BK * WS * 2;
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

// Four int8 values (byte i of w = element i) as four exact bf16 (lo holds
// elements 0, 1; hi elements 2, 3; the lower element in the low half).
// u = v + 128 in [0, 255] is placed under the exponent of 2^23, so the
// float is 2^23 + u exactly; subtracting 2^23 + 128 leaves v exactly, and
// a float holding an integer of at most 8 significant bits (|v| <= 128)
// has its low 16 bits zero, so its top half is v in bf16 — for all 256
// values (chip_smoke's kernel_a phase checks each).
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

// mma.sync m16n8k16 fragment layout (lane = 4 g + t):
//   A (16x16, row): a0 (g, 2t..+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                   a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..+1, n g), b1 (k 2t+8..+1, n g)
//   C (16x8):       c0,c1 (g, 2t..+1), c2,c3 (g+8, 2t..+1)
// VEC_X: H % 8 == 0 and x 16-byte aligned; VEC_W: O % 16 == 0 and q
// 16-byte aligned — each 16-byte chunk of a row then lies wholly inside or
// wholly outside the matrix.
template <int BM, bool VEC_X, bool VEC_W>
__global__ void __launch_bounds__(32 * Tile<BM>::WM * Tile<BM>::WN)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, __nv_bfloat16* __restrict__ out,
           float* __restrict__ ws, int M, int H, int O, int splits,
           int ktiles_per_split)
{
    constexpr int WN = Tile<BM>::WN;
    constexpr int STAGES = Tile<BM>::STAGES;
    constexpr int THREADS = 32 * Tile<BM>::WM * WN;
    constexpr int TM = BM / Tile<BM>::WM;     // warp tile rows
    constexpr int TN = BN / WN;               // warp tile columns (32)
    constexpr int MT = TM / 16, NT = TN / 8;
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* xs = reinterpret_cast<uint16_t*>(smem);        // [STAGES][BM][XS]
    int8_t* wq = reinterpret_cast<int8_t*>(smem + STAGES * BM * XS * 2);
    uint16_t* wb = reinterpret_cast<uint16_t*>(              // [2][BK][WS]
        smem + STAGES * (BM * XS * 2 + BK * BN));

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int wm = warp / WN, wn = warp % WN;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;
    const int b = blockIdx.z / splits;     // batch (expert) index
    const int sp = blockIdx.z % splits;
    const uint16_t* xb = reinterpret_cast<const uint16_t*>(x) + (size_t)b * M * H;
    q += (size_t)b * H * O;
    s += (size_t)b * O;
    out += (size_t)b * M * O;
    const int nkt = (H + BK - 1) / BK;
    const int kt0 = sp * ktiles_per_split;
    const int n = min(nkt, kt0 + ktiles_per_split) - kt0;

    auto load_tile = [&](int kt, int st) {
        const int k0 = kt * BK;
        uint16_t* xd = xs + st * BM * XS;
        for (int c = tid; c < BM * (BK / 8); c += THREADS) {
            const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
            const int m = m0 + r, k = k0 + kc;
            uint16_t* dst = xd + r * XS + kc;
            if (VEC_X) {
                const bool in = m < M && k < H;
                cp_async16(dst, in ? xb + (size_t)m * H + k : xb, in ? 16 : 0);
            } else {
                alignas(16) uint16_t v[8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    v[i] = (m < M && k + i < H) ? xb[(size_t)m * H + k + i] : 0;
                *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
            }
        }
        int8_t* wd = wq + st * BK * BN;
        for (int c = tid; c < BK * (BN / 16); c += THREADS) {
            const int r = c / (BN / 16), nc = (c % (BN / 16)) * 16;
            const int k = k0 + r, nn = n0 + nc;
            int8_t* dst = wd + r * BN + nc;
            if (VEC_W) {
                const bool in = k < H && nn < O;
                cp_async16(dst, in ? q + (size_t)k * O + nn : q, in ? 16 : 0);
            } else {
                alignas(16) int8_t v[16];
#pragma unroll
                for (int i = 0; i < 16; ++i)
                    v[i] = (k < H && nn + i < O) ? q[(size_t)k * O + nn + i]
                                                 : (int8_t)0;
                *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
            }
        }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    // The int8 weight of ring stage st as bf16 into weight tile buf.
    auto convert = [&](int st, int buf) {
        const int8_t* wsrc = wq + st * BK * BN;
        uint16_t* wdst = wb + buf * BK * WS;
        for (int c = tid; c < BK * BN / 8; c += THREADS) {
            const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
            const uint2 w = *reinterpret_cast<const uint2*>(wsrc + r * BN + nc);
            uint4 o;
            i8x4_to_bf16x4(w.x, o.x, o.y);
            i8x4_to_bf16x4(w.y, o.z, o.w);
            *reinterpret_cast<uint4*>(wdst + r * WS + nc) = o;
        }
    };

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n) load_tile(kt0 + i, i);
        cp_async_commit();
    }
    if (n > 0) {
        cp_async_wait<STAGES - 2>();           // tile 0
        __syncthreads();
        convert(0, 0);
    }
    for (int i = 0; i < n; ++i) {
        // Tile i+1 has landed (this thread's copies); after the barrier
        // everyone's have, tile i's bf16 weight (converted during
        // iteration i-1) is complete, and every warp is done with
        // iteration i-1 (its ring stage, which the next copy reuses, and
        // its bf16 weight tile, which the next conversion overwrites).
        cp_async_wait<STAGES - 3>();
        __syncthreads();
        if (i + STAGES - 1 < n)
            load_tile(kt0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);
        cp_async_commit();
        if (i + 1 < n) convert((i + 1) % STAGES, (i + 1) & 1);
        const uint16_t* xt = xs + (i % STAGES) * BM * XS;
        const uint16_t* wt = wb + (i & 1) * BK * WS;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            uint32_t a[MT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
                ldmatrix_x4(a[mt], xt + (wm * TM + mt * 16 + (lane & 15)) * XS
                                      + kk * 16 + (lane >> 4) * 8);
            uint32_t bf[NT][2];
#pragma unroll
            for (int p = 0; p < NT / 2; ++p) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, wt + (kk * 16 + (lane & 7)
                                           + ((lane >> 3) & 1) * 8) * WS
                                        + wn * TN + p * 16 + (lane >> 4) * 8);
                bf[2 * p][0] = r[0];
                bf[2 * p][1] = r[1];
                bf[2 * p + 1][0] = r[2];
                bf[2 * p + 1][1] = r[3];
            }
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
                    mma_bf16(acc[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + wm * TM + mt * 16 + g + 8 * h;
                const int nn = n0 + wn * TN + nt * 8 + 2 * t;
                if (m >= M) continue;
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    if (nn + j >= O) continue;
                    const float v = acc[mt][nt][2 * h + j];
                    if (splits > 1)
                        ws[((size_t)blockIdx.z * M + m) * O + nn + j] = v;
                    else
                        out[(size_t)m * O + nn + j] =
                            __float2bfloat16(__fmul_rn(v, s[nn + j]));
                }
            }
}

// Fixed-order sum of the split-K partials, then the per-channel scale.
// ws [batch, splits, M, O]; out [batch, M, O]; s [batch, O].
__global__ void qmm_reduce(const float* __restrict__ ws,
                           const float* __restrict__ s,
                           __nv_bfloat16* __restrict__ out, int batch, int M,
                           int O, int splits)
{
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t n = (size_t)M * O;
    if (i >= (size_t)batch * n) return;
    const size_t b = i / n, r = i % n;
    const float* w = ws + b * splits * n + r;
    float a = 0.f;
    for (int sp = 0; sp < splits; ++sp) a += w[(size_t)sp * n];
    out[i] = __float2bfloat16(__fmul_rn(a, s[b * O + r % O]));
}

template <int BM, bool VX, bool VW>
cudaError_t launch_main(dim3 grid, cudaStream_t st, const void* x,
                        const void* q, const void* s, void* out, float* ws,
                        int M, int H, int O, int splits, int per)
{
    constexpr int threads = 32 * Tile<BM>::WM * Tile<BM>::WN;
    constexpr int smem = smem_bytes<BM>();
    // Above 48 KB a launch needs the opt-in, once per device.
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
        err = cudaFuncSetAttribute(qmm_kernel<BM, VX, VW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return err;
        opted_in[dev] = true;
    }
    qmm_kernel<BM, VX, VW><<<grid, threads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), ws,
        M, H, O, splits, per);
    return cudaGetLastError();
}

template <int BM>
cudaError_t launch_bm(cudaStream_t st, const void* x, const void* q,
                      const void* s, void* out, float* ws, int batch, int M,
                      int H, int O, int splits, int per, bool vx, bool vw)
{
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
    if (vx && vw)
        return launch_main<BM, true, true>(grid, st, x, q, s, out, ws, M, H, O, splits, per);
    if (vx)
        return launch_main<BM, true, false>(grid, st, x, q, s, out, ws, M, H, O, splits, per);
    if (vw)
        return launch_main<BM, false, true>(grid, st, x, q, s, out, ws, M, H, O, splits, per);
    return launch_main<BM, false, false>(grid, st, x, q, s, out, ws, M, H, O, splits, per);
}

int launch(const void* x, const void* q, const void* s, void* out, void* ws,
           int batch, int M, int H, int O, int splits, int ktiles_per_split,
           int vec, void* stream)
{
    if (batch < 1 || M < 1 || H < 1 || O < 1 || splits < 1
            || ktiles_per_split < 1
            || (long long)splits * ktiles_per_split * BK < H
            || (splits > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const bool vx = H % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const bool vw = vec && O % 16 == 0
        && reinterpret_cast<uintptr_t>(q) % 16 == 0;
    float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
    cudaError_t err = M <= 16
        ? launch_bm<16>(st, x, q, s, out, part, batch, M, H, O, splits,
                        ktiles_per_split, vx, vw)
        : M <= 64
        ? launch_bm<64>(st, x, q, s, out, part, batch, M, H, O, splits,
                        ktiles_per_split, vx, vw)
        : launch_bm<128>(st, x, q, s, out, part, batch, M, H, O, splits,
                         ktiles_per_split, vx, vw);
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t n = (size_t)batch * M * O;
    const int threads = 256;
    qmm_reduce<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        part, static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), batch, M, O, splits);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M,H] bf16; q [H,O] int8 and s [O] f32 already offset to the layer;
// out [M,O] bf16; ws [splits,M,O] f32 (unused when splits == 1). vec: the
// wrapper's O % 16 == 0 and q 16-byte aligned (checked again here).
int qmm_launch(const void* x, const void* q, const void* s, void* out,
               void* ws, int M, int H, int O, int splits,
               int ktiles_per_split, int vec, void* stream)
{
    return launch(x, q, s, out, ws, 1, M, H, O, splits, ktiles_per_split,
                  vec, stream);
}

// x [NE, C, H] bf16; q [NE, H, O] int8 and s [NE, 1, O] f32 already offset
// to the layer; out [NE, C, O] bf16; ws [NE, splits, C, O] f32.
int qmm_experts_launch(const void* x, const void* q, const void* s,
                       void* out, void* ws, int batch, int C, int H, int O,
                       int splits, int ktiles_per_split, int vec,
                       void* stream)
{
    return launch(x, q, s, out, ws, batch, C, H, O, splits,
                  ktiles_per_split, vec, stream);
}

const char* qmm_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
