// Kernel E: w8a8 matmul on int8 tensor cores for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces tools/mm_micro.py w8a8_matmul (its pl.pallas_call at :64, body
// _w8a8_kernel): given the activations quantized per row (xq [M, H] int8
// with f32 row scales xs [M]) and the weight q [H, O] int8 with f32
// column scales s [O],
//   out[m, n] = bf16((float(sum_k xq[m, k] q[k, n]) * s[n]) * xs[m])
// with the sum in int32 (exact, so neither the tile nor the split changes
// a bit) and the epilogue's two f32 products in that order, each rounded
// (__fmul_rn: nothing for nvcc to contract): bitwise the plain version.
// The reference quantizes the rows in XLA around its pallas_call; here
// w8a8_quant_rows does it, chained to kernel E by a programmatic
// dependent launch (one C call launches both).
//
// Bound on an H100 SXM at the decode shape (M = 32): the weight read, one
// byte per element (H * O bytes at 3.35 TB/s); 2*M*H*O int8 operations
// are about a tenth of that time at 1,979 TOP/s.
//
// Two routes, chosen by shape and alignment (tools/mm_micro.w8a8_plan):
//
// TMA route (H % 16 == 0, O % 16 == 0, 16-byte-aligned xq and q): one
// producer warp streams [128 k, 128 n] weight tiles and the matching
// [32 m, 128 k] xq tiles with cp.async.bulk.tensor into a ring of stages
// in dynamic shared memory, each stage with a full / empty mbarrier pair
// (expect_tx on full); the tensor maps are encoded on the host
// (cuTensorMapEncodeTiled, looked up at run time: no -lcuda),
// 128-byte swizzled, and zero-fill the ragged edges. Four consumer warps
// own 32 columns each and run mma.sync.m16n8k32.s8 on the landed tiles:
// - the weight stays [H, O] (O contiguous: the QTensor layout of the
//   reference and kernel A), but the tensor core takes B K-major. Column
//   4g + j of a warp's 32 is column g of its n8-tile j, so one 32-bit
//   word of each of four k rows, put through one 4 x 4 byte transpose
//   (__byte_perm), is the b register of four n8-tiles at once;
// - under the 128-byte swizzle the four rows a warp reads at once are
//   4t + (i ^ (t & 2)) (the same rows of each thread, in another order),
//   so their 16-byte chunks land in eight distinct chunk pairs: no bank
//   conflict; the transpose's last permutes swap halves for t >= 2;
// - xq's fragments come with ldmatrix.x4 from the swizzled tile;
// - each thread's accumulators are 8 consecutive columns of a row, so the
//   epilogue stores 16 bytes at a time.
// - the producer warp also stages the tile's column and row scales in
//   shared memory while the ring fills, so no epilogue waits on a global
//   load.
// Split-K (for enough blocks in flight at small O) runs the splits of one
// output tile as one thread-block cluster (<= 8 portable, 16 with the
// non-portable size allowed). Rows r, r + splits, ... of the tile belong
// to cluster rank r: each block pushes every row of its int32 partial
// tile into the owner's shared memory (st.shared::cluster, no round
// trip), one cluster barrier, then each block sums the splits' partials
// of its rows and applies the epilogue. No workspace, no second launch.
// The producer issues the first stages' weight loads before
// griddepcontrol.wait, so when chained after w8a8_quant_rows the weight
// already streams while the rows are quantized; only xq's loads and the
// scales wait.
//
// What bounds it (cut-down copies timed on an H100, PERF.md): the weight
// stream and a fixed cost a launch; the transpose and the mma each cost
// under 1 us a call, the cluster reduction about 1.3 us, so the plan
// splits only until the blocks cover half the SMs.
//
// Ragged route (any other shape): the byte-loader kernel of the first
// port. Each thread loads a 4 (k) x 16 (n) block of the weight into
// registers (16-byte loads where O % 16 == 0 and q is aligned, byte loads
// otherwise; 16-byte loads of xq likewise, never both: that shape takes
// the TMA route),
// transposes it with the same byte permutes into K-major rows of shared
// memory (padded to 20 words), one tile ahead of the mma; split-K over H
// writes int32 partials to a workspace that w8a8_reduce adds and applies
// the epilogue to.

#include <cuda.h>   // CUtensorMap and its enums: types only, nothing to link
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;   // rows of a block (two m16 tiles)

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float scaled(int acc, float s, float xs)
{
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), s), xs);
}

__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float s, float xs)
{
    return __float2bfloat16(scaled(acc, s, xs));
}

// 4 x 4 byte transpose: w_i byte j = M[i][j]  ->  t_j byte i = M[i][j].
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t (&t)[4])
{
    const uint32_t x0 = __byte_perm(w0, w1, 0x5140);   // w0b0 w1b0 w0b1 w1b1
    const uint32_t x1 = __byte_perm(w0, w1, 0x7362);   // w0b2 w1b2 w0b3 w1b3
    const uint32_t y0 = __byte_perm(w2, w3, 0x5140);
    const uint32_t y1 = __byte_perm(w2, w3, 0x7362);
    t[0] = __byte_perm(x0, y0, 0x5410);
    t[1] = __byte_perm(x0, y0, 0x7632);
    t[2] = __byte_perm(x1, y1, 0x5410);
    t[3] = __byte_perm(x1, y1, 0x7632);
}

// Programmatic dependent launch: the dependent grid may start once every
// block of this one has called launch_dependents; wait returns once the
// prerequisite grid has completed and its writes are visible (a no-op in
// a grid launched without the dependency).
__device__ __forceinline__ void grid_dep_launch()
{
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dep_wait()
{
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Row quantization: xs[m] = amax / 127 (IEEE quotient; 1 where amax is 0),
// xq[m, k] = clamp(rint(x[m, k] / xs[m]), -127, 127) with a true division
// and rounding half to even, as jnp.round and torch.round. One block a row.

constexpr int Q_THREADS = 256;

__device__ __forceinline__ int8_t quant1(float v, float scale)
{
    const float r = rintf(__fdiv_rn(v, scale));
    return (int8_t)(int)fminf(fmaxf(r, -127.f), 127.f);
}

__global__ void __launch_bounds__(Q_THREADS)
w8a8_quant_rows(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ xq,
                float* __restrict__ xs, int H, int vec)
{
    grid_dep_launch();   // kernel E may start streaming its weight now
    __shared__ float red[Q_THREADS / 32];
    const int tid = threadIdx.x;
    const size_t row = (size_t)blockIdx.x * H;
    const __nv_bfloat16* xr = x + row;
    float amax = 0.f;
    if (vec) {
        for (int c = tid * 8; c < H; c += Q_THREADS * 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(h[i]);
                amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
            }
        }
    } else {
        for (int c = tid; c < H; c += Q_THREADS)
            amax = fmaxf(amax, fabsf(__bfloat162float(xr[c])));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if ((tid & 31) == 0) red[tid >> 5] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < Q_THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    if (tid == 0) xs[blockIdx.x] = scale;
    int8_t* qr = xq + row;
    if (vec) {
        for (int c = tid * 8; c < H; c += Q_THREADS * 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
            uint32_t w[2] = {0, 0};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(h[i]);
                const uint32_t lo = (uint8_t)quant1(f.x, scale);
                const uint32_t hi = (uint8_t)quant1(f.y, scale);
                w[i >> 1] |= (lo | (hi << 8)) << (16 * (i & 1));
            }
            *reinterpret_cast<uint2*>(qr + c) = make_uint2(w[0], w[1]);
        }
    } else {
        for (int c = tid; c < H; c += Q_THREADS)
            qr[c] = quant1(__bfloat162float(xr[c]), scale);
    }
}

// ---------------------------------------------------------------------------
// Ragged route.

constexpr int R_BN = 128;
constexpr int R_BK = 64;
constexpr int R_THREADS = 128;
constexpr int R_STRIDE = R_BK / 4 + 4;   // padded shared row, in 32-bit words

// Four bytes at p[0], p[1], p[2], p[3] (byte i of the word = p[i]), each
// masked by its own validity.
__device__ __forceinline__ uint32_t bytes4(const int8_t* p, int avail)
{
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (i < avail) w |= (uint32_t)(uint8_t)p[i] << (8 * i);
    return w;
}

// 16 bytes of row `row` from column `col` of a [rows, cols] int8 matrix
// as 4 words; zero past the edge. VEC: cols % 16 == 0 and the base is
// 16-byte aligned, so a chunk is wholly in or out.
template <bool VEC>
__device__ __forceinline__ void load16(const int8_t* __restrict__ base,
                                       int rows, int cols, int row, int col,
                                       uint32_t (&w)[4])
{
    if (row >= rows || col >= cols) {
        w[0] = w[1] = w[2] = w[3] = 0;
        return;
    }
    const int8_t* p = base + (size_t)row * cols + col;
    if (VEC) {
        const int4 v = *reinterpret_cast<const int4*>(p);
        w[0] = (uint32_t)v.x;
        w[1] = (uint32_t)v.y;
        w[2] = (uint32_t)v.z;
        w[3] = (uint32_t)v.w;
    } else {
        const int avail = cols - col;
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = bytes4(p + 4 * i, avail - 4 * i);
    }
}

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(R_THREADS)
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ q, const float* __restrict__ s,
            __nv_bfloat16* __restrict__ out, int* __restrict__ ws, int M,
            int H, int O, int per)
{
    __shared__ uint32_t As[BM][R_STRIDE];   // [m][k / 4]
    __shared__ uint32_t Bs[R_BN][R_STRIDE]; // [n][k / 4]: K-major columns

    grid_dep_wait();             // xq and xs may come from the previous grid
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;        // groupID
    const int t = lane & 3;         // thread in group
    const int n0 = blockIdx.x * R_BN;
    const int m0 = blockIdx.y * BM;
    const int sp = blockIdx.z;
    const int nkt = (H + R_BK - 1) / R_BK;
    const int kt0 = sp * per;
    const int kt1 = min(nkt, kt0 + per);

    // Loader roles: A, one 16-byte chunk of one row; B, a 4 (k) x 16 (n)
    // block (16 threads of a warp share a 32-byte span of one k row).
    const int a_row = tid >> 2;
    const int a_chunk = tid & 3;
    const int b_kq = tid & 15;
    const int b_nq = tid >> 4;

    uint32_t ra[4];
    uint32_t rb[4][4];
    auto load_tile = [&](int kt) {
        const int k0 = kt * R_BK;
        load16<VEC_A>(xq, M, H, m0 + a_row, k0 + a_chunk * 16, ra);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            load16<VEC_B>(q, H, O, k0 + b_kq * 4 + i, n0 + b_nq * 16, rb[i]);
    };

    int acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

    if (kt0 < kt1) load_tile(kt0);
    for (int kt = kt0; kt < kt1; ++kt) {
        __syncthreads();            // the previous tile's readers are done
#pragma unroll
        for (int i = 0; i < 4; ++i) As[a_row][a_chunk * 4 + i] = ra[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            uint32_t tr[4];
            transpose4(rb[0][c], rb[1][c], rb[2][c], rb[3][c], tr);
#pragma unroll
            for (int j = 0; j < 4; ++j) Bs[b_nq * 16 + c * 4 + j][b_kq] = tr[j];
        }
        __syncthreads();
        if (kt + 1 < kt1) load_tile(kt + 1);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
            const int kw = ks * 8;
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                a[mt][0] = As[mt * 16 + g][kw + t];
                a[mt][1] = As[mt * 16 + g + 8][kw + t];
                a[mt][2] = As[mt * 16 + g][kw + 4 + t];
                a[mt][3] = As[mt * 16 + g + 8][kw + 4 + t];
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                const int n = warp * 32 + nt * 8 + g;
                const uint32_t b0 = Bs[n][kw + t];
                const uint32_t b1 = Bs[n][kw + 4 + t];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
            }
        }
    }

    const bool split = gridDim.z > 1;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int m = m0 + mt * 16 + g + (i >= 2 ? 8 : 0);
                const int n = n0 + warp * 32 + nt * 8 + t * 2 + (i & 1);
                if (m >= M || n >= O) continue;
                if (split)
                    ws[((size_t)sp * M + m) * O + n] = acc[mt][nt][i];
                else
                    out[(size_t)m * O + n] = epilogue(acc[mt][nt][i], s[n], xs[m]);
            }
}

// Adds the splits' int32 partial sums in order and applies the epilogue.
__global__ void w8a8_reduce(const int* __restrict__ ws,
                            const float* __restrict__ xs,
                            const float* __restrict__ s,
                            __nv_bfloat16* __restrict__ out, int M, int O,
                            int splits)
{
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t total = (size_t)M * O;
    if (i >= total) return;
    int acc = 0;
    for (int sp = 0; sp < splits; ++sp) acc += ws[(size_t)sp * total + i];
    const int m = (int)(i / O);
    const int n = (int)(i % O);
    out[i] = epilogue(acc, s[n], xs[m]);
}

// ---------------------------------------------------------------------------
// TMA route.

constexpr int T_BN = 128;                      // one 128-byte box of q
constexpr int T_BK = 128;                      // one 128-byte box of xq
constexpr int T_THREADS = 160;                 // 4 consumer warps + producer
constexpr int B_BYTES = T_BK * T_BN;           // weight tile [k][n]
constexpr int A_BYTES = BM * T_BK;             // xq tile [m][k]
constexpr int STAGE_BYTES = B_BYTES + A_BYTES;
constexpr int MAX_STAGES = 3;                  // the plan's deepest ring
constexpr int MAX_CLUSTER = 16;
constexpr int PART_STRIDE = T_BN + 4;          // int32 words a received row

// Split-K: the block of cluster rank r owns the tile's rows r, r + splits,
// ...: ceil(32 / splits) of them, and receives each split's partial of
// them into [split][row / splits][PART_STRIDE] int32.
int recv_rows(int splits)
{
    return splits > 1 ? splits * ((BM + splits - 1) / splits) : 0;
}

size_t tma_smem_bytes(int stages, int splits)
{
    return 1024 + (size_t)stages * STAGE_BYTES
        + (size_t)recv_rows(splits) * PART_STRIDE * 4 + 16 * (size_t)stages;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed. A
// wait that outlasts every plausible copy (2^26 polls, each suspending
// for a while in try_wait) traps, so a broken ring fails the launch with
// an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    for (uint32_t polls = 0;; ++polls) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (polls == (1u << 26)) asm volatile("trap;\n");
    }
}

// One 2-D box of `map` at (c0 inner, c1 outer) into shared memory at
// `dst`, completing `bytes` of the transaction count of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(bar) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4])
{
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void cluster_arrive_relaxed()
{
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes into the shared memory of cluster block `rank` at the address
// `addr` has in this block.
__device__ __forceinline__ void st_cluster_v4(uint32_t addr, uint32_t rank,
                                              int4 v)
{
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(addr), "r"(rank));
    asm volatile("st.shared::cluster.v4.s32 [%0], {%1,%2,%3,%4};\n"
                 :: "r"(remote), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b)
{
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// Grid (splits, ceil(O / 128), ceil(M / 32)); a cluster of `splits`
// blocks along x when splits > 1. Block (sp, nt, mt) walks k tiles
// [sp * per, min(nkt, (sp + 1) * per)) of output tile (mt, nt).
__global__ void __launch_bounds__(T_THREADS)
w8a8_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_x,
                const float* __restrict__ xs, const float* __restrict__ s,
                __nv_bfloat16* __restrict__ out, int M, int O, int per,
                int nkt, int stages)
{
    extern __shared__ uint8_t smem_raw[];
    __shared__ float s_sc[T_BN];    // the tile's column scales
    __shared__ float s_xm[BM];      // and row scales
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;   // the swizzle's period
    const uint8_t* const sbase = smem_raw + (base - raw);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int split = blockIdx.x;
    const int splits = gridDim.x;
    const int n0 = blockIdx.y * T_BN;
    const int m0 = blockIdx.z * BM;
    const int kt0 = split * per;
    const int nk = min(nkt, kt0 + per) - kt0;   // >= 1 by the plan
    const int rpo = (BM + splits - 1) / splits; // rows each split owns
    const uint32_t recv = base + stages * STAGE_BYTES;
    const uint32_t full0 = recv + (splits > 1 ? splits * rpo * PART_STRIDE * 4 : 0);
    const uint32_t empty0 = full0 + 8 * stages;

    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(full0 + 8 * i, 1);
            mbar_init(empty0 + 8 * i, 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&tm_q)) : "memory");
        asm volatile("prefetch.tensormap [%0];\n"
                     :: "l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    }
    __syncthreads();
    // Every block of the cluster has started before any pushes into its
    // shared memory: this phase completes (wait) after the mainloop.
    if (splits > 1) cluster_arrive_relaxed();

    const int g = lane >> 2;        // groupID
    const int t = lane & 3;         // thread in group
    int acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0;

    if (warp == 4) {
        // Producer: the first stages' weight tiles go out before the wait
        // on the quantization grid (the weight does not depend on it);
        // then xq's, and the scales of the epilogue into shared memory.
        const int pre = min(nk, stages);
        if (lane == 0) {
            for (int i = 0; i < pre; ++i) {
                mbar_expect_tx(full0 + 8 * i, STAGE_BYTES);
                tma_load(base + i * STAGE_BYTES, &tm_q, n0, (kt0 + i) * T_BK,
                         full0 + 8 * i);
            }
        }
        __syncwarp();
        grid_dep_wait();
        if (lane == 0) {
            for (int i = 0; i < pre; ++i)
                tma_load(base + i * STAGE_BYTES + B_BYTES, &tm_x,
                         (kt0 + i) * T_BK, m0, full0 + 8 * i);
        }
#pragma unroll
        for (int c = 0; c < T_BN / 32; ++c) {
            const int n = n0 + c * 32 + lane;
            s_sc[c * 32 + lane] = n < O ? s[n] : 0.f;
        }
        s_xm[lane] = m0 + lane < M ? xs[m0 + lane] : 0.f;
        __syncwarp();
        if (lane == 0) {
            int st = 0;
            uint32_t ph = 0;        // parity of the empty phase to wait for
            for (int i = pre; i < nk; ++i) {
                mbar_wait(empty0 + 8 * st, ph);
                mbar_expect_tx(full0 + 8 * st, STAGE_BYTES);
                tma_load(base + st * STAGE_BYTES, &tm_q, n0, (kt0 + i) * T_BK,
                         full0 + 8 * st);
                tma_load(base + st * STAGE_BYTES + B_BYTES, &tm_x,
                         (kt0 + i) * T_BK, m0, full0 + 8 * st);
                if (++st == stages) {
                    st = 0;
                    ph ^= 1;
                }
            }
        }
        __syncwarp();
    } else {
        // Consumer warp w: columns 32 w .. +31 of the tile. Its b words:
        // word 8 w + g of rows 4t + (i ^ f), f = t & 2.
        const uint32_t f = t & 2;
        const uint32_t chunk = 2 * warp + (g >> 2);
        uint32_t boff[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t r = 4 * t + (i ^ f);
            boff[i] = r * 128 + ((chunk ^ (r & 7)) << 4) + (g & 3) * 4;
        }
        const uint32_t sel_lo = f ? 0x1054 : 0x5410;
        const uint32_t sel_hi = f ? 0x3276 : 0x7632;
        // ldmatrix.x4 rows: lanes 8q..8q+7 address matrix q = (rows +8 for
        // q odd, k bytes +16 for q >= 2).
        const uint32_t a_row = (((lane >> 3) & 1) * 8 + (lane & 7)) * 128;
        const uint32_t a_x = lane & 7;
        const uint32_t a_hi = lane >> 4;

        int st = 0;
        uint32_t ph = 0;
        for (int i = 0; i < nk; ++i) {
            mbar_wait(full0 + 8 * st, ph);
            const uint32_t sA = base + st * STAGE_BYTES + B_BYTES;
            const uint8_t* pB = sbase + st * STAGE_BYTES;
#pragma unroll
            for (int ks = 0; ks < T_BK / 32; ++ks) {
                uint32_t a[2][4];
                const uint32_t ach = ((2 * ks + a_hi) ^ a_x) << 4;
                ldsm_x4(sA + a_row + ach, a[0]);
                ldsm_x4(sA + 16 * 128 + a_row + ach, a[1]);
                uint32_t b[2][4];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint8_t* p = pB + (32 * ks + 16 * h) * 128;
                    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p + boff[0]);
                    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + boff[1]);
                    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + boff[2]);
                    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + boff[3]);
                    const uint32_t x0 = __byte_perm(w0, w1, 0x5140);
                    const uint32_t x1 = __byte_perm(w0, w1, 0x7362);
                    const uint32_t y0 = __byte_perm(w2, w3, 0x5140);
                    const uint32_t y1 = __byte_perm(w2, w3, 0x7362);
                    b[h][0] = __byte_perm(x0, y0, sel_lo);
                    b[h][1] = __byte_perm(x0, y0, sel_hi);
                    b[h][2] = __byte_perm(x1, y1, sel_lo);
                    b[h][3] = __byte_perm(x1, y1, sel_hi);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int mt = 0; mt < 2; ++mt)
                        mma_s8(acc[mt][j], a[mt], b[0][j], b[1][j]);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * st);
            if (++st == stages) {
                st = 0;
                ph ^= 1;
            }
        }
    }

    // Thread (g, t) of consumer warp w holds, for m tile mt and half hf,
    // row mt * 16 + hf * 8 + g at columns 32 w + 8t .. +7: n8-tile j's
    // column 2t (acc[..][j][2 hf]) is column 32 w + 8t + j, its column
    // 2t + 1 (acc[..][j][2 hf + 1]) column 32 w + 8t + 4 + j.
    __syncthreads();                // the scales are in shared memory
    if (splits == 1) {
        if (warp == 4) return;
        const int c0 = 32 * warp + 8 * t;
        if (n0 + c0 >= O) return;   // O % 16 == 0: all 8 columns or none
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = mt * 16 + hf * 8 + g;
                if (m0 + row >= M) continue;
                const float xm = s_xm[row];
                float v[8];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    v[j] = scaled(acc[mt][j][2 * hf], s_sc[c0 + j], xm);
                    v[4 + j] = scaled(acc[mt][j][2 * hf + 1], s_sc[c0 + 4 + j], xm);
                }
                uint4 o;
                o.x = pack_bf16(v[0], v[1]);
                o.y = pack_bf16(v[2], v[3]);
                o.z = pack_bf16(v[4], v[5]);
                o.w = pack_bf16(v[6], v[7]);
                *reinterpret_cast<uint4*>(out + (size_t)m0 * O + (size_t)row * O + n0 + c0) = o;
            }
        return;
    }

    // Split-K: push each row of the partial tile into its owner's shared
    // memory (fire and forget), one cluster barrier, then each block sums
    // the splits' partials of the rows it owns and applies the epilogue.
    cluster_wait();                 // every block of the cluster has started
    if (warp < 4) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = mt * 16 + hf * 8 + g;
                const uint32_t dst = recv + (uint32_t)(((split * rpo + row / splits)
                    * PART_STRIDE + 32 * warp + 8 * t) * 4);
                const int owner = row % splits;
                st_cluster_v4(dst, owner, make_int4(
                    acc[mt][0][2 * hf], acc[mt][1][2 * hf], acc[mt][2][2 * hf],
                    acc[mt][3][2 * hf]));
                st_cluster_v4(dst + 16, owner, make_int4(
                    acc[mt][0][2 * hf + 1], acc[mt][1][2 * hf + 1],
                    acc[mt][2][2 * hf + 1], acc[mt][3][2 * hf + 1]));
            }
    }
    cluster_arrive();
    cluster_wait();                 // every partial has landed
    const int* rbuf = reinterpret_cast<const int*>(smem_raw + (recv - raw));
    for (int u = tid; u < rpo * (T_BN / 4); u += T_THREADS) {
        const int lr = u / (T_BN / 4);
        const int c4 = (u % (T_BN / 4)) * 4;
        const int row = lr * splits + split;
        const int m = m0 + row;
        if (row >= BM || m >= M || n0 + c4 >= O) continue;
        int4 sum = make_int4(0, 0, 0, 0);
        for (int r = 0; r < splits; ++r) {
            const int4 v = *reinterpret_cast<const int4*>(
                rbuf + (r * rpo + lr) * PART_STRIDE + c4);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
        }
        const float xm = s_xm[row];
        uint2 o;
        o.x = pack_bf16(scaled(sum.x, s_sc[c4], xm),
                        scaled(sum.y, s_sc[c4 + 1], xm));
        o.y = pack_bf16(scaled(sum.z, s_sc[c4 + 2], xm),
                        scaled(sum.w, s_sc[c4 + 3], xm));
        *reinterpret_cast<uint2*>(out + (size_t)m * O + n0 + c4) = o;
    }
}

// ---------------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult qr = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &qr);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &qr);
#endif
        if (qr == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A [rows, cols] int8 matrix (cols contiguous) in boxes of
// [box_rows, 128 bytes], 128-byte swizzled, zero past its edges.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows)
{
    EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols};
    const cuuint32_t box[2] = {128u, (cuuint32_t)box_rows};
    const cuuint32_t estr[2] = {1u, 1u};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
              dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_quant(const void* x, void* xq, void* xs, int M, int H,
                         cudaStream_t st)
{
    const int vec = (H % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && reinterpret_cast<uintptr_t>(xq) % 8 == 0);
    w8a8_quant_rows<<<M, Q_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
        static_cast<float*>(xs), H, vec);
    return cudaGetLastError();
}

// Kernel E on the TMA route; `chained`: launched as a programmatic
// dependent of the grid just before it on the stream.
cudaError_t launch_tma(const void* xq, const void* xs, const void* q,
                       const void* s, void* out, int M, int H, int O,
                       int splits, int per, int stages, bool chained,
                       cudaStream_t st)
{
    const int nkt = (H + T_BK - 1) / T_BK;
    if (M < 1 || H % 16 || O % 16 || splits < 1 || splits > MAX_CLUSTER
            || per < 1 || stages < 1 || stages > MAX_STAGES
            || (long long)splits * per < nkt
            || (long long)(splits - 1) * per >= nkt
            || reinterpret_cast<uintptr_t>(xq) % 16
            || reinterpret_cast<uintptr_t>(q) % 16
            || reinterpret_cast<uintptr_t>(out) % 16)
        return cudaErrorInvalidValue;
    CUtensorMap tm_q, tm_x;
    if (!make_map(&tm_q, q, H, O, T_BK) || !make_map(&tm_x, xq, M, H, BM))
        return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, (O + T_BN - 1) / T_BN, (M + BM - 1) / BM);
    cfg.blockDim = dim3(T_THREADS);
    cfg.dynamicSmemBytes = tma_smem_bytes(stages, splits);
    cfg.stream = st;
    cudaLaunchAttribute attr[2];
    int na = 0;
    if (splits > 1) {
        attr[na].id = cudaLaunchAttributeClusterDimension;
        attr[na].val.clusterDim.x = splits;
        attr[na].val.clusterDim.y = 1;
        attr[na].val.clusterDim.z = 1;
        ++na;
    }
    if (chained) {
        attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[na].val.programmaticStreamSerializationAllowed = 1;
        ++na;
    }
    cfg.attrs = attr;
    cfg.numAttrs = na;
    return cudaLaunchKernelEx(&cfg, w8a8_tma_kernel, tm_q, tm_x,
                              static_cast<const float*>(xs),
                              static_cast<const float*>(s),
                              static_cast<__nv_bfloat16*>(out), M, O, per,
                              nkt, stages);
}

template <bool VA, bool VB>
cudaError_t launch_ragged_kernel(dim3 grid, bool chained, cudaStream_t st,
                                 const void* xq, const void* xs, const void* q,
                                 const void* s, void* out, void* ws, int M,
                                 int H, int O, int per)
{
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(R_THREADS);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = chained ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, w8a8_kernel<VA, VB>,
                              static_cast<const int8_t*>(xq),
                              static_cast<const float*>(xs),
                              static_cast<const int8_t*>(q),
                              static_cast<const float*>(s),
                              static_cast<__nv_bfloat16*>(out),
                              static_cast<int*>(ws), M, H, O, per);
}

cudaError_t launch_ragged(const void* xq, const void* xs, const void* q,
                          const void* s, void* out, void* ws, int M, int H,
                          int O, int splits, int per, int vec_a, int vec_b,
                          bool chained, cudaStream_t st)
{
    if (M < 1 || H < 1 || O < 1 || splits < 1 || per < 1
            || (long long)splits * per * R_BK < H
            || (splits > 1 && ws == nullptr)
            || (vec_a && vec_b))    // the TMA route's shapes
        return cudaErrorInvalidValue;
    dim3 grid((O + R_BN - 1) / R_BN, (M + BM - 1) / BM, splits);
    cudaError_t err;
    if (vec_a)
        err = launch_ragged_kernel<true, false>(grid, chained, st, xq, xs, q, s, out, ws, M, H, O, per);
    else if (vec_b)
        err = launch_ragged_kernel<false, true>(grid, chained, st, xq, xs, q, s, out, ws, M, H, O, per);
    else
        err = launch_ragged_kernel<false, false>(grid, chained, st, xq, xs, q, s, out, ws, M, H, O, per);
    if (err != cudaSuccess || splits == 1) return err;
    const size_t total = (size_t)M * O;
    w8a8_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const int*>(ws), static_cast<const float*>(xs),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), M, O,
        splits);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Once per process, before any launch or capture: the TMA kernel's shared
// memory limit (a ring of up to MAX_STAGES stages) and clusters of 16.
int w8a8_init(void)
{
    size_t most = 0;
    for (int sp = 1; sp <= MAX_CLUSTER; ++sp)
        most = most > tma_smem_bytes(MAX_STAGES, sp)
            ? most : tma_smem_bytes(MAX_STAGES, sp);
    cudaError_t err = cudaFuncSetAttribute(
        w8a8_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)most);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaFuncSetAttribute(
        w8a8_tma_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Kernel E alone on the ragged route. xq [M, H] int8, xs [M] f32, q [H, O]
// int8, s [O] f32 (all contiguous), out [M, O] bf16; ws [splits, M, O]
// int32 when splits > 1 (else unused). vec_a: H % 16 == 0 and xq 16-byte
// aligned; vec_b: O % 16 == 0 and q 16-byte aligned; not both (that shape
// takes the TMA route). The H tiles (of 64)
// [sp*per, (sp+1)*per) belong to split sp.
int w8a8_launch(const void* xq, const void* xs, const void* q, const void* s,
                void* out, void* ws, int M, int H, int O, int splits,
                int per, int vec_a, int vec_b, void* stream)
{
    return (int)launch_ragged(xq, xs, q, s, out, ws, M, H, O, splits, per,
                              vec_a, vec_b, false,
                              reinterpret_cast<cudaStream_t>(stream));
}

// Kernel E alone on the TMA route: operands as w8a8_launch (H % 16 == 0,
// O % 16 == 0, xq, q and out 16-byte aligned); splits blocks of one
// cluster per output tile over k tiles (of 128) [sp*per, (sp+1)*per),
// each non-empty; a ring of `stages` (at most 3).
int w8a8_tma_launch(const void* xq, const void* xs, const void* q,
                    const void* s, void* out, int M, int H, int O,
                    int splits, int per, int stages, void* stream)
{
    cudaError_t err = launch_tma(xq, xs, q, s, out, M, H, O, splits, per,
                                 stages, false,
                                 reinterpret_cast<cudaStream_t>(stream));
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The whole w8a8 matmul in one call: w8a8_quant_rows quantizes x [M, H]
// bf16 into xq and xs, then kernel E (route 1 TMA, 0 ragged; the other
// arguments as for that route's entry) launches as its programmatic
// dependent.
int w8a8_matmul_launch(const void* x, void* xq, void* xs, const void* q,
                       const void* s, void* out, void* ws, int M, int H,
                       int O, int route, int splits, int per, int stages,
                       int vec_a, int vec_b, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (M < 1 || H < 1 || O < 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = launch_quant(x, xq, xs, M, H, st);
    if (err != cudaSuccess) return (int)err;
    err = route == 1
        ? launch_tma(xq, xs, q, s, out, M, H, O, splits, per, stages, true, st)
        : launch_ragged(xq, xs, q, s, out, ws, M, H, O, splits, per, vec_a,
                        vec_b, true, st);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The row quantization alone: x [M, H] bf16 -> xq [M, H] int8, xs [M]
// f32 (the kernel w8a8_matmul_launch runs before kernel E).
int w8a8_quant_launch(const void* x, void* xq, void* xs, int M, int H,
                      void* stream)
{
    if (M < 1 || H < 1) return (int)cudaErrorInvalidValue;
    return (int)launch_quant(x, xq, xs, M, H,
                             reinterpret_cast<cudaStream_t>(stream));
}

const char* w8a8_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
