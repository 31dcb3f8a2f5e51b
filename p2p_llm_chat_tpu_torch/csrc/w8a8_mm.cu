// Kernel E: w8a8 matmul on int8 tensor cores for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces tools/mm_micro.py w8a8_matmul (its pl.pallas_call at :64, body
// _w8a8_kernel): given the activations already quantized per row
// (xq [M, H] int8 with f32 row scales xs [M]; the quantization is XLA
// outside the pallas_call in the reference, torch ops here) and the
// weight q [H, O] int8 with f32 column scales s [O],
//   out[m, n] = bf16((float(sum_k xq[m, k] q[k, n]) * s[n]) * xs[m])
// with the sum in int32 (exact) and the epilogue's two f32 products in
// that order, each rounded (__fmul_rn: nothing for nvcc to contract), so
// the result is bitwise the plain version's.
//
// Bound on an H100 SXM at the decode shape (M = 32): the weight read, one
// byte per element (H * O bytes at 3.35 TB/s); 2*M*H*O int8 operations
// are far below the 1,979 TOP/s of the int8 tensor cores.
//
// Design:
// - mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: a block owns a
//   32 x 128 output tile (4 warps, each 32 rows x 32 columns = 2 x 4 mma
//   tiles, 32 int32 accumulators per thread) and walks H in 64-deep
//   tiles;
// - the tensor core takes B K-major ("col"), but the weight is [H, O]
//   with O contiguous (the QTensor layout of the reference, kept for
//   bitwise parity), and ldmatrix.trans moves 16-bit elements only. So
//   each thread loads a 4 (k) x 16 (n) block of the weight with 16-byte
//   loads, transposes it as four 4 x 4 byte blocks with byte permutes
//   (__byte_perm, PRMT), and stores 32-bit words of 4 consecutive k per
//   column into shared memory; the weight in device memory is never
//   re-laid;
// - shared rows are padded to 20 words, so the fragment loads of a warp
//   (8 rows x 4 words) hit 32 distinct banks;
// - the next tile's global loads are issued into registers before the
//   current tile's mma, so they overlap;
// - split-K over H (ops/quant_mm.split_plan) fills the SMs at small O:
//   each split writes int32 partial sums, and a reduce kernel adds them
//   (integer sums: the result does not depend on the split) and applies
//   the epilogue. Ragged M, H and O are masked (zero-filled tiles,
//   guarded stores); the byte-wise loader serves an O or H that is not a
//   multiple of 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr int STRIDE = BK / 4 + 4;   // padded shared row, in 32-bit words

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

__device__ __forceinline__ __nv_bfloat16 epilogue(int acc, float s, float xs)
{
    return __float2bfloat16(__fmul_rn(__fmul_rn(__int2float_rn(acc), s), xs));
}

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
            const int8_t* __restrict__ q, const float* __restrict__ s,
            __nv_bfloat16* __restrict__ out, int* __restrict__ ws, int M,
            int H, int O, int per)
{
    __shared__ uint32_t As[BM][STRIDE];   // [m][k / 4]
    __shared__ uint32_t Bs[BN][STRIDE];   // [n][k / 4]: K-major columns

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int g = lane >> 2;        // groupID
    const int t = lane & 3;         // thread in group
    const int n0 = blockIdx.x * BN;
    const int m0 = blockIdx.y * BM;
    const int sp = blockIdx.z;
    const int nkt = (H + BK - 1) / BK;
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
        const int k0 = kt * BK;
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

template <bool VA, bool VB>
void launch_main(dim3 grid, cudaStream_t st, const void* xq, const void* xs,
                 const void* q, const void* s, void* out, void* ws, int M,
                 int H, int O, int per)
{
    w8a8_kernel<VA, VB><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), static_cast<int*>(ws), M, H, O,
        per);
}

}  // namespace

extern "C" {

// xq [M, H] int8, xs [M] f32, q [H, O] int8, s [O] f32 (all contiguous),
// out [M, O] bf16; ws [splits, M, O] int32 when splits > 1 (else unused).
// vec_a: H % 16 == 0 and xq 16-byte aligned; vec_b: O % 16 == 0 and q
// 16-byte aligned. The H tiles [sp*per, (sp+1)*per) belong to split sp.
int w8a8_launch(const void* xq, const void* xs, const void* q, const void* s,
                void* out, void* ws, int M, int H, int O, int splits,
                int per, int vec_a, int vec_b, void* stream)
{
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (M < 1 || H < 1 || O < 1 || splits < 1 || per < 1
            || (long long)splits * per * BK < H
            || (splits > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;
    dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM, splits);
    if (vec_a && vec_b)
        launch_main<true, true>(grid, st, xq, xs, q, s, out, ws, M, H, O, per);
    else if (vec_a)
        launch_main<true, false>(grid, st, xq, xs, q, s, out, ws, M, H, O, per);
    else if (vec_b)
        launch_main<false, true>(grid, st, xq, xs, q, s, out, ws, M, H, O, per);
    else
        launch_main<false, false>(grid, st, xq, xs, q, s, out, ws, M, H, O, per);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    const size_t total = (size_t)M * O;
    w8a8_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const int*>(ws), static_cast<const float*>(xs),
        static_cast<const float*>(s), static_cast<__nv_bfloat16*>(out), M, O,
        splits);
    return (int)cudaGetLastError();
}

const char* w8a8_error_string(int code)
{
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
