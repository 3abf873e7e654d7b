// Hand-written Hopper kernel of the int8 matrix product.
//
// Replaces the Pallas TPU kernel int8_matmul
// (src/repro/kernels/int8_matmul.py:47, _kernel at :27) and computes
// the same function, bit for bit:
//
//   acc[i, j] = sum_k int32(x[i, k]) * int32(w[k, j])      (exact int32)
//   out[i, j] = float(acc[i, j]) * (x_scale[i] * w_scale[j])
//
// x [M, K] int8 and w [K, N] int8 are row-major, the scales float32.
// The epilogue keeps the Pallas kernel's order (int8_matmul.py:41-43):
// first scale = f32(x_scale[i]) * f32(w_scale[j]), then f32(acc) *
// scale, each product rounded on its own (__fmul_rn), the conversion
// rounded to nearest (__int2float_rn).  Integer sums are exact in any
// order, so the result does not depend on the tiling.  Unlike the
// Pallas wrapper, any M, N and K are taken: ragged rows, columns and a
// K tail are masked by index (zero-filled in shared memory).
//
// Design: one CTA computes a BM x BN output tile with int32
// accumulators in registers, walking K in BK = 64-byte steps.  Each
// step stages x's tile as [BM][BK] and w's tile transposed as [BN][BK]
// (K contiguous, the "col" operand layout of the tensor-core product),
// both in shared memory with rows padded to 80 bytes so the fragment
// reads are free of bank conflicts.  The transpose happens on the way
// in: a thread reads a 4 x 4 byte block of w (four 32-bit row loads)
// and writes it back as four 32-bit column words.  Each warp then runs
// mma.sync.m16n8k32 (s8 x s8 -> s32) over its sub-tile, two k32 steps
// per stage.  Two configurations: 128 x 128 tiles (8 warps, 64 x 32
// each) for prefill-sized M, and 16 x 32 tiles (2 warps) for M <= 64,
// so a decode batch still spreads over many CTAs.
//
// What bounds it on an H100: at prefill sizes the product is bound by
// the int8 tensor cores (2 M N K operations over 1979 TOP/s dense); at
// M = 16 by the bytes of w (K N over 3.35 TB/s).  This simple design
// leaves on the table: wgmma (the only path to the full int8 rate),
// TMA and a multi-stage cp.async pipeline (each stage here loads, syncs,
// then computes), a split of K for the decode shapes, and vector stores
// in the epilogue.
//
// The entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;           // K bytes per stage
constexpr int LDS = BK + 16;     // padded shared-memory row, bytes

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

// one 32-bit word of four consecutive int8 of a row, zero past `end`
__device__ __forceinline__ uint32_t load_word(const int8_t* row, int col,
                                              int end, bool aligned) {
    if (aligned && col + 4 <= end)
        return __ldg(reinterpret_cast<const uint32_t*>(row + col));
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j)
        if (col + j < end)
            v |= (uint32_t)(uint8_t)__ldg(row + col + j) << (8 * j);
    return v;
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
int8_matmul_kernel(const int8_t* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ xs,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int M, int N, int K) {
    constexpr int THREADS = WM * WN * 32;
    constexpr int MT = BM / WM / 16;   // m16 tiles per warp
    constexpr int NT = BN / WN / 8;    // n8 tiles per warp
    static_assert(MT >= 1 && NT >= 1, "warp tile too small");

    __shared__ __align__(16) int8_t As[BM * LDS];
    __shared__ __align__(16) int8_t Bs[BN * LDS];

    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;       // mma group / thread
    const int wm = (warp / WN) * (BM / WM);     // warp's row offset
    const int wn = (warp % WN) * (BN / WN);     // warp's column offset
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

    // 16-byte row loads of x need every row start aligned; 4-byte row
    // loads of w likewise
    const bool x_vec = (K % 16 == 0) &&
                       ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
    const bool w_vec = (N % 4 == 0) &&
                       ((reinterpret_cast<uintptr_t>(w) & 3) == 0);

    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

    for (int k0 = 0; k0 < K; k0 += BK) {
        // x tile -> As[m][k]: 16-byte chunks, zero past M and K
        for (int c = tid; c < BM * BK / 16; c += THREADS) {
            const int m = c / (BK / 16), kc = (c % (BK / 16)) * 16;
            const int row = m0 + m, col = k0 + kc;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (row < M) {
                const int8_t* src = x + (size_t)row * K;
                if (x_vec && col + 16 <= K) {
                    v = __ldg(reinterpret_cast<const uint4*>(src + col));
                } else {
                    v.x = load_word(src, col, K, false);
                    v.y = load_word(src, col + 4, K, false);
                    v.z = load_word(src, col + 8, K, false);
                    v.w = load_word(src, col + 12, K, false);
                }
            }
            *reinterpret_cast<uint4*>(As + m * LDS + kc) = v;
        }
        // w tile -> Bs[n][k]: 4 x 4 byte blocks read as four row words
        // (k, n..n+3) and written as four column words (n, k..k+3)
        for (int b = tid; b < (BK / 4) * (BN / 4); b += THREADS) {
            const int kb = (b % (BK / 4)) * 4, nb = (b / (BK / 4)) * 4;
            const int col = n0 + nb;
            uint32_t r[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int k = k0 + kb + i;
                r[i] = (k < K) ? load_word(w + (size_t)k * N, col, N, w_vec)
                               : 0u;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const uint32_t c = ((r[0] >> (8 * j)) & 0xffu)
                                   | (((r[1] >> (8 * j)) & 0xffu) << 8)
                                   | (((r[2] >> (8 * j)) & 0xffu) << 16)
                                   | (((r[3] >> (8 * j)) & 0xffu) << 24);
                *reinterpret_cast<uint32_t*>(Bs + (nb + j) * LDS + kb) = c;
            }
        }
        __syncthreads();

#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            uint32_t af[MT][4], bf[NT][2];
#pragma unroll
            for (int i = 0; i < MT; ++i) {
                const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + t * 4;
                af[i][0] = *reinterpret_cast<const uint32_t*>(p);
                af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
                af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
                af[i][3] = *reinterpret_cast<const uint32_t*>(
                    p + 8 * LDS + 16);
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int8_t* p = Bs + (wn + j * 8 + g) * LDS + kk + t * 4;
                bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
                bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
        }
        __syncthreads();
    }

    // epilogue, in the Pallas kernel's order: scale first, then acc
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = m0 + wm + i * 16 + g + 8 * h;
            if (row >= M) continue;
            const float sx = xs[row];
            float* orow = out + (size_t)row * N;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + wn + j * 8 + t * 2 + e;
                    if (col >= N) continue;
                    const float scale = __fmul_rn(sx, ws[col]);
                    orow[col] = __fmul_rn(
                        __int2float_rn(acc[i][j][2 * h + e]), scale);
                }
            }
        }
    }
}

template <int BM, int BN, int WM, int WN>
int launch(const int8_t* x, const int8_t* w, const float* xs,
           const float* ws, float* out, int M, int N, int K,
           cudaStream_t stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_matmul_kernel<BM, BN, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(
        x, w, xs, ws, out, M, N, K);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [M, K] int8, w [K, N] int8 (row-major), x_scale [M] and w_scale
// [N] float32 -> out [M, N] float32; M, N, K > 0
int pfdnn_int8_matmul(const void* x, const void* w, const void* x_scale,
                      const void* w_scale, void* out, int M, int N, int K,
                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    const int8_t* xp = static_cast<const int8_t*>(x);
    const int8_t* wp = static_cast<const int8_t*>(w);
    const float* xsp = static_cast<const float*>(x_scale);
    const float* wsp = static_cast<const float*>(w_scale);
    float* op = static_cast<float*>(out);
    if (M <= 64)
        return launch<16, 32, 1, 2>(xp, wp, xsp, wsp, op, M, N, K, s);
    if ((M + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;
    return launch<128, 128, 2, 4>(xp, wp, xsp, wsp, op, M, N, K, s);
}

}  // extern "C"
