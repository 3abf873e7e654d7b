// Hand-written Hopper kernels of the int8 matrix product: two routes
// by shape, each bit for bit the Pallas kernel.
//
// Replaces the Pallas TPU kernel int8_matmul
// (src/repro/kernels/int8_matmul.py:47, _kernel at :27) and computes
// the same function:
//
//   acc[i, j] = sum_k int32(x[i, k]) * int32(w[k, j])      (exact int32)
//   out[i, j] = float(acc[i, j]) * (x_scale[i] * w_scale[j])
//
// x [M, K] int8 is row-major; w [K, N] int8 comes either row-major or
// K-major (the transpose of a contiguous [N, K], strides (1, K)); the
// scales are float32.  The epilogue keeps the Pallas kernel's order
// (int8_matmul.py:41-43): first scale = f32(x_scale[i]) * f32(w_scale[j]),
// then f32(acc) * scale, each product rounded on its own (__fmul_rn),
// the conversion rounded to nearest (__int2float_rn).  Integer sums are
// exact in any order, so the result does not depend on the tiling.
//
// What bounds it on an H100: at prefill sizes the int8 tensor cores
// (2 M N K operations over 1979 TOP/s dense); at M = 16 the bytes of w
// (K N over 3.35 TB/s).
//
// Route 1, wgmma (pfdnn_int8_matmul_wgmma): M > 64, K and N multiples
// of 16 bytes (TMA's rule for global strides), w K-major.  wgmma reads
// both 8-bit operands K-major from shared memory and has no transpose
// for them, so a row-major w first goes through transpose_kernel into
// a [N, K] scratch (pfdnn_int8_transpose; the wrapper counts it in the
// product's time).  One CTA of three warpgroups computes a 128 x BN
// output tile (BN = 256, or 128 when the 256-wide tiles would not fill
// one wave of the SMs):
//   * warpgroup 0 is the producer: it gives up registers (setmaxnreg
//     down to 40) and one thread keeps TMA loads in flight, a ring of
//     STAGES stages of an x tile [128 rows x 128 bytes] and a w tile
//     [BN rows x 128 bytes], both K-major under the 128-byte swizzle
//     (rows past M or N and bytes past K arrive as zeros), each stage
//     under a full and an empty mbarrier;
//   * warpgroups 1 and 2 are the consumers (setmaxnreg up to 232), 64
//     rows each: per stage four wgmma.mma_async.m64nBNk32.s32.s8.s8
//     with both operands from shared memory, int32 accumulators in
//     registers; wgmma.wait_group keeps one stage in flight, and the
//     stage before it goes back to the producer by one arrival a
//     warpgroup on its empty barrier;
//   * the epilogue runs on the accumulator fragment (a thread holds two
//     rows, two neighbour columns of each 8-column chunk) and stores
//     float2.
// One tile per CTA, no persistent loop: the epilogue of a tile does not
// overlap the next tile's products.
//
// Route 2, mma.sync (pfdnn_int8_matmul): every other shape, w in
// either layout, any M, N and K (ragged rows, columns and a K tail are
// masked by index, zero-filled in shared memory); the decode shapes
// (M <= 64) take it because wgmma needs 64 rows and they are bound by
// w's bytes.  One CTA computes a BM x BN tile, walking K in 64-byte
// steps: each step stages x's tile as [BM][BK] and w's as [BN][BK] (K
// contiguous, the "col" operand layout; a row-major w is transposed on
// the way in, a thread reading a 4 x 4 byte block as four row words and
// writing four column words), rows padded to 80 bytes so the fragment
// reads are free of bank conflicts; each warp runs
// mma.sync.m16n8k32 (s8 x s8 -> s32) over its sub-tile.  128 x 128
// tiles (8 warps) for M > 64, 16 x 32 tiles (2 warps) for M <= 64, so a
// decode batch spreads over many CTAs.  Each stage loads, syncs, then
// computes; no pipeline.
//
// Every entry point returns the cudaError_t of its launch as an int.

#include <cuda.h>
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

// 16 consecutive int8 of row `row` of a [rows, K] row-major matrix from
// byte `col`, zero past `rows` and past K: one 16-byte load where `vec`
// (K % 16 == 0, aligned base) allows
__device__ __forceinline__ uint4 load_chunk(const int8_t* base, int row,
                                            int rows, int col, int K,
                                            bool vec) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row < rows) {
        const int8_t* src = base + (size_t)row * K;
        if (vec && col + 16 <= K) {
            v = __ldg(reinterpret_cast<const uint4*>(src + col));
        } else {
            v.x = load_word(src, col, K, false);
            v.y = load_word(src, col + 4, K, false);
            v.z = load_word(src, col + 8, K, false);
            v.w = load_word(src, col + 12, K, false);
        }
    }
    return v;
}

template <int BM, int BN, int WM, int WN, bool WK>
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

    // 16-byte row loads of x (and of a K-major w) need every row start
    // aligned; 4-byte row loads of a row-major w likewise
    const bool x_vec = (K % 16 == 0) &&
                       ((reinterpret_cast<uintptr_t>(x) & 15) == 0);
    const bool w_vec = WK ? (K % 16 == 0) &&
                                ((reinterpret_cast<uintptr_t>(w) & 15) == 0)
                          : (N % 4 == 0) &&
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
            *reinterpret_cast<uint4*>(As + m * LDS + kc) =
                load_chunk(x, m0 + m, M, k0 + kc, K, x_vec);
        }
        if constexpr (WK) {
            // K-major w tile -> Bs[n][k]: its rows are K-contiguous, as x's
            for (int c = tid; c < BN * BK / 16; c += THREADS) {
                const int n = c / (BK / 16), kc = (c % (BK / 16)) * 16;
                *reinterpret_cast<uint4*>(Bs + n * LDS + kc) =
                    load_chunk(w, n0 + n, N, k0 + kc, K, w_vec);
            }
        } else {
            // row-major w tile -> Bs[n][k]: 4 x 4 byte blocks read as four
            // row words (k, n..n+3) and written as four column words
            // (n, k..k+3)
            for (int b = tid; b < (BK / 4) * (BN / 4); b += THREADS) {
                const int kb = (b % (BK / 4)) * 4, nb = (b / (BK / 4)) * 4;
                const int col = n0 + nb;
                uint32_t r[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int k = k0 + kb + i;
                    r[i] = (k < K)
                        ? load_word(w + (size_t)k * N, col, N, w_vec) : 0u;
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const uint32_t c = ((r[0] >> (8 * j)) & 0xffu)
                                       | (((r[1] >> (8 * j)) & 0xffu) << 8)
                                       | (((r[2] >> (8 * j)) & 0xffu) << 16)
                                       | (((r[3] >> (8 * j)) & 0xffu) << 24);
                    *reinterpret_cast<uint32_t*>(Bs + (nb + j) * LDS + kb) =
                        c;
                }
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

template <int BM, int BN, int WM, int WN, bool WK>
int launch_mma(const int8_t* x, const int8_t* w, const float* xs,
               const float* ws, float* out, int M, int N, int K,
               cudaStream_t stream) {
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_matmul_kernel<BM, BN, WM, WN, WK><<<grid, WM * WN * 32, 0, stream>>>(
        x, w, xs, ws, out, M, N, K);
    return (int)cudaGetLastError();
}

template <bool WK>
int launch_mma_route(const int8_t* x, const int8_t* w, const float* xs,
                     const float* ws, float* out, int M, int N, int K,
                     cudaStream_t s) {
    if (M <= 64)
        return launch_mma<16, 32, 1, 2, WK>(x, w, xs, ws, out, M, N, K, s);
    if ((M + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;
    return launch_mma<128, 128, 2, 4, WK>(x, w, xs, ws, out, M, N, K, s);
}

// ------------------------------------------------------- wgmma route

constexpr int WG_BM = 128;      // rows a CTA: two consumer warpgroups x 64
constexpr int WG_BK = 128;      // K bytes a stage: one 128-byte swizzle row

constexpr int WG_THREADS = 384; // producer warpgroup + two consumers

template <int BN>
struct WgCfg {
    static constexpr int STAGES = BN == 256 ? 4 : 6;
    static constexpr int A_BYTES = WG_BM * WG_BK;
    static constexpr int B_BYTES = BN * WG_BK;
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    // 1024 bytes of slack to align the ring, then 2 mbarriers a stage
    static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

// one arrival on bar that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long spins = 0;
    do {
        // a phase that never completes faults the launch instead of
        // hanging the card
        if (++spins > (1ll << 26)) asm volatile("trap;");
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// TMA: the box at (c0, c1) of a 2-D tensor map into shared memory,
// completing its bytes on bar; out-of-range elements land as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
           "r"(c1), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor, K-major under the 128-byte swizzle:
// 8-row groups of 128-byte rows lie 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)1 << 16)               // leading offset: unused
         | ((uint64_t)(1024 >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define PFDNN_R8(i)                                                       \
    "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]),   \
    "+r"(d[(i) + 4]), "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define PFDNN_R64                                                         \
    PFDNN_R8(0), PFDNN_R8(8), PFDNN_R8(16), PFDNN_R8(24), PFDNN_R8(32),   \
    PFDNN_R8(40), PFDNN_R8(48), PFDNN_R8(56)
#define PFDNN_R128                                                        \
    PFDNN_R64, PFDNN_R8(64), PFDNN_R8(72), PFDNN_R8(80), PFDNN_R8(88),    \
    PFDNN_R8(96), PFDNN_R8(104), PFDNN_R8(112), PFDNN_R8(120)

// d += A B over one k32 step: A [64 x 32] and B [32 x BN] int8 from
// shared memory, both K-major
template <int BN>
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t da,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
    "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
    "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
    "%57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p;\n"
        "}\n"
        : PFDNN_R64
        : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da,
                                              uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
    "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
    "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
    "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
    "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
    "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
    "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
    "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
    "%121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p;\n"
        "}\n"
        : PFDNN_R128
        : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accesses of d across the async wgmma
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
int8_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int N, int K) {
    using C = WgCfg<BN>;
    constexpr int STAGES = C::STAGES;
    extern __shared__ uint8_t smem_raw[];
    // stage s: x tile at ring + s * STAGE_BYTES, w tile A_BYTES after it
    const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full = ring + STAGES * C::STAGE_BYTES;    // + 8 s
    const uint32_t empty = full + 8 * STAGES;                // + 8 s
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * BN;
    const int nk = (K + WG_BK - 1) / WG_BK;

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, 2);     // one arrival a consumer
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (wg == 0) {
        // the CTA holds 384 x 168 registers; the producer gives most of
        // its share to the consumers
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (tid == 0) {
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % STAGES;
                // the consumers released this stage's previous fill
                if (kt >= STAGES)
                    mbar_wait(empty + 8 * s, ((kt / STAGES) - 1) & 1);
                const uint32_t dst = ring + s * C::STAGE_BYTES;
                mbar_expect(full + 8 * s, C::STAGE_BYTES);
                tma_load(dst, &tx, kt * WG_BK, m0, full + 8 * s);
                tma_load(dst + C::A_BYTES, &tw, kt * WG_BK, n0, full + 8 * s);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int cw = wg - 1;               // this warpgroup's 64 rows
        int acc[BN / 2];
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
        for (int kt = 0; kt < nk; ++kt) {
            const int s = kt % STAGES;
            mbar_wait(full + 8 * s, (kt / STAGES) & 1);
            const uint32_t a = ring + s * C::STAGE_BYTES + cw * (64 * WG_BK);
            const uint32_t b = ring + s * C::STAGE_BYTES + C::A_BYTES;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < WG_BK / 32; ++kk)
                wgmma_s8<BN>(acc, desc_sw128(a + 32 * kk),
                             desc_sw128(b + 32 * kk));
            wg_commit();
            // the products of the stage before this one are done: give
            // that stage back to the producer
            wg_wait<1>();
            fence_acc(acc);
            if (kt > 0 && tid % 128 == 0)
                mbar_arrive(empty + 8 * ((kt - 1) % STAGES));
        }
        wg_wait<0>();
        fence_acc(acc);

        // epilogue: acc[4 j + 2 i + e] is row r0 + 8 i, column
        // n0 + 8 j + 2 quad + e
        const int lane = tid % 32;
        const int quad = lane % 4;
        const int r0 = m0 + cw * 64 + ((tid % 128) / 32) * 16 + lane / 4;
        const float sx[2] = {r0 < M ? xs[r0] : 0.f,
                             r0 + 8 < M ? xs[r0 + 8] : 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            const int col = n0 + 8 * j + 2 * quad;
            // N % 16 == 0 and col is even: col + 1 < N as well
            if (col >= N) continue;
            const float w0 = ws[col], w1 = ws[col + 1];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int row = r0 + 8 * i;
                if (row >= M) continue;
                float2 v;
                v.x = __fmul_rn(__int2float_rn(acc[4 * j + 2 * i]),
                                __fmul_rn(sx[i], w0));
                v.y = __fmul_rn(__int2float_rn(acc[4 * j + 2 * i + 1]),
                                __fmul_rn(sx[i], w1));
                *reinterpret_cast<float2*>(out + (size_t)row * N + col) = v;
            }
        }
    }
}

// w [K, N] row-major -> wt [N, K] row-major (K-major w), K and N
// multiples of 16, both 16-byte aligned: a block moves a 64 x 64-byte
// tile through shared memory, 16 bytes a thread each way
__global__ void __launch_bounds__(256)
transpose_kernel(const int8_t* __restrict__ w, int8_t* __restrict__ wt,
                 int K, int N) {
    __shared__ __align__(16) uint8_t tile[64][80];
    const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
    const int r = threadIdx.x / 4, c = (threadIdx.x % 4) * 16;
    if (k0 + r < K && n0 + c < N)
        *reinterpret_cast<uint4*>(&tile[r][c]) = __ldg(
            reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c));
    __syncthreads();
    // out row n0 + r, bytes k0 + c .. k0 + c + 15: column r of the tile
    if (n0 + r < N && k0 + c < K) {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            v[q] = (uint32_t)tile[c + 4 * q][r]
                 | ((uint32_t)tile[c + 4 * q + 1][r] << 8)
                 | ((uint32_t)tile[c + 4 * q + 2][r] << 16)
                 | ((uint32_t)tile[c + 4 * q + 3][r] << 24);
        *reinterpret_cast<uint4*>(wt + (size_t)(n0 + r) * K + k0 + c) =
            make_uint4(v[0], v[1], v[2], v[3]);
    }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime (no link against
// libcuda)
EncodeTiled encoder() {
    static EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                    cudaEnableDefault, &found)
                != cudaSuccess
            || found != cudaDriverEntryPointSuccess)
            p = nullptr;
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// [rows, K] int8 (K contiguous) as a 2-D tensor map with boxes of 128
// bytes x box_rows rows under the 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int rows, int K,
            int box_rows) {
    EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)K};
    const cuuint32_t box[2] = {(cuuint32_t)WG_BK, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || n <= 0)
            n = 1;
    }
    return n;
}

template <int BN>
int launch_wgmma(const void* x, const void* wt, const float* xs,
                 const float* ws, float* out, int M, int N, int K,
                 cudaStream_t stream) {
    constexpr int smem = WgCfg<BN>::SMEM;
    CUtensorMap tx, tw;
    if (!encode(&tx, x, M, K, WG_BM) || !encode(&tw, wt, N, K, BN))
        return (int)cudaErrorInvalidValue;
    auto kern = int8_wgmma_kernel<BN>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((N + BN - 1) / BN, (M + WG_BM - 1) / WG_BM);
    kern<<<grid, WG_THREADS, smem, stream>>>(tx, tw, xs, ws, out, M, N, K);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mma.sync route: x [M, K] int8 (row-major), w [K, N] int8 row-major
// (w_kmajor = 0) or K-major (1: element (k, n) at n * K + k), x_scale
// [M] and w_scale [N] float32 -> out [M, N] float32; M, N, K > 0
int pfdnn_int8_matmul(const void* x, const void* w, const void* x_scale,
                      const void* w_scale, void* out, int M, int N, int K,
                      int w_kmajor, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
    const int8_t* xp = static_cast<const int8_t*>(x);
    const int8_t* wp = static_cast<const int8_t*>(w);
    const float* xsp = static_cast<const float*>(x_scale);
    const float* wsp = static_cast<const float*>(w_scale);
    float* op = static_cast<float*>(out);
    return w_kmajor
        ? launch_mma_route<true>(xp, wp, xsp, wsp, op, M, N, K, s)
        : launch_mma_route<false>(xp, wp, xsp, wsp, op, M, N, K, s);
}

// wgmma route: x [M, K] int8 row-major, wt [N, K] int8 row-major (w
// K-major), both 16-byte aligned, K and N multiples of 16, M > 0
int pfdnn_int8_matmul_wgmma(const void* x, const void* wt,
                            const void* x_scale, const void* w_scale,
                            void* out, int M, int N, int K, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 16
        || (reinterpret_cast<uintptr_t>(x) & 15)
        || (reinterpret_cast<uintptr_t>(wt) & 15)
        || (M + WG_BM - 1) / WG_BM > 65535)
        return (int)cudaErrorInvalidValue;
    const float* xsp = static_cast<const float*>(x_scale);
    const float* wsp = static_cast<const float*>(w_scale);
    float* op = static_cast<float*>(out);
    // 256-wide tiles where they fill a wave of the SMs, else 128
    const long tiles = (long)((M + WG_BM - 1) / WG_BM) * ((N + 255) / 256);
    if (tiles >= sm_count())
        return launch_wgmma<256>(x, wt, xsp, wsp, op, M, N, K, s);
    return launch_wgmma<128>(x, wt, xsp, wsp, op, M, N, K, s);
}

// w [K, N] int8 row-major -> wt [N, K] int8 row-major; K and N
// multiples of 16, both 16-byte aligned
int pfdnn_int8_transpose(const void* w, void* wt, int K, int N,
                         void* stream) {
    if (K <= 0 || N <= 0 || K % 16 || N % 16
        || (reinterpret_cast<uintptr_t>(w) & 15)
        || (reinterpret_cast<uintptr_t>(wt) & 15)
        || (K + 63) / 64 > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((N + 63) / 64, (K + 63) / 64);
    transpose_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(w), static_cast<int8_t*>(wt), K, N);
    return (int)cudaGetLastError();
}

}  // extern "C"
