// Hand-written Hopper kernel of the prefill attention in bfloat16, on
// the tensor cores (wgmma).
//
// Replaces, for bf16 inputs, the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:81, _kernel at :29) and computes
// the same function as csrc/flash_attention.cu (which keeps float32):
// causal or non-causal GQA attention of q [B, H, Sq, D] over k/v
// [B, KH, Sk, D] (query head h reads KV head h / (H / KH)), queries at
// absolute positions q_offset + i, optionally over a sliding window
// (window > 0 keeps the keys with q_pos - k_pos < window, hymba's
// prefill mask).  Semantics kept from _kernel:
//   * s = dot(q, k) accumulated in float32, then times 1/sqrt(D);
//   * masked scores are NEG_INF = -1e30 (causal: q_pos < k_pos; ragged
//     tail: k_pos >= Sk; window: q_pos - k_pos >= window);
//   * online softmax with a float32 (m, l, acc) carry, the subtraction
//     reference clamped to max(m, 0.5 * NEG_INF) on both the new and the
//     previous maximum, so a fully masked row gives p = 0;
//   * l sums the unrounded float32 p; p is rounded to bf16 before P.V,
//     which accumulates in float32;
//   * out = acc / max(l, 1e-30), rounded to bf16;
//   * KV tiles wholly above the causal diagonal, or wholly below the
//     window of every row of the CTA, are skipped.
//
// What bounds it on an H100: at the serving shape (Sq = Sk = 1024,
// D = 64) the function does 4 * D operations per unmasked (q, k) pair
// against 2 bytes per element of q, k, v and out, so it is bound by the
// bf16 tensor-core rate (989 TFLOP/s dense).
//
// Design, for sm_90a:
//   * one CTA of two warpgroups (256 threads) owns a (batch, head,
//     128-row query tile); each warpgroup owns 64 query rows.  Query
//     tiles are walked last to first, so the long causal rows start
//     first;
//   * shared memory holds the Q tile once and a ring of two stages of
//     64-key K and V tiles, all bf16 in the 128-byte-swizzled layout
//     that wgmma descriptors read: each row of D elements is cut into
//     panels of 64 columns (128 bytes); in a panel, 16-byte chunk c of
//     row r sits at chunk c ^ (r % 8).  One thread loads them by TMA
//     (3-D tensor maps over [B * heads, S, D] with 128-byte swizzle;
//     rows past Sq or Sk and columns past D arrive as zeros), and the
//     stage's mbarrier completes when the bytes have landed, so tile
//     t + 1 loads while tile t computes;
//   * S = Q K^T is wgmma.m64n64k16 with both operands from shared
//     memory (K-major), D / 16 steps accumulating in registers;
//   * the softmax runs on the accumulator fragment: a thread holds two
//     rows, a row lives in the four threads of a quad, so two shuffles
//     give its maximum; l is kept per thread and summed over the quad
//     once, at the end.  It is bound by instruction throughput, so it
//     works in unscaled units: the maximum of s * scale is the maximum
//     of s times scale, the masks and the clamp are divided by scale, and
//     p = exp(scale * (s - m)) is one FFMA and one ex2.approx;
//   * P.V is wgmma.m64n64k16 with p as the A operand from registers
//     (the accumulator fragment of S is the A fragment of P once packed
//     to bf16) and V from shared memory as the transposed (MN-major) B
//     operand, one instruction per 64-column panel of D;
//   * only tiles that cross the diagonal, the window's lower edge or the
//     Sk edge are masked; a warpgroup skips a tile wholly above its own
//     rows' diagonal or wholly below its rows' window.  The CTA's tile
//     loop starts at the tile of its first row's lowest key, so the
//     second warpgroup (64 rows later) may see a tile that lies only
//     partly inside its window: it masks that tile, while the first
//     warpgroup may skip it.  The window is a template parameter: the
//     kernel without one is the windowless kernel, instruction for
//     instruction (a runtime window test cost ~8 % at the serving shape
//     on the H100).
// Every D in 16..128 (step 16) is taken, and D = 192 (MLA's prefill
// head, hd + dr = 128 + 64: three panels, 145 KB of shared memory and
// 96 accumulator registers a thread for O): the columns of a panel past
// D are zeros; S reads only the first D / 16 k-steps, and the P.V
// columns at or past D are never stored.
//
// This version has no producer warpgroup, runs S, the softmax and P.V
// of a warpgroup in turn (overlapping S of the next tile with them
// measured slower on the H100), and stores O from registers.
//
// When the caller passes a `stats` buffer (training: autograd needs the
// gradient), each row's clamped maximum m (scaled units) and 1 / max(l,
// 1e-30) go there at the end, for the backward
// (flash_attention_bwd_wgmma.cu); serving passes none.
//
// The entry point returns cudaGetLastError() of its launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 128;         // query rows per CTA (two warpgroups)
constexpr int BK = 64;          // keys per K/V tile
constexpr int THREADS = 256;
constexpr int STAGES = 2;
constexpr int PANEL = 64;       // bf16 columns of one 128-byte row

template <int D>
struct Cfg {
    static constexpr int NP = (D + PANEL - 1) / PANEL;   // panels of D
    static constexpr int KSTEPS = D / 16;
    static constexpr int Q_BYTES = NP * BQ * 128;
    static constexpr int KV_BYTES = NP * BK * 128;        // one K or V tile
    // 1024 bytes of slack to align the tiles, and the two mbarriers
    static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 16;
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

// `bytes` more of asynchronous copies for the current phase, no arrival
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-D tensor map into shared memory,
// completing `bytes` on bar; out-of-range elements land as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
           "r"(c1), "r"(c2), "r"(bar)
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    long long spins = 0;
    do {
        // a phase that never completes (bytes never counted) faults the
        // launch instead of hanging the card
        if (++spins > (1ll << 24)) asm volatile("trap;");
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// wgmma shared-memory descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of d across the async wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define PFDNN_ACC32(d)                                                    \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),           \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),           \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),      \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),      \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),      \
    "+f"(d[30]), "+f"(d[31])

#define PFDNN_D32                                                         \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
    "%28, %29, %30, %31}"

// d (+)= A B: A [64 x 16] and B [16 x 64] from shared memory, both
// K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        PFDNN_D32 ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : PFDNN_ACC32(d)
        : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B: A [64 x 16] bf16 from registers, B [16 x 64] from shared
// memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        PFDNN_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : PFDNN_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, bool WINDOW>
__global__ void __launch_bounds__(THREADS)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int H, int KH,
                             int Sq, int Sk, int q_offset, int causal,
                             int window, float scale,
                             float* __restrict__ stats) {
    using C = Cfg<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t ks = qs + C::Q_BYTES;                 // stage s at + s * KV
    const uint32_t vs = ks + STAGES * C::KV_BYTES;
    const uint32_t bars = vs + STAGES * C::KV_BYTES;     // stage s at + 8 s

    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / KH);
    const int tid = threadIdx.x;
    const int wg = tid / 128;
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    // CTA rows of this thread's two fragment rows: r0 and r0 + 8
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int qpos0 = q_offset + q0 + r0;
    const int wq_first = q_offset + q0 + wg * 64;        // warpgroup's rows
    const int wq_last = wq_first + 63;

    // the CTA runs tiles [t_lo, t_hi): (causal) up to the last row's
    // tile, (window) from the tile of the first row's lowest key
    int t_hi = (Sk + BK - 1) / BK;
    if (causal) {
        const int last = q_offset + min(q0 + BQ, Sq) - 1;
        t_hi = last < 0 ? 0 : min(t_hi, last / BK + 1);
    }
    int t_lo = 0;
    if constexpr (WINDOW) {
        const int lo_key = q_offset + q0 - window + 1;
        t_lo = lo_key > 0 ? lo_key / BK : 0;
    }
    const int n_tiles = max(0, t_hi - t_lo);

    if (tid == 0) {
        mbar_init(bars, 1);
        mbar_init(bars + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    float acc[C::NP][32];
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    // the softmax runs on unscaled scores: the row maximum of s is the
    // maximum of s * scale over scale; masks and the clamp move to the
    // same units, and exp(scale * (s - m)) = 2^(s * c2 - m * c2)
    const float neg_raw = NEG_INF / scale;
    const float clamp_raw = 0.5f * neg_raw;
    const float c2 = scale * 1.4426950408889634f;
    float m[2] = {neg_raw, neg_raw};
    float l[2] = {0.f, 0.f};            // this thread's share of the row sum

    // thread 0 loads: Q with tile 0, each K/V tile a panel of 64
    // columns at a time (columns past D and rows past Sq / Sk arrive as
    // zeros)
    const int kv_row = b * KH + kh;
    auto load_kv = [&](int stage, int tile) {
        const uint32_t bar = bars + 8 * stage;
        mbar_expect(bar, 2 * C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p) {
            tma_load(ks + stage * C::KV_BYTES + p * (BK * 128), &tk,
                     p * PANEL, tile * BK, kv_row, bar);
            tma_load(vs + stage * C::KV_BYTES + p * (BK * 128), &tv,
                     p * PANEL, tile * BK, kv_row, bar);
        }
    };
    if (tid == 0 && n_tiles > 0) {
        mbar_add_tx(bars, C::Q_BYTES);
        for (int p = 0; p < C::NP; ++p)
            tma_load(qs + p * (BQ * 128), &tq, p * PANEL, q0, b * H + h,
                     bars);
        load_kv(0, t_lo);
    }

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        // the other stage was released by the barrier closing it - 1
        if (tid == 0 && it + 1 < n_tiles) load_kv(st ^ 1, t_lo + it + 1);
        mbar_wait(bars + 8 * st, (it >> 1) & 1);

        const int k0 = (t_lo + it) * BK;
        if (!(causal && k0 > wq_last)
            && !(WINDOW && k0 + BK - 1 < wq_first - window + 1)) {
            const uint32_t kt = ks + st * C::KV_BYTES;
            const uint32_t vt = vs + st * C::KV_BYTES;
            float s[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = 0.f;
            wg_fence();
#pragma unroll
            for (int kk = 0; kk < C::KSTEPS; ++kk) {
                const uint32_t col = (kk % 4) * 32;   // 16 columns
                const uint64_t da = desc_sw128(
                    qs + (kk / 4) * (BQ * 128) + wg * (64 * 128) + col, 16,
                    1024);
                const uint64_t db = desc_sw128(
                    kt + (kk / 4) * (BK * 128) + col, 16, 1024);
                wgmma_ss(s, da, db, kk > 0);
            }
            wg_commit();
            wg_wait_all();
            fence_regs(s);

            // mask, online softmax on the fragment: s[4c + 2i + j] is
            // row r0 + 8 i, key k0 + 8 c + 2 quad + j
            const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wq_first)
                              || (WINDOW && k0 <= wq_last - window);
            if (edge) {
#pragma unroll
                for (int c = 0; c < 8; ++c)
#pragma unroll
                    for (int i = 0; i < 2; ++i)
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                            const int kpos = k0 + 8 * c + 2 * quad + j;
                            const int qpos = qpos0 + 8 * i;
                            if (kpos >= Sk || (causal && qpos < kpos)
                                || (WINDOW && qpos - kpos >= window))
                                s[4 * c + 2 * i + j] = neg_raw;
                        }
            }
            uint32_t pa[4][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float mt = neg_raw;
#pragma unroll
                for (int c = 0; c < 8; ++c)
                    mt = fmaxf(mt, fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
                const float m_new = fmaxf(m[i], mt);
                const float m_sub = fmaxf(m_new, clamp_raw);
                const float corr = ex2((fmaxf(m[i], clamp_raw) - m_sub) * c2);
                const float off = m_sub * c2;
                float psum = 0.f;
#pragma unroll
                for (int c = 0; c < 8; ++c)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const float p = ex2(fmaf(s[4 * c + 2 * i + j], c2, -off));
                        s[4 * c + 2 * i + j] = p;
                        psum += p;
                    }
                l[i] = l[i] * corr + psum;
                m[i] = m_new;
#pragma unroll
                for (int p = 0; p < C::NP; ++p)
#pragma unroll
                    for (int c = 0; c < 8; ++c) {
                        acc[p][4 * c + 2 * i] *= corr;
                        acc[p][4 * c + 2 * i + 1] *= corr;
                    }
            }
            // the S fragment of keys 16 kk .. 16 kk + 15 is the A
            // fragment of P for k-step kk
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
                pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
                pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
                pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
            }

            wg_fence();
#pragma unroll
            for (int p = 0; p < C::NP; ++p)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    // 16 keys = two 8-row groups of 1024 bytes; the panel
                    // spans the 64 columns of the instruction, so LBO
                    // (the MN repeat) is never used
                    const uint64_t db = desc_sw128(
                        vt + p * (BK * 128) + kk * 2048, 1024, 1024);
                    wgmma_rs(acc[p], pa[kk], db);
                }
            wg_commit();
            wg_wait_all();
#pragma unroll
            for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);
        }
        __syncthreads();                // stage st is free for tile it + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float li = l[i];
        li += __shfl_xor_sync(0xffffffffu, li, 1);
        li += __shfl_xor_sync(0xffffffffu, li, 2);
        const int row = q0 + r0 + 8 * i;
        if (row >= Sq) continue;
        const float denom = fmaxf(li, 1e-30f);
        if (stats != nullptr && quad == 0) {
            // the row's statistics for the backward: m in scaled units
            // (clamped as the softmax clamps it) and 1 / max(l, 1e-30)
            const size_t at = (size_t)(b * H + h) * Sq + row;
            stats[at] = fmaxf(m[i], clamp_raw) * scale;
            stats[(size_t)gridDim.z * H * Sq + at] = 1.f / denom;
        }
        __nv_bfloat16* orow = o + ((size_t)(b * H + h) * Sq + row) * D;
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int col = p * PANEL + 8 * c + 2 * quad;
                if (col < D) {
                    const __nv_bfloat162 val = __floats2bfloat162_rn(
                        acc[p][4 * c + 2 * i] / denom,
                        acc[p][4 * c + 2 * i + 1] / denom);
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) = val;
                }
            }
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

// [n, rows, D] bf16 as a 3-D tensor map with boxes of 64 columns x
// box_rows rows, 128-byte swizzle (the layout the wgmma descriptors read)
bool encode(CUtensorMap* map, const void* base, int n, int rows, int D,
            int box_rows) {
    EncodeTiled fn = encoder();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                                (cuuint64_t)n};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)rows * D * 2};
    const cuuint32_t box[3] = {PANEL, (cuuint32_t)box_rows, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
              const_cast<void*>(base), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool WINDOW>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, int q_offset, int causal,
           int window, float scale, float* stats, cudaStream_t stream) {
    constexpr int smem = Cfg<D>::SMEM;
    CUtensorMap tq, tk, tv;
    if (!encode(&tq, q, B * H, Sq, D, BQ) || !encode(&tk, k, B * KH, Sk, D, BK)
        || !encode(&tv, v, B * KH, Sk, D, BK))
        return (int)cudaErrorInvalidValue;
    auto kern = flash_attention_wgmma_kernel<D, WINDOW>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, THREADS, smem, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, KH, Sq, Sk, q_offset,
        causal, window, scale, stats);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v and out are bfloat16; scale is float32(1 / sqrt(D)), as the
// reference rounds it; window > 0 is the sliding window (0: none);
// stats (NULL: none) receives float32 [2, B * H * Sq]: each row's m and
// 1 / max(l, 1e-30), for the backward
int pfdnn_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KH, int Sq,
                               int Sk, int D, int q_offset, int causal,
                               int window, float scale, void* stats,
                               void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* st = static_cast<float*>(stats);
#define PFDNN_CASE(DD)                                                  \
    case DD:                                                            \
        return window > 0                                               \
            ? launch<DD, true>(q, k, v, o, B, H, KH, Sq, Sk, q_offset,  \
                               causal, window, scale, st, s)            \
            : launch<DD, false>(q, k, v, o, B, H, KH, Sq, Sk, q_offset, \
                                causal, 0, scale, st, s);
    switch (D) {
        PFDNN_CASE(16) PFDNN_CASE(32) PFDNN_CASE(48) PFDNN_CASE(64)
        PFDNN_CASE(80) PFDNN_CASE(96) PFDNN_CASE(112) PFDNN_CASE(128)
        PFDNN_CASE(192)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PFDNN_CASE
}

}  // extern "C"
