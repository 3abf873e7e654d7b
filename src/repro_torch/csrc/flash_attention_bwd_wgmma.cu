// Hand-written Hopper kernels of the prefill attention's backward in
// bfloat16, on the tensor cores (wgmma): dQ, dK and dV of
//
//     O = softmax(mask(Q Kᵀ · scale)) V
//
// for q [B, H, Sq, D] over k/v [B, KH, Sk, D] (GQA: head h reads KV head
// h / (H / KH)), causal or not, queries at q_offset + i, an optional
// sliding window (keep q_pos - k_pos < window), every head dim the bf16
// forward (flash_attention_wgmma.cu) takes: 16..128 in steps of 16 and
// 192.  (float32 stays on the CUDA cores, flash_attention_bwd.cu: the
// tensor cores have no full-float32 product.)
//
// It replaces no TPU kernel: the JAX package trains through
// flash_attention_jnp (src/repro/models/layers.py) under XLA's autodiff
// and has no Pallas backward.  It computes the same gradient from the
// row statistics the forward saved (`stats`, float32 [2, B·H·Sq]: each
// row's clamped max m of the scaled scores and 1 / max(l, 1e-30)), with
// P = exp(S − m) · (1 / l), dP = dO Vᵀ, δ = rowsum(dO ∘ O), dS = P ∘ (dP
// − δ), dQ = dS K · scale, dK = dSᵀ Q · scale, dV = Pᵀ dO.  Everything is
// float32 but the operands of the products: q, k, v, dO as given (bf16),
// and P and dS rounded to bf16 where they enter a product
// (flash_attention_bwd_bf16_plain states the same algorithm in PyTorch).
//
// Three kernels, launched in order on one stream (the FlashAttention-2
// split, no atomics):
//   1. delta_kernel: δ of every row (reads O and dO once; bound by
//      bytes);
//   2. dq_kernel, one CTA of two warpgroups a (128-row query tile, head,
//      batch), each warpgroup 64 rows: over the 64-key tiles the mask
//      reaches, S = Q Kᵀ and dP = dO Vᵀ (wgmma, both operands from
//      shared memory), P and dS on the accumulator fragment, then dQ +=
//      dS K (wgmma, dS from registers, K as the transposed B operand);
//   3. dkv_kernel, one CTA a (64-key tile, KV head, batch): loops over
//      the group's query heads and the 64-query tiles the mask reaches,
//      in a fixed order.  Warpgroup 0 computes Sᵀ = K Qᵀ and Pᵀ and
//      accumulates dV += Pᵀ dO; warpgroup 1 computes dPᵀ = V dOᵀ, takes
//      Pᵀ from warpgroup 0 through shared memory (the two accumulator
//      fragments have one layout, so thread t reads what thread t
//      wrote), forms dSᵀ and accumulates dK += dSᵀ Q.  Splitting dK and
//      dV over the warpgroups keeps one 64 × D float32 accumulator a
//      thread (96 registers at D = 192) instead of two.
// Both grids run their heaviest causal tiles first (the last query
// tiles, the first key tiles).  Every output element is summed by one
// thread in a fixed order, so the gradient is the same bits run after
// run (the training drill's restart must repeat a step exactly).
//
// What bounds it on an H100: per kept (query, key) pair the products
// QKᵀ and dO Vᵀ run twice (dQ kernel, dK/dV kernel) and dS K, Pᵀ dO,
// dSᵀ Q once: 7 · 2D operations against 2 bytes per element of q, k, v,
// O, dO and the gradients, so at training's shapes the bf16 tensor-core
// rate (989 TFLOP/s dense) bounds it.  The design feeds the tensor cores
// from shared memory: tiles arrive by TMA (3-D tensor maps over [B ·
// heads, S, D], 128-byte swizzle, rows past S and columns past D as
// zeros) into a ring of two stages under mbarriers, so tile t + 1 loads
// while tile t computes; the layouts and descriptors are the forward's
// (each row cut into panels of 64 columns, 16-byte chunk c of row r at c
// ^ (r % 8)).
//
// Masking is one predicate, `kept`, applied only to tiles that cross
// the diagonal, the window's lower edge or a ragged end; tile ranges
// skip what no row keeps (the causal upper triangle, keys below the
// window).  A row that sees no key has m = 0.5·NEG_INF clamped and every
// pair masked, so P = 0 and its gradient is exactly zero.
//
// The entry point returns cudaGetLastError() of its launches.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 64;          // rows a warpgroup: a tile of 64
constexpr int BQ = 128;         // query rows a dq_kernel CTA
constexpr int THREADS = 256;    // two warpgroups
constexpr int STAGES = 2;
constexpr int PANEL = 64;       // bf16 columns of one 128-byte row

template <int D>
struct Cfg {
    static constexpr int NP = (D + PANEL - 1) / PANEL;   // panels of D
    static constexpr int KSTEPS = D / 16;
    static constexpr int TILE = NP * BM * 128;            // a 64-row tile
    static constexpr int RS_FLOATS = 3 * BM;              // a stats slot
    // two CTAs an SM where D <= 64 (then at most 128 registers a thread)
    static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
    // 1024 bytes of slack to align the tiles; the mbarriers, then (dQ)
    // the rows' statistics
    static constexpr int DQ_SMEM = 1024 + 2 * (2 * TILE)
                                   + STAGES * 2 * TILE + 8 * STAGES
                                   + 3 * BQ * 4;
    static constexpr int DKV_SMEM = 1024 + 2 * TILE + STAGES * 2 * TILE
                                    + STAGES * RS_FLOATS * 4
                                    + 32 * 128 * 4 + 8 * STAGES;
    static_assert(DQ_SMEM <= 232448 && DKV_SMEM <= 232448,
                  "shared memory of a block");
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
// completing its bytes on bar; out-of-range elements land as zeros
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

// the accumulator fragment of a [64 x 64] product, packed to bf16, as the
// A fragments of the next product's four 16-deep k-steps (the fragment's
// columns 16 kk .. 16 kk + 15 are k-step kk)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// x = A Bᵀ over D: A and B two 64-row tiles in shared memory (row r of A
// at a + ..., D contiguous), both K-major; a_rows is A's panel height
template <int D>
__device__ __forceinline__ void product_ss(float (&x)[32], uint32_t a,
                                           int a_rows, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;       // 16 columns
        wgmma_ss(x, desc_sw128(a + (kk / 4) * (a_rows * 128) + col, 16,
                               1024),
                 desc_sw128(b + (kk / 4) * (BM * 128) + col, 16, 1024),
                 kk > 0);
    }
}

// acc[p] += A B: A the packed [64 x 64] fragment, B a 64-row tile in
// shared memory read transposed (its rows are the k dimension), one
// instruction per 64-column panel and k-step
template <int NP>
__device__ __forceinline__ void product_rs(float (&acc)[NP][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            // 16 rows = two 8-row groups of 1024 bytes
            wgmma_rs(acc[p], a[kk],
                     desc_sw128(b + p * (BM * 128) + kk * 2048, 1024, 1024));
}

template <bool WINDOW>
__device__ __forceinline__ bool kept(int qpos, int kpos, int Sk, int causal,
                                     int window) {
    return kpos < Sk && !(causal && qpos < kpos)
           && !(WINDOW && qpos - kpos >= window);
}

// 1. δ = rowsum(dO ∘ O) ------------------------------------------------

// eight threads a row, 16 bytes (8 elements) a load
__global__ void __launch_bounds__(THREADS)
delta_kernel(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, int rows, int D) {
    const int row = blockIdx.x * (THREADS / 8) + threadIdx.x / 8;
    const int sub = threadIdx.x % 8;
    float acc = 0.f;
    if (row < rows) {
        const uint4* og = reinterpret_cast<const uint4*>(o + (size_t)row * D);
        const uint4* dg =
            reinterpret_cast<const uint4*>(dout + (size_t)row * D);
        for (int c = sub; c < D / 8; c += 8) {
            const uint4 a = og[c], b = dg[c];
            const __nv_bfloat162* a2 =
                reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* b2 =
                reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 x = __bfloat1622float2(a2[e]);
                const float2 y = __bfloat1622float2(b2[e]);
                acc = fmaf(x.x, y.x, acc);
                acc = fmaf(x.y, y.y, acc);
            }
        }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (sub == 0 && row < rows) delta[row] = acc;
}

// 2. dQ ----------------------------------------------------------------

template <int D, bool WINDOW>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const float* __restrict__ stats, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int B, int H, int KH, int Sq,
          int Sk, int q_offset, int causal, int window, float scale,
          int n_qt) {
    using C = Cfg<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t dos = qs + 2 * C::TILE;               // 128 rows each
    const uint32_t ks = dos + 2 * C::TILE;               // stage s at + s * TILE
    const uint32_t vs = ks + STAGES * C::TILE;
    const uint32_t bars = vs + STAGES * C::TILE;         // stage s at + 8 s
    // each row's m in exp2 units, 1 / l and δ (rows past Sq: 0, so their
    // P is 0)
    float* rows = reinterpret_cast<float*>(
        smem_raw + (bars + 8 * STAGES - smem_u32(smem_raw)));

    // block i takes query tile n_qt - 1 - i / (B · H) of (batch, head)
    // i % (B · H): the heaviest causal tiles start first
    const int bh_n = B * H;
    const int q0 = (n_qt - 1 - (int)(blockIdx.x / bh_n)) * BQ;
    const int h = blockIdx.x % bh_n % H;
    const int b = blockIdx.x % bh_n / H;
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

    // key tiles [t_lo, t_hi): (causal) up to the last row's tile,
    // (window) from the tile of the first row's lowest key
    int t_hi = (Sk + BM - 1) / BM;
    if (causal) {
        const int last = q_offset + min(q0 + BQ, Sq) - 1;
        t_hi = last < 0 ? 0 : min(t_hi, last / BM + 1);
    }
    int t_lo = 0;
    if constexpr (WINDOW) {
        const int lo_key = q_offset + q0 - window + 1;
        t_lo = lo_key > 0 ? lo_key / BM : 0;
    }
    const int n_tiles = max(0, t_hi - t_lo);

    if (tid == 0) {
        mbar_init(bars, 1);
        mbar_init(bars + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (tid < BQ) {
        const int row = q0 + tid;
        const size_t at = (size_t)(b * H + h) * Sq + row;
        const bool real = row < Sq;
        rows[tid] = real ? stats[at] * LOG2E : 0.f;
        rows[BQ + tid] = real ? stats[(size_t)B * H * Sq + at] : 0.f;
        rows[2 * BQ + tid] = real ? delta[at] : 0.f;
    }
    __syncthreads();

    const int kv_row = b * KH + kh;
    auto load_kv = [&](int stage, int tile) {
        const uint32_t bar = bars + 8 * stage;
        mbar_expect(bar, 2 * C::TILE);
        for (int p = 0; p < C::NP; ++p) {
            tma_load(ks + stage * C::TILE + p * (BM * 128), &tk, p * PANEL,
                     tile * BM, kv_row, bar);
            tma_load(vs + stage * C::TILE + p * (BM * 128), &tv, p * PANEL,
                     tile * BM, kv_row, bar);
        }
    };
    if (tid == 0 && n_tiles > 0) {
        mbar_add_tx(bars, 4 * C::TILE);
        for (int p = 0; p < C::NP; ++p) {
            tma_load(qs + p * (BQ * 128), &tq, p * PANEL, q0, b * H + h, bars);
            tma_load(dos + p * (BQ * 128), &tdo, p * PANEL, q0, b * H + h,
                     bars);
        }
        load_kv(0, t_lo);
    }

    const float c2 = scale * LOG2E;

    float acc[C::NP][32];
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        // the other stage was released by the barrier closing it - 1
        if (tid == 0 && it + 1 < n_tiles) load_kv(st ^ 1, t_lo + it + 1);
        mbar_wait(bars + 8 * st, (it >> 1) & 1);

        const int k0 = (t_lo + it) * BM;
        if (!(causal && k0 > wq_last)
            && !(WINDOW && k0 + BM - 1 < wq_first - window + 1)) {
            const uint32_t kt = ks + st * C::TILE;
            const uint32_t vt = vs + st * C::TILE;
            float s[32], dp[32];
#pragma unroll
            for (int i = 0; i < 32; ++i) { s[i] = 0.f; dp[i] = 0.f; }
            wg_fence();
            product_ss<D>(s, qs + wg * (BM * 128), BQ, kt);
            product_ss<D>(dp, dos + wg * (BM * 128), BQ, vt);
            wg_commit();
            wg_wait_all();
            fence_regs(s);
            fence_regs(dp);

            // s[4 c + 2 i + j] is row r0 + 8 i, key k0 + 8 c + 2 quad + j;
            // dS = P (dP - δ) replaces s
            const bool edge = k0 + BM > Sk
                              || (causal && k0 + BM - 1 > wq_first)
                              || (WINDOW && k0 <= wq_last - window);
            float off[2], inv_l[2], dl[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                off[i] = rows[r0 + 8 * i];
                inv_l[i] = rows[BQ + r0 + 8 * i];
                dl[i] = rows[2 * BQ + r0 + 8 * i];
            }
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const int e = 4 * c + 2 * i + j;
                        float p = ex2(fmaf(s[e], c2, -off[i])) * inv_l[i];
                        if (edge
                            && !kept<WINDOW>(qpos0 + 8 * i,
                                             k0 + 8 * c + 2 * quad + j, Sk,
                                             causal, window))
                            p = 0.f;
                        s[e] = p * (dp[e] - dl[i]);
                    }
            uint32_t a[4][4];
            pack_a(a, s);
            wg_fence();
            product_rs<C::NP>(acc, a, kt);
            wg_commit();
            wg_wait_all();
#pragma unroll
            for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);
        }
        __syncthreads();                // stage st is free for tile it + 2
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + 8 * i;
        if (row >= Sq) continue;
        __nv_bfloat16* out = dq + ((size_t)(b * H + h) * Sq + row) * D;
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int col = p * PANEL + 8 * c + 2 * quad;
                if (col < D)
                    *reinterpret_cast<__nv_bfloat162*>(out + col) =
                        __floats2bfloat162_rn(acc[p][4 * c + 2 * i] * scale,
                                              acc[p][4 * c + 2 * i + 1]
                                                  * scale);
            }
    }
}

// 3. dK and dV ---------------------------------------------------------

template <int D, bool WINDOW>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
dkv_kernel(const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ stats, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int B, int H, int KH, int Sq, int Sk, int q_offset, int causal,
           int window, float scale) {
    using C = Cfg<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t ks = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t vs = ks + C::TILE;
    const uint32_t qs = vs + C::TILE;                    // stage s at + s * TILE
    const uint32_t dos = qs + STAGES * C::TILE;
    const uint32_t rs_u32 = dos + STAGES * C::TILE;      // m · log2 e, 1/l, δ
    const uint32_t pb_u32 = rs_u32 + STAGES * C::RS_FLOATS * 4;
    const uint32_t bars = pb_u32 + 32 * 128 * 4;
    float* rs = reinterpret_cast<float*>(
        smem_raw + (rs_u32 - smem_u32(smem_raw)));
    float* pbuf = reinterpret_cast<float*>(
        smem_raw + (pb_u32 - smem_u32(smem_raw)));

    // block i takes key tile i / (B · KH) of (batch, KV head) i % (B ·
    // KH): tile 0 reaches the most causal query tiles and starts first
    const int bkh_n = B * KH;
    const int k0 = (int)(blockIdx.x / bkh_n) * BM;
    const int kh = blockIdx.x % bkh_n % KH;
    const int b = blockIdx.x % bkh_n / KH;
    const int G = H / KH;
    const int tid = threadIdx.x;
    const int wg = tid / 128;                // 0: P and dV; 1: dS and dK
    const int t = tid % 128;
    const int warp = t / 32;
    const int lane = tid % 32;
    const int quad = lane % 4;
    const int r0 = warp * 16 + lane / 4;     // key rows r0, r0 + 8 of the tile

    // the query tiles with a row that keeps a key of this tile
    const int kmax = min(k0 + BM, Sk) - 1;
    int r_lo = 0, r_hi = Sq;
    if (causal) r_lo = max(0, k0 - q_offset);
    if constexpr (WINDOW) r_hi = max(0, min(Sq, kmax + window - q_offset));
    const int qt_lo = r_lo / BM;
    const int nq = r_hi > r_lo ? (r_hi + BM - 1) / BM - qt_lo : 0;
    const int n_tiles = G * nq;              // (head, query tile) pairs

    const size_t n_rows = (size_t)B * H * Sq;
    // warpgroup 1 stages the rows' statistics of tile `it`
    auto load_stats = [&](int slot, int it) {
        const int h = kh * G + it / nq;
        const int row = (qt_lo + it % nq) * BM + t;
        if (t < BM) {
            const size_t at = (size_t)(b * H + h) * Sq + row;
            const bool real = row < Sq;
            float* r = rs + slot * C::RS_FLOATS;
            r[t] = real ? stats[at] * LOG2E : 0.f;
            r[BM + t] = real ? stats[n_rows + at] : 0.f;
            r[2 * BM + t] = real ? delta[at] : 0.f;
        }
    };
    auto load_qdo = [&](int stage, int it) {
        const uint32_t bar = bars + 8 * stage;
        const int q_row = b * H + kh * G + it / nq;
        const int q0 = (qt_lo + it % nq) * BM;
        mbar_expect(bar, 2 * C::TILE);
        for (int p = 0; p < C::NP; ++p) {
            tma_load(qs + stage * C::TILE + p * (BM * 128), &tq, p * PANEL,
                     q0, q_row, bar);
            tma_load(dos + stage * C::TILE + p * (BM * 128), &tdo, p * PANEL,
                     q0, q_row, bar);
        }
    };

    if (tid == 0) {
        mbar_init(bars, 1);
        mbar_init(bars + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (wg == 1 && n_tiles > 0) load_stats(0, 0);
    __syncthreads();
    if (tid == 0 && n_tiles > 0) {
        mbar_add_tx(bars, 2 * C::TILE);
        for (int p = 0; p < C::NP; ++p) {
            tma_load(ks + p * (BM * 128), &tk, p * PANEL, k0, b * KH + kh,
                     bars);
            tma_load(vs + p * (BM * 128), &tv, p * PANEL, k0, b * KH + kh,
                     bars);
        }
        load_qdo(0, 0);
    }

    const float c2 = scale * LOG2E;
    // warpgroup 0: dV; warpgroup 1: dK (before the scale)
    float acc[C::NP][32];
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        if (it + 1 < n_tiles) {
            // stage st ^ 1 and its statistics were released by the
            // barrier closing it - 1
            if (tid == 0) load_qdo(st ^ 1, it + 1);
            if (wg == 1) load_stats(st ^ 1, it + 1);
        }
        mbar_wait(bars + 8 * st, (it >> 1) & 1);

        const int q0 = (qt_lo + it % nq) * BM;
        const int qfirst = q_offset + q0;
        const bool edge = q0 + BM > Sq || k0 + BM > Sk
                          || (causal && qfirst < k0 + BM - 1)
                          || (WINDOW && qfirst + BM - 1 - k0 >= window);
        const uint32_t qt = qs + st * C::TILE;
        const uint32_t dot = dos + st * C::TILE;
        const float* r = rs + st * C::RS_FLOATS;

        // warpgroup 0: x = Sᵀ = K Qᵀ; warpgroup 1: x = dPᵀ = V dOᵀ.
        // x[4 c + 2 i + j] is key k0 + r0 + 8 i, query q0 + 8 c + 2 quad + j
        float x[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) x[i] = 0.f;
        wg_fence();
        product_ss<D>(x, wg == 0 ? ks : vs, BM, wg == 0 ? qt : dot);
        wg_commit();
        wg_wait_all();
        fence_regs(x);

        if (wg == 0) {
            // Pᵀ, to registers and to warpgroup 1
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const int col = 8 * c + 2 * quad + j;
                    const float o = r[col], il = r[BM + col];
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int e = 4 * c + 2 * i + j;
                        float p = ex2(fmaf(x[e], c2, -o)) * il;
                        if (edge
                            && !(q0 + col < Sq
                                 && kept<WINDOW>(qfirst + col,
                                                 k0 + r0 + 8 * i, Sk,
                                                 causal, window)))
                            p = 0.f;
                        x[e] = p;
                        pbuf[e * 128 + t] = p;
                    }
                }
            __threadfence_block();
            asm volatile("bar.arrive 1, 256;\n" ::: "memory");
        } else {
            asm volatile("bar.sync 1, 256;\n" ::: "memory");
            // dSᵀ = Pᵀ (dPᵀ - δ)
#pragma unroll
            for (int c = 0; c < 8; ++c)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const float dlt = r[2 * BM + 8 * c + 2 * quad + j];
#pragma unroll
                    for (int i = 0; i < 2; ++i) {
                        const int e = 4 * c + 2 * i + j;
                        x[e] = pbuf[e * 128 + t] * (x[e] - dlt);
                    }
                }
        }
        uint32_t a[4][4];
        pack_a(a, x);
        wg_fence();
        // dV += Pᵀ dO, dK += dSᵀ Q
        product_rs<C::NP>(acc, a, wg == 0 ? dot : qt);
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int p = 0; p < C::NP; ++p) fence_regs(acc[p]);
        __syncthreads();    // stage st, its statistics and pbuf are free
    }

    __nv_bfloat16* grad = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int key = k0 + r0 + 8 * i;
        if (key >= Sk) continue;
        __nv_bfloat16* out = grad + ((size_t)(b * KH + kh) * Sk + key) * D;
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const int col = p * PANEL + 8 * c + 2 * quad;
                if (col < D)
                    *reinterpret_cast<__nv_bfloat162*>(out + col) =
                        __floats2bfloat162_rn(acc[p][4 * c + 2 * i] * mul,
                                              acc[p][4 * c + 2 * i + 1]
                                                  * mul);
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
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv,
           const float* stats, float* delta, int B, int H, int KH, int Sq,
           int Sk, int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
    using C = Cfg<D>;
    CUtensorMap tq128, tdo128, tq64, tdo64, tk, tv;
    if (!encode(&tq128, q, B * H, Sq, D, BQ)
        || !encode(&tdo128, dout, B * H, Sq, D, BQ)
        || !encode(&tq64, q, B * H, Sq, D, BM)
        || !encode(&tdo64, dout, B * H, Sq, D, BM)
        || !encode(&tk, k, B * KH, Sk, D, BM)
        || !encode(&tv, v, B * KH, Sk, D, BM))
        return (int)cudaErrorInvalidValue;
    const int rows = B * H * Sq;
    delta_kernel<<<(rows + THREADS / 8 - 1) / (THREADS / 8), THREADS, 0,
                   stream>>>(static_cast<const __nv_bfloat16*>(o),
                             static_cast<const __nv_bfloat16*>(dout), delta,
                             rows, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    auto dqk = dq_kernel<D, WINDOW>;
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int n_qt = (Sq + BQ - 1) / BQ;
    dqk<<<n_qt * H * B, THREADS, C::DQ_SMEM, stream>>>(
        tq128, tdo128, tk, tv, stats, delta,
        static_cast<__nv_bfloat16*>(dq), B, H, KH, Sq, Sk, q_offset, causal,
        window, scale, n_qt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    auto dkvk = dkv_kernel<D, WINDOW>;
    err = cudaFuncSetAttribute(
        dkvk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKV_SMEM);
    if (err != cudaSuccess) return (int)err;
    dkvk<<<(Sk + BM - 1) / BM * KH * B, THREADS, C::DKV_SMEM, stream>>>(
        tk, tv, tq64, tdo64, stats, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B,
        H, KH, Sq, Sk, q_offset, causal, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dq [B, H, Sq, D] and dk, dv [B, KH, Sk, D], bfloat16, from q, k, v, the
// forward's output o and its cotangent dout (all bfloat16); `stats`
// holds the forward's float32 [2, B · H · Sq] row statistics (m, 1 /
// max(l, 1e-30)); `delta` is float32 scratch of B · H · Sq values; scale
// is float32(1 / sqrt(D)); window > 0 is the sliding window (0: none).
// Sq and Sk must be > 0.  Returns a cudaError_t (0 on success); launches
// on `stream`, does not synchronise and allocates nothing.
int pfdnn_flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* stats,
    void* delta, int B, int H, int KH, int Sq, int Sk, int D, int q_offset,
    int causal, int window, float scale, void* stream) {
    if (B <= 0 || KH <= 0 || H % KH || Sq <= 0 || Sk <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* st = static_cast<const float*>(stats);
    float* dl = static_cast<float*>(delta);
#define PFDNN_CASE(DD)                                                    \
    case DD:                                                              \
        return window > 0                                                 \
            ? launch<DD, true>(q, k, v, o, dout, dq, dk, dv, st, dl, B, H, \
                               KH, Sq, Sk, q_offset, causal, window, scale, \
                               s)                                         \
            : launch<DD, false>(q, k, v, o, dout, dq, dk, dv, st, dl, B,  \
                                H, KH, Sq, Sk, q_offset, causal, 0, scale, \
                                s);
    switch (D) {
        PFDNN_CASE(16) PFDNN_CASE(32) PFDNN_CASE(48) PFDNN_CASE(64)
        PFDNN_CASE(80) PFDNN_CASE(96) PFDNN_CASE(112) PFDNN_CASE(128)
        PFDNN_CASE(192)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PFDNN_CASE
}

}  // extern "C"
