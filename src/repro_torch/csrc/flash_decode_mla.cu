// Hand-written Hopper kernels of MLA's absorbed decode attention, split
// over the sequence (flash-decoding).
//
// Replaces, for MLA's cache, the Pallas TPU kernel flash_decode
// (src/repro/kernels/flash_decode.py:68, _kernel at :25) and computes
// what the reference's absorbed decode hands decode_attention_jnp
// (src/repro/models/transformer.py:806-832, models/layers.py:177-202):
// one query token per sequence and H query heads, all of one latent
// KV head, q = [q_lat | q_rope] (R + DR = 512 + 64 = 576 columns) over
// the key rows [ckv | krope] of the cache, with the values the same
// ckv rows (width 512), the first length[b] positions valid.
// Semantics kept: s = dot(q, k) in float32 times 1/sqrt(R + DR)
// (float32(1/24)); positions at or past length[b] are masked and never
// read; online softmax with a float32 (m, l, acc) carry and the
// reference clamped to max(m, 0.5 * NEG_INF); l summed from the
// unrounded p, p rounded to the cache's dtype before P.V, float32
// accumulation; out = acc / max(l, 1e-30) in q's dtype.  A length of 0
// gives zeros.
//
// Nothing is concatenated: each key tile is scored from the two cache
// tensors and takes its values from the ckv rows already in shared
// memory, so the latent is read from device memory once.
//
// Pass 1, grid (n_split, head groups, B), 256 threads: the cache range
// of each sequence is cut into n_split chunks of `chunk` positions, a
// multiple of the 32-key tile (the wrapper's plan, a function of S, B,
// H and the SM count only: flash_decode.py::mla_splits).  A chunk that
// holds no valid position exits at once and writes nothing.  A CTA
// serves HG = 16 query heads (deepseek-v2-lite's 16: every head of the
// latent), so each cache row is read once for the whole group.  Its
// threads stream 32-key tiles of [ckv | krope] rows into shared memory
// by 16-byte cp.async, two stages deep, rows padded by 16 bytes (a
// 1168-byte stride: conflict-free 16-byte reads and ldmatrix).
//
// bf16 (mla_split_bf16), on the tensor cores (mma.sync m16n8k16, bf16
// products exact in float32 accumulation): the 16 heads are the M rows.
//   Scores S[16 x 32] = Q[16 x 576] K^T: warp w takes keys 16 (w / 4) ..
//   + 15 and the k quarter w % 4 (9 of the 36 k-steps).  The group's q
//   rows come in by cp.async with the first two tiles (rows past H
//   zero-filled) and each warp takes its q fragments (A, 36 registers)
//   by ldmatrix once; the keys (B) come from the tile by ldmatrix: the
//   tile is key-major, which is B's k-contiguous layout, so no
//   transpose.  The four quarters' partial
//   scores meet in shared memory and are summed in quarter order.
//   Softmax: 16 threads a head, 2 keys a thread; the (m, l) carry and
//   the rescale factor per head; p rounded to bf16 into shared memory.
//   P.V [16 x 512] = P[16 x 32] V: warp w owns columns 64 w .. + 63 (32
//   float32 accumulators a thread), A = P by ldmatrix, B = the same ckv
//   rows by ldmatrix.trans (V is [keys x 512] row-major: the N-major
//   operand); a second 16-key k-step runs only when the tile holds a
//   valid key past 16.  Rows at or past the chunk's end are zero-filled
//   by cp.async (src-size 0: nothing read), so P.V never meets garbage
//   (p = 0 times a NaN would be NaN).
// float32 (mla_split_f32), on the CUDA cores (TF32 would not hold the
//   3e-5 tolerance; float32 MLA decode runs only in parity runs): warp w
//   owns heads 2w and 2w + 1 and lane j key j of the tile, q sits in
//   shared memory as float32; P.V: thread t owns heads 4 (t / 64) .. + 3
//   and columns 8 (t % 64) .. + 7.
// The partial (m, l, acc[512]) of each (b, head, live split) goes to
// float32 scratch that the wrapper allocates.
//
// Pass 2, grid (H, B), 128 threads of 4 columns: combines the chunks
// below length[b] of each (b, head) in split order (no atomics:
// deterministic) with the clamp, the weights of up to 128 chunks at a
// time in shared memory, and writes acc / max(l, 1e-30); no chunk (a
// length of 0) gives zeros.  Where the caller passes an lse buffer, it
// also writes each row's log-sum-exp of the scaled scores, m + log(l)
// (NEG_INF with no valid key), for a merge across cache slices.
//
// What bounds it on an H100: the cache is read once, 1152 bytes a
// position in bf16, for 2 * 1088 flops a position and head, so at 16
// heads the work is about 30 flops a byte, far below the ~295 at which
// the tensor cores would bind: bytes bound it.  On the CUDA cores the
// scores alone cost ~2 k FFMA for 16 heads x 8 keys x 16 columns, which
// one mma.sync does; with the products on the tensor cores the kernel's
// issue slots per cache row fall ~30x and its limit is the stream of
// tiles: two stages a CTA, two CTAs an SM (105,024 bytes of shared
// memory and at most 128 registers a thread each), and a split plan of
// at most two CTAs an SM (one wave even when every chunk holds valid
// positions) with as many splits as that allows.  At deepseek-v2-lite's
// serving shape the cache is small (~20 MB) and each CTA streams only a
// few tiles, so launch, the first loads and the partials' round trip
// through the combine set much of the time (PERF.md, the kernel table).
//
// The entry point returns cudaGetLastError() after both launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int R = 512;          // latent width (values)
constexpr int DR = 64;          // decoupled rope width
constexpr int DK = R + DR;      // key width
constexpr int TK = 32;          // keys per tile; a chunk is a multiple
constexpr int HG = 16;          // query heads per CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, of which the first src_bytes (16 or 0) are read and
// the rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// ------------------------------------------------- bf16, tensor cores

namespace tc {
constexpr int ROW = DK * 2 + 16;            // padded row bytes (1168)
constexpr int TILE = TK * ROW;
constexpr int CH_R = R / 8;                 // 16-byte chunks of ckv
constexpr int CH_K = DK / 8;                // of a key row
constexpr int QUARTERS = 4;                 // k quarters of the scores
constexpr int KQ = DK / 16 / QUARTERS;      // k-steps a warp (9)
constexpr int SROW = TK + 8;                // partial-score row (floats)
constexpr int PROW = TK + 8;                // p row (bf16, 80 bytes)
constexpr int S_BYTES = QUARTERS * HG * SROW * 4;
constexpr int P_BYTES = HG * PROW * 2;
constexpr int Q_BYTES = HG * ROW;           // q rows, padded as the keys
constexpr int SMEM = Q_BYTES + 2 * TILE + S_BYTES + P_BYTES + HG * 4;
static_assert(QUARTERS * (TK / 16) == WARPS, "a warp per (quarter, 16 keys)");
static_assert(WARPS * 64 == R, "a warp per 64 value columns");
static_assert(HG * TK / 2 == THREADS, "2 keys a softmax thread");
static_assert(KQ * 16 * QUARTERS == DK, "the quarters cover the key");
}  // namespace tc

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// positions [j0, j0 + TK) of one sequence into a padded tile of
// [ckv | krope] rows; rows at or past j1 (> j0) are zero-filled, unread
__device__ __forceinline__ void load_tile_bf16(uint8_t* dst, const bf16* ckv,
                                               const bf16* krope, int j0,
                                               int j1) {
    for (int i = threadIdx.x; i < TK * tc::CH_K; i += THREADS) {
        const int r = i / tc::CH_K, c = i % tc::CH_K;
        const bool live = j0 + r < j1;
        const size_t j = live ? j0 + r : j0;
        const bf16* src = c < tc::CH_R
            ? ckv + j * R + c * 8
            : krope + j * DR + (c - tc::CH_R) * 8;
        cp_async16(dst + r * tc::ROW + c * 16, src, live ? 16 : 0);
    }
}

// the group's q rows [q_lat | q_rope] into a padded [HG][ROW] block; rows
// of heads past H zero-filled, unread
__device__ __forceinline__ void load_q_bf16(uint8_t* dst, const bf16* q_lat,
                                            const bf16* q_rope, int b, int H,
                                            int h0) {
    for (int i = threadIdx.x; i < HG * tc::CH_K; i += THREADS) {
        const int r = i / tc::CH_K, c = i % tc::CH_K;
        const bool live = h0 + r < H;
        const size_t h = (size_t)b * H + (live ? h0 + r : h0);
        const bf16* src = c < tc::CH_R ? q_lat + h * R + c * 8
                                       : q_rope + h * DR + (c - tc::CH_R) * 8;
        cp_async16(dst + r * tc::ROW + c * 16, src, live ? 16 : 0);
    }
}

__global__ void __launch_bounds__(THREADS, 2)
mla_split_bf16(const bf16* __restrict__ q_lat, const bf16* __restrict__ q_rope,
               const bf16* __restrict__ ckv, const bf16* __restrict__ krope,
               const int32_t* __restrict__ length, float* __restrict__ part,
               int B, int H, int S, int n_split, int chunk, float scale) {
    using namespace tc;
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* qs = smem;                                       // [HG][ROW]
    uint8_t* kv = qs + Q_BYTES;                               // [2][TILE]
    float* sp = reinterpret_cast<float*>(kv + 2 * TILE);      // [4][HG][SROW]
    bf16* ps = reinterpret_cast<bf16*>(kv + 2 * TILE + S_BYTES);
    float* corr_s = reinterpret_cast<float*>(kv + 2 * TILE + S_BYTES
                                             + P_BYTES);      // [HG]

    const int split = blockIdx.x;
    const int h0 = blockIdx.y * HG;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;

    const int len = max(0, min(length[b], S));
    const int c0 = split * chunk;
    const int c1 = min(c0 + chunk, len);
    if (c0 >= c1) return;        // the combine reads only chunks below len

    const bf16* ckv_b = ckv + (size_t)b * S * R;
    const bf16* krope_b = krope + (size_t)b * S * DR;
    const int n_t = (c1 - c0 + TK - 1) / TK;
    // q, then the first two tiles, each its own cp.async group
    load_q_bf16(qs, q_lat, q_rope, b, H, h0);
    cp_async_commit();
    load_tile_bf16(kv, ckv_b, krope_b, c0, c1);
    cp_async_commit();
    if (n_t > 1) {
        load_tile_bf16(kv + TILE, ckv_b, krope_b, c0 + TK, c1);
        cp_async_commit();
        cp_async_wait<2>();
    } else {
        cp_async_wait<1>();
    }
    __syncthreads();                    // q landed

    // scores: this warp's k quarter (A: its q fragments, held) and 16 keys
    const int kq = warp % QUARTERS, np = warp / QUARTERS;
    uint32_t qa[KQ][4];
    {
        const uint32_t q_addr = smem_u32(qs) + (lane % 16) * ROW
            + (lane / 16) * 16 + kq * KQ * 32;
#pragma unroll
        for (int ks = 0; ks < KQ; ++ks) ldsm_x4(qa[ks], q_addr + ks * 32);
    }
    // ldmatrix lane offsets: keys (B of the scores; matrix i = lane / 8
    // holds keys 8 (i / 2) .., columns 8 (i % 2) ..), p (A of P.V) and
    // values (B of P.V, transposed: keys 8 (i % 2) .., columns 8 (i / 2))
    const int mi = lane / 8, mr = lane % 8;
    const uint32_t k_off = (16 * np + 8 * (mi / 2) + mr) * ROW
        + (mi % 2) * 16 + kq * KQ * 32;
    const uint32_t p_addr = smem_u32(ps) + (lane % 16) * PROW * 2
        + (lane / 16) * 16;
    const uint32_t v_off = (8 * (mi % 2) + mr) * ROW
        + (64 * warp + 8 * (mi / 2)) * 2;

    // softmax: head sh, keys sk and sk + 1 of each tile
    const int sh = tid / 16, sk = 2 * (tid % 16);
    float m = NEG_INF, l = 0.f;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

    for (int t = 0; t < n_t; ++t) {
        const int st = t & 1;
        const int j0 = c0 + t * TK;
        if (t + 1 < n_t)                // tile t + 1 may stay in flight
            cp_async_wait<1>();
        else
            cp_async_wait<0>();
        __syncthreads();                // tile t landed
        const uint32_t tile = smem_u32(kv + st * TILE);
        const int nk = min(TK, c1 - j0);

        float sc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KQ; ++ks) {
            uint32_t kb[4];
            ldsm_x4(kb, tile + k_off + ks * 32);
            mma_bf16(sc[0], qa[ks], kb[0], kb[1]);
            mma_bf16(sc[1], qa[ks], kb[2], kb[3]);
        }
        float* spq = sp + kq * HG * SROW;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int key = 16 * np + 8 * j + 2 * t4;
            *reinterpret_cast<float2*>(spq + g * SROW + key) =
                make_float2(sc[j][0], sc[j][1]);
            *reinterpret_cast<float2*>(spq + (g + 8) * SROW + key) =
                make_float2(sc[j][2], sc[j][3]);
        }
        __syncthreads();                // partial scores are published

        {
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int q = 0; q < QUARTERS; ++q) {
                const float2 x = *reinterpret_cast<const float2*>(
                    sp + (q * HG + sh) * SROW + sk);
                s0 += x.x;
                s1 += x.y;
            }
            s0 = sk < nk ? s0 * scale : NEG_INF;
            s1 = sk + 1 < nk ? s1 * scale : NEG_INF;
            float mx = fmaxf(s0, s1);
#pragma unroll
            for (int o = 8; o > 0; o >>= 1)      // the head's 16 threads
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m, mx);
            const float m_sub = fmaxf(m_new, 0.5f * NEG_INF);
            const float corr = expf(fmaxf(m, 0.5f * NEG_INF) - m_sub);
            const float p0 = expf(s0 - m_sub), p1 = expf(s1 - m_sub);
            l = l * corr + p0 + p1;
            m = m_new;
            *reinterpret_cast<__nv_bfloat162*>(ps + sh * PROW + sk) =
                __floats2bfloat162_rn(p0, p1);
            if (tid % 16 == 0) corr_s[sh] = corr;
        }
        __syncthreads();                // p and the factors are published

        {
            const float cr0 = corr_s[g], cr1 = corr_s[g + 8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                acc[j][0] *= cr0;
                acc[j][1] *= cr0;
                acc[j][2] *= cr1;
                acc[j][3] *= cr1;
            }
#pragma unroll
            for (int kv_step = 0; kv_step < TK / 16; ++kv_step) {
                if (16 * kv_step >= nk) break;    // no valid key in it
                uint32_t pa[4];
                ldsm_x4(pa, p_addr + kv_step * 32);
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) {
                    uint32_t vb[4];
                    ldsm_x4_trans(vb, tile + v_off + kv_step * 16 * ROW
                                          + jj * 32);
                    mma_bf16(acc[2 * jj], pa, vb[0], vb[1]);
                    mma_bf16(acc[2 * jj + 1], pa, vb[2], vb[3]);
                }
            }
        }
        __syncthreads();                // stage st, scores and p are free
        if (t + 2 < n_t) {
            load_tile_bf16(kv + st * TILE, ckv_b, krope_b, j0 + 2 * TK, c1);
            cp_async_commit();
        }
    }

#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, o);
    const size_t n_acc = (size_t)B * H * n_split * R;
    if (tid % 16 == 0 && h0 + sh < H) {
        float* ml = part + n_acc
            + (((size_t)b * H + h0 + sh) * n_split + split) * 2;
        ml[0] = m;
        ml[1] = l;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int col = 64 * warp + 8 * j + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int h = h0 + g + 8 * half;
            if (h < H)
                *reinterpret_cast<float2*>(
                    part + (((size_t)b * H + h) * n_split + split) * R
                    + col) = make_float2(acc[j][2 * half],
                                         acc[j][2 * half + 1]);
        }
    }
}

// ---------------------------------------------- float32, CUDA cores

namespace f32 {
constexpr int CH_R = R / 4;
constexpr int CH_K = DK / 4;
constexpr int ROW = DK * 4 + 16;
constexpr int TILE = TK * ROW;
constexpr int Q_BYTES = HG * DK * 4;
constexpr int P_BYTES = TK * HG * 4;
constexpr int SMEM = Q_BYTES + 2 * TILE + P_BYTES + HG * 4;
constexpr int PV_HEADS = 4;     // heads a P.V thread owns
constexpr int PV_COLS = 8;      // columns a P.V thread owns
static_assert(HG / PV_HEADS * R / PV_COLS == THREADS, "P.V covers [HG, R]");
static_assert(WARPS * 2 == HG && TK == 32, "a warp scores 2 heads");
}  // namespace f32

// positions [j0, min(j0 + TK, j1)) into a padded tile; rows at or past
// j1 are neither read nor written (the float32 kernel never reads them)
__device__ __forceinline__ void load_tile_f32(uint8_t* dst, const float* ckv,
                                              const float* krope, int j0,
                                              int j1) {
    const int rows = min(TK, j1 - j0);
    for (int i = threadIdx.x; i < rows * f32::CH_K; i += THREADS) {
        const int r = i / f32::CH_K, c = i % f32::CH_K;
        const float* src = c < f32::CH_R
            ? ckv + (size_t)(j0 + r) * R + c * 4
            : krope + (size_t)(j0 + r) * DR + (c - f32::CH_R) * 4;
        cp_async16(dst + r * f32::ROW + c * 16, src);
    }
}

__global__ void __launch_bounds__(THREADS)
mla_split_f32(const float* __restrict__ q_lat, const float* __restrict__ q_rope,
              const float* __restrict__ ckv, const float* __restrict__ krope,
              const int32_t* __restrict__ length, float* __restrict__ part,
              int B, int H, int S, int n_split, int chunk, float scale) {
    using namespace f32;
    extern __shared__ __align__(16) uint8_t smem[];
    float* qs = reinterpret_cast<float*>(smem);          // [HG][DK]
    uint8_t* kv = smem + Q_BYTES;                        // [2][TILE]
    float* ps = reinterpret_cast<float*>(kv + 2 * TILE);  // [TK][HG]
    float* corr_s = ps + TK * HG;                        // [HG]

    const int split = blockIdx.x;
    const int h0 = blockIdx.y * HG;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;

    const int len = max(0, min(length[b], S));
    const int c0 = split * chunk;
    const int c1 = min(c0 + chunk, len);
    if (c0 >= c1) return;        // the combine reads only chunks below len

    const float* ckv_b = ckv + (size_t)b * S * R;
    const float* krope_b = krope + (size_t)b * S * DR;
    const int n_t = (c1 - c0 + TK - 1) / TK;
    load_tile_f32(kv, ckv_b, krope_b, c0, c1);
    cp_async_commit();

    // the group's q as rows of DK (heads past H as zeros)
    for (int i = tid; i < HG * DK; i += THREADS) {
        const int hl = i / DK, d = i % DK, h = h0 + hl;
        float x = 0.f;
        if (h < H)
            x = d < R ? q_lat[((size_t)b * H + h) * R + d]
                      : q_rope[((size_t)b * H + h) * DR + d - R];
        qs[i] = x;
    }

    // scores: heads 2 warp + i, key lane of each tile; the carry of
    // those two heads lives in this warp (l per lane until the end)
    const int sh0 = 2 * warp;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    // P.V: heads pv_h .. pv_h + 3, columns pv_c .. pv_c + 7
    const int pv_h = (tid / (R / PV_COLS)) * PV_HEADS;
    const int pv_c = (tid % (R / PV_COLS)) * PV_COLS;
    float acc[PV_HEADS][PV_COLS];
#pragma unroll
    for (int i = 0; i < PV_HEADS; ++i)
#pragma unroll
        for (int e = 0; e < PV_COLS; ++e) acc[i][e] = 0.f;

    for (int t = 0; t < n_t; ++t) {
        const int st = t & 1;
        const int j0 = c0 + t * TK;
        if (t + 1 < n_t) {
            load_tile_f32(kv + (st ^ 1) * TILE, ckv_b, krope_b, j0 + TK, c1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                // tile t (and, at t = 0, q) landed
        const uint8_t* tile = kv + st * TILE;
        const int nk = min(TK, c1 - j0);

        float sc[2] = {NEG_INF, NEG_INF};
        if (lane < nk) {
            const float* krow = reinterpret_cast<const float*>(
                tile + lane * ROW);
            const float* q0 = qs + sh0 * DK;
            const float* q1 = q0 + DK;
            float d0 = 0.f, d1 = 0.f;
#pragma unroll 4
            for (int c = 0; c < CH_K; ++c) {
                const float4 k = *reinterpret_cast<const float4*>(
                    krow + 4 * c);
                const float4 a = *reinterpret_cast<const float4*>(
                    q0 + 4 * c);
                const float4 bq = *reinterpret_cast<const float4*>(
                    q1 + 4 * c);
                d0 = fmaf(a.x, k.x, d0);
                d0 = fmaf(a.y, k.y, d0);
                d0 = fmaf(a.z, k.z, d0);
                d0 = fmaf(a.w, k.w, d0);
                d1 = fmaf(bq.x, k.x, d1);
                d1 = fmaf(bq.y, k.y, d1);
                d1 = fmaf(bq.z, k.z, d1);
                d1 = fmaf(bq.w, k.w, d1);
            }
            sc[0] = d0 * scale;
            sc[1] = d1 * scale;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float m_new = fmaxf(m[i], warp_max(sc[i]));
            const float m_sub = fmaxf(m_new, 0.5f * NEG_INF);
            const float corr = expf(fmaxf(m[i], 0.5f * NEG_INF) - m_sub);
            const float p = expf(sc[i] - m_sub);
            l[i] = l[i] * corr + p;
            m[i] = m_new;
            ps[lane * HG + sh0 + i] = p;
            if (lane == 0) corr_s[sh0 + i] = corr;
        }
        __syncthreads();                // p and the factors are published

        {
            const float4 cf = *reinterpret_cast<const float4*>(corr_s + pv_h);
            const float cr[PV_HEADS] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
            for (int i = 0; i < PV_HEADS; ++i)
#pragma unroll
                for (int e = 0; e < PV_COLS; ++e) acc[i][e] *= cr[i];
            for (int r = 0; r < nk; ++r) {
                const float* vrow =
                    reinterpret_cast<const float*>(tile + r * ROW) + pv_c;
                const float4 v0 = *reinterpret_cast<const float4*>(vrow);
                const float4 v1 = *reinterpret_cast<const float4*>(vrow + 4);
                const float vv[PV_COLS] = {v0.x, v0.y, v0.z, v0.w,
                                           v1.x, v1.y, v1.z, v1.w};
                const float4 pf =
                    *reinterpret_cast<const float4*>(ps + r * HG + pv_h);
                const float pr[PV_HEADS] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
                for (int i = 0; i < PV_HEADS; ++i)
#pragma unroll
                    for (int e = 0; e < PV_COLS; ++e)
                        acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
            }
        }
        __syncthreads();                // stage st and P are free again
    }

    const size_t n_acc = (size_t)B * H * n_split * R;
#pragma unroll
    for (int i = 0; i < PV_HEADS; ++i) {
        const int h = h0 + pv_h + i;
        if (h >= H) continue;
        float* dst = part + (((size_t)b * H + h) * n_split + split) * R + pv_c;
#pragma unroll
        for (int e = 0; e < PV_COLS; e += 4)
            *reinterpret_cast<float4*>(dst + e) = make_float4(
                acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const float lt = warp_sum(l[i]);
        const int h = h0 + sh0 + i;
        if (lane == 0 && h < H) {
            float* ml = part + n_acc
                + (((size_t)b * H + h) * n_split + split) * 2;
            ml[0] = m[i];
            ml[1] = lt;
        }
    }
}

// ----------------------------------------------------------- combine

constexpr int C_THREADS = R / 4;    // a combine thread owns 4 columns

__device__ __forceinline__ void store4(float* o, float4 x) {
    *reinterpret_cast<float4*>(o) = x;
}
__device__ __forceinline__ void store4(bf16* o, float4 x) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o) = v;
}

// one CTA per (head, b): the chunks below length[b] in split order; the
// weights of up to C_THREADS chunks at a time in shared memory, each
// thread's 4 columns summed chunk by chunk
template <typename T>
__global__ void __launch_bounds__(C_THREADS)
mla_combine(const float* __restrict__ part, const int32_t* __restrict__ length,
            T* __restrict__ o, float* __restrict__ lse, int B, int H, int S,
            int n_split, int chunk) {
    __shared__ float w_s[C_THREADS], l_s[C_THREADS], red[C_THREADS / 32];
    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int len = max(0, min(length[b], S));
    const int live = min(n_split, (len + chunk - 1) / chunk);
    const size_t slot = ((size_t)b * H + h) * n_split;
    const float4* acc = reinterpret_cast<const float4*>(part + slot * R) + tid;
    const float2* ml = reinterpret_cast<const float2*>(
        part + (size_t)B * H * n_split * R + slot * 2);
    float mg = NEG_INF;
    for (int i = tid; i < live; i += C_THREADS) mg = fmaxf(mg, ml[i].x);
    mg = warp_max(mg);
    if (tid % 32 == 0) red[tid / 32] = mg;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < C_THREADS / 32; ++w) mg = fmaxf(mg, red[w]);
    const float m_sub = fmaxf(mg, 0.5f * NEG_INF);
    float lg = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = 0; base < live; base += C_THREADS) {
        const int n = min(C_THREADS, live - base);
        __syncthreads();            // the previous weights are read
        if (tid < n) {
            const float2 x = ml[base + tid];
            w_s[tid] = expf(fmaxf(x.x, 0.5f * NEG_INF) - m_sub);
            l_s[tid] = x.y;
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
            const float w = w_s[j];
            lg = fmaf(l_s[j], w, lg);
            const float4 x = acc[(size_t)(base + j) * (R / 4)];
            a.x = fmaf(x.x, w, a.x);
            a.y = fmaf(x.y, w, a.y);
            a.z = fmaf(x.z, w, a.z);
            a.w = fmaf(x.w, w, a.w);
        }
    }
    const float denom = fmaxf(lg, 1e-30f);
    store4(o + ((size_t)b * H + h) * R + 4 * tid,
           make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom));
    if (lse != nullptr && tid == 0)
        lse[(size_t)b * H + h] = lg > 0.f ? m_sub + logf(lg) : NEG_INF;
}

template <typename T, typename Kern>
int launch(Kern kern, int smem_bytes, const void* q_lat, const void* q_rope,
           const void* ckv, const void* krope, const int32_t* length,
           float* part, void* o, float* lse, int B, int H, int S, int n_split,
           int chunk, float scale, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_split, (H + HG - 1) / HG, B);
    kern<<<grid, THREADS, smem_bytes, stream>>>(
        static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
        static_cast<const T*>(ckv), static_cast<const T*>(krope), length,
        part, B, H, S, n_split, chunk, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mla_combine<T><<<dim3(H, B), C_THREADS, 0, stream>>>(
        part, length, static_cast<T*>(o), lse, B, H, S, n_split, chunk);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q_lat,
// q_rope, ckv, krope and out share it; q_lat [B, H, 512], q_rope [B, H,
// 64], ckv [B, S, 512], krope [B, S, 64], out [B, H, 512]; chunk a
// multiple of 32 with n_split * chunk >= S; scale is float32(1 /
// sqrt(576)); part is float32 scratch of B * H * n_split * (512 + 2)
// values; lse is NULL or a float32 [B, H] output: each row's
// log-sum-exp of its scaled scores
int pfdnn_flash_decode_mla(const void* q_lat, const void* q_rope,
                           const void* ckv, const void* krope,
                           const void* length, void* part, void* o, int B,
                           int H, int S, int r, int dr, int n_split,
                           int chunk, int dtype, float scale, void* stream,
                           void* lse) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* len = static_cast<const int32_t*>(length);
    float* p = static_cast<float*>(part);
    float* l = static_cast<float*>(lse);
    if (r != R || dr != DR || H <= 0 || n_split <= 0 || chunk <= 0
            || chunk % TK != 0 || (long long)n_split * chunk < S)
        return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(mla_split_f32, f32::SMEM, q_lat, q_rope, ckv,
                             krope, len, p, o, l, B, H, S, n_split, chunk,
                             scale, s);
    if (dtype == 1)
        return launch<bf16>(mla_split_bf16, tc::SMEM, q_lat, q_rope, ckv,
                            krope, len, p, o, l, B, H, S, n_split, chunk,
                            scale, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
