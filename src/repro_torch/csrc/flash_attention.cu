// Hand-written Hopper kernel of the prefill attention in float32, on the
// CUDA cores.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:81, _kernel at :29) and computes
// the same function: causal or non-causal GQA attention of
// q [B, H, Sq, D] over k/v [B, KH, Sk, D] (query head h reads KV head
// h / (H / KH)), with queries at absolute positions q_offset + i, and
// optionally a sliding window (window > 0 keeps the keys with q_pos -
// k_pos < window, the mask of the reference's flash_attention_jnp, which
// hymba's prefill computes).  Semantics kept from _kernel:
//   * s = dot(q, k) in float32, then times 1/sqrt(D);
//   * masked scores are NEG_INF = -1e30 (causal: q_pos < k_pos; ragged
//     tail: k_pos >= Sk; window: q_pos - k_pos >= window);
//   * online softmax with a float32 (m, l, acc) carry, the subtraction
//     reference clamped to max(m, 0.5 * NEG_INF) on both the new and the
//     previous maximum, so a row that sees no key gives zeros;
//   * l sums p in float32; P.V accumulates in float32;
//   * out = acc / max(l, 1e-30);
//   * KV tiles that lie wholly above the causal diagonal, or wholly
//     below the window of every row of the CTA, are skipped.
// Any Sq, Sk and q_offset (negative too), every D in 16..128 (step 16)
// and D = 192 (MLA's prefill head, hd + dr = 128 + 64).
//
// What bounds it on an H100: about 4 * D operations per unmasked (q, k)
// pair against 16 * D bytes per row of q, k, v and out, so the function
// is bound by the float32 rate of the CUDA cores (67 TFLOP/s; the
// reference computes without TF32, and TF32 would keep ~10 mantissa
// bits).  Two SM resources pace the products: the FFMA issue (an SM
// sub-partition issues one warp instruction a clock, so every other
// instruction costs an FFMA slot), and the shared-memory loads that feed
// the FFMAs, which on the H100 served a 16-byte load at about half the
// cost when each pair of neighbouring lanes read one address.
//
// Design (the first port ran 4 x 4 score tiles from 8 scalar loads, sent
// the scores through shared memory to a softmax of four threads a row,
// loaded K/V synchronously and ran causal tiles light first):
//   * one CTA of 8 warps owns a (batch, head, 128-row query tile); a
//     warp owns 16 rows, and a lane the 4 rows 4 tr .. 4 tr + 3 and, of
//     each BK-key tile, the BK / 8 keys tc + 8 j and the D / 8 output
//     columns of group tc (tr = lane % 4, tc = lane / 4).  Each lane
//     pair shares its keys and columns, so the K and V loads cost half.
//     BK is 64, and 32 at D = 192: there two stages of 64-key K and V
//     tiles beside the Q tile would take 305 KB of shared memory, more
//     than a block may have (227 KB), and 32-key tiles take 206 KB;
//   * S = Q K^T: Q is stored transposed ([D][128], one float4 gives a
//     lane its 4 rows at one d), K row-major with rows padded by 16
//     bytes (float4 along d; the 8 keys of a load hit distinct banks).
//     A step of 4 d takes 8 K and 4 Q loads for 128 FFMA, each FFMA
//     independent of the next 31;
//   * the softmax stays in registers and works in unscaled units (the
//     maximum of s * scale is scale times the maximum of s; the masks
//     and the clamp are divided by scale), p = exp2(s * scale * log2 e -
//     m * scale * log2 e) is one FFMA and one ex2.approx; a row lives in
//     the 8 lanes of its tr, so its maximum takes three shuffles and no
//     barrier, and l is kept per lane and summed over them once, at the
//     end;
//   * P goes to shared memory once, 16 keys at a time (a quarter of a
//     64-key tile; the warp's own region, a __syncwarp around each), key-major
//     so a lane reads its 4 rows of a key with one float4; P.V reads V
//     rows along D (float4 where D is a multiple of 32, else float2);
//   * K and V tiles arrive by 16-byte cp.async (rows past Sk as zeros)
//     into two stages: after the one barrier a tile, the CTA issues tile
//     t + 1 into the stage tile t - 1 used, and computes tile t while it
//     lands.  At D <= 64 a CTA takes <= 106 KB and 128 registers a
//     thread, so two CTAs (16 warps) share an SM and hide each other's
//     load and shuffle latencies;
//   * the loops over d (one 16-byte chunk a step) and over the P
//     quarters are not unrolled: the tile loop's code stays small (fully
//     unrolled, it ran far slower), and at D <= 64 nothing spills at 128
//     registers (two chunks a step spilled);
//   * blocks run heaviest query tile first (block i takes query tile
//     n_qt - 1 - i / (B * H)), so the long causal rows start first and
//     the tail is short; neighbouring blocks share a KV head in L2;
//   * only tiles that cross the diagonal, the window's lower edge or the
//     Sk edge are masked; a warp skips tiles wholly above its own rows'
//     diagonal or wholly below its rows' window (a warp's 16 rows can
//     see a tile that the CTA's first row cannot, so its bound is its
//     own); the CTA's loop starts at the tile of its first row's lowest
//     key.  The window is a template parameter, so the kernel without
//     one is the windowless kernel, instruction for instruction.
// Slower on the H100 at the serving shape, while this design was
// chosen: 8 x 8 tiles a lane (4 warps, 255 registers, 8 warps an SM),
// and the other lane order (tc in the low bits).
//
// When the caller passes a `stats` buffer (training: autograd needs the
// gradient), an instance of its own (template parameter STATS) also
// writes each row's clamped maximum m (scaled units) and 1 / max(l,
// 1e-30) there at the end, for the backward (flash_attention_bwd.cu);
// serving passes none and runs the kernel without the write.
//
// The entry point returns cudaGetLastError() of its launch;
// pfdnn_flash_attention_f32_plan reports the tiling of a head dim.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BQ = 128;     // query rows per CTA
constexpr int RM = 4;       // rows per lane
constexpr int TR = 4;       // row groups of a warp (lane % 4)
constexpr int TC = 8;       // key / column groups of a warp (lane / 4)
constexpr int WR = TR * RM; // rows per warp
constexpr int WARPS = BQ / WR;
constexpr int THREADS = 32 * WARPS;
constexpr int PK = 16;      // keys of a P part (two keys a lane)
// shared memory an SM holds, and what the runtime keeps per CTA
constexpr int SM_SMEM = 233472, CTA_RESERVED = 1024;

template <int D>
struct Cfg {
    static constexpr int BK = D > 128 ? 32 : 64;       // keys per K/V tile
    static constexpr int KJ = BK / TC;                 // keys a lane a tile
    static constexpr int NPART = BK / PK;              // P parts a tile
    static constexpr int NCH = D / 4;                  // 16-byte chunks a row
    static constexpr int LD = D + 4;                   // K row stride, floats
    static constexpr int VEC = D % 32 == 0 ? 4 : 2;    // V/O floats an access
    static constexpr int NV = D / (TC * VEC);          // accesses a row
    static constexpr int NO = NV * VEC;                // output columns a lane
    static constexpr int Q_FL = D * BQ;
    static constexpr int K_FL = BK * LD;
    static constexpr int V_FL = BK * D;
    static constexpr int P_FL = WARPS * PK * WR;
    static constexpr int SMEM = 4 * (Q_FL + 2 * K_FL + 2 * V_FL + P_FL);
    // two CTAs an SM where shared memory allows (then 128 registers)
    static constexpr int MIN_BLOCKS =
        2 * (SMEM + CTA_RESERVED) <= SM_SMEM ? 2 : 1;
    static_assert(BQ * NCH % THREADS == 0 && BK * NCH % THREADS == 0,
                  "tile loads split evenly over the threads");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float part(const float4& x, int e) {
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// p of keys tc + 8 j (j = J, J + 1) into the warp's P part, key-major:
// the lane's 4 rows of a key side by side
template <int J, int KJ>
__device__ __forceinline__ void store_p(float* p_lane, int tc,
                                        const float (&s)[RM][KJ]) {
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
        *reinterpret_cast<float4*>(p_lane + (tc + 8 * jj) * WR) =
            make_float4(s[0][J + jj], s[1][J + jj], s[2][J + jj],
                        s[3][J + jj]);
}

// the thread index, read anew: offsets derived from it are recomputed
// where they are used instead of being held across the tile loop
__device__ __forceinline__ int fresh_tid() {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
}

// rows [r0, r0 + ROWS) of a [S, D] matrix into ROWS rows of LD floats;
// rows at or past S as zeros
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int S) {
    constexpr int NCH = D / 4;
    const int tid = fresh_tid();
    if constexpr (THREADS % NCH == 0) {
        // a thread keeps its chunk; its rows step by THREADS / NCH (the
        // index arithmetic of the general path below spilled at D = 64)
        constexpr int STEP = THREADS / NCH;
        const int r = tid / NCH, c = tid % NCH;
        float* d = dst + r * LD + c * 4;
        const float* g = src + (size_t)(r0 + r) * D + c * 4;
#pragma unroll
        for (int it = 0; it < ROWS / STEP; ++it) {
            const bool in = r0 + r + it * STEP < S;
            cp_async16(d + it * STEP * LD, in ? g + it * STEP * D : src,
                       in ? 16 : 0);
        }
    } else {
#pragma unroll
        for (int it = 0; it < ROWS * NCH / THREADS; ++it) {
            const int id = tid + it * THREADS;
            const int r = id / NCH, c = id % NCH;
            const bool in = r0 + r < S;
            cp_async16(dst + r * LD + c * 4,
                       in ? src + (size_t)(r0 + r) * D + c * 4 : src,
                       in ? 16 : 0);
        }
    }
}

template <int D, bool WINDOW, bool STATS>
__global__ void __launch_bounds__(THREADS, Cfg<D>::MIN_BLOCKS)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int B, int H, int KH,
                           int Sq, int Sk, int q_offset, int causal,
                           int window, float scale, int n_qt,
                           float* __restrict__ stats) {
    using C = Cfg<D>;
    constexpr int LD = C::LD, BK = C::BK, KJ = C::KJ;
    constexpr int VEC = C::VEC, NV = C::NV, NO = C::NO;
    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                  // [D][BQ]: Q transposed
    float* ks = qs + C::Q_FL;          // [2][BK][LD]
    float* vs = ks + 2 * C::K_FL;      // [2][BK][D]
    float* ps = vs + 2 * C::V_FL;      // [WARPS][PK][WR]

    const int bh_n = B * H;
    const int qt = n_qt - 1 - (int)(blockIdx.x / bh_n);
    const int bh = blockIdx.x % bh_n;
    const int b = bh / H, h = bh % H;
    const int kh = h / (H / KH);
    const int q0 = qt * BQ;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int tr = lane % TR, tc = lane / TR;

    const float* qg = q + (size_t)(b * H + h) * Sq * D;
    const float* kg = k + (size_t)(b * KH + kh) * Sk * D;
    const float* vg = v + (size_t)(b * KH + kh) * Sk * D;

    // KV tiles the CTA runs, [t_lo, n_tiles), and those its warp
    // computes: all, or (causal) those that start at or below the last
    // row's position, and (window) from the tile of the first row's
    // lowest key
    int n_tiles = (Sk + BK - 1) / BK;
    if (causal) {
        const int last = q_offset + min(q0 + BQ, Sq) - 1;
        n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
    }
    int t_lo = 0;
    if constexpr (WINDOW) {
        const int lo_key = q_offset + q0 - window + 1;
        t_lo = lo_key > 0 ? lo_key / BK : 0;
    }
    const int w_first = q0 + warp * WR;
    const int w_rows = min(WR, Sq - w_first);
    int w_tiles = w_rows > 0 ? n_tiles : 0;
    if (causal && w_rows > 0) {
        const int last = q_offset + w_first + w_rows - 1;
        w_tiles = last < 0 ? 0 : min(w_tiles, last / BK + 1);
    }

    if (n_tiles > t_lo) {
        // tile t lives in stage t & 1
        load_rows<D, BK, LD>(ks + (t_lo & 1) * C::K_FL, kg, t_lo * BK, Sk);
        load_rows<D, BK, D>(vs + (t_lo & 1) * C::V_FL, vg, t_lo * BK, Sk);
        cp_async_commit();
        // the Q tile transposed, qs[d][r] = q[q0 + r][d] (rows past Sq as
        // zeros); the first barrier of the loop publishes it
#pragma unroll 1
        for (int it = 0; it < BQ * C::NCH / THREADS; ++it) {
            const int id = tid + it * THREADS;
            const int r = id % BQ, c = id / BQ;
            float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
            if (q0 + r < Sq)
                x = *reinterpret_cast<const float4*>(
                    qg + (size_t)(q0 + r) * D + c * 4);
            qs[(4 * c) * BQ + r] = x.x;
            qs[(4 * c + 1) * BQ + r] = x.y;
            qs[(4 * c + 2) * BQ + r] = x.z;
            qs[(4 * c + 3) * BQ + r] = x.w;
        }
    }

    // unscaled units: s * scale is compared with the clamp in natural
    // units, so the masks and the clamp are divided by scale
    const float c2 = scale * LOG2E;
    const float mask_raw = NEG_INF / scale;
    const float clamp_raw = 0.5f * NEG_INF / scale;

    float m[RM], l[RM], acc[RM][NO];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        m[i] = mask_raw;
        l[i] = 0.f;
#pragma unroll
        for (int n = 0; n < NO; ++n) acc[i][n] = 0.f;
    }

    const float* qcol = qs + warp * WR + tr * RM;
    float* p_lane = ps + warp * (PK * WR) + tr * RM;

    for (int t = t_lo; t < n_tiles; ++t) {
        // tile t has landed, and every warp is done with tile t - 1
        cp_async_wait_all();
        __syncthreads();
        if (t + 1 < n_tiles) {
            const int st = (t + 1) & 1;
            load_rows<D, BK, LD>(ks + st * C::K_FL, kg, (t + 1) * BK, Sk);
            load_rows<D, BK, D>(vs + st * C::V_FL, vg, (t + 1) * BK, Sk);
            cp_async_commit();
        }
        if (t >= w_tiles) continue;     // above this warp's diagonal
        const int k0 = t * BK;
        // below the window of this warp's first row (and so of all its
        // rows); the row is recomputed, not held across the loop
        if (WINDOW
            && k0 + BK - 1 < q_offset + q0 + fresh_tid() / 32 * WR - window + 1)
            continue;
        const float* kt = ks + (t & 1) * C::K_FL + tc * LD;
        const float* vt = vs + (t & 1) * C::V_FL + tc * VEC;

        // S = Q K^T on rows 4 tr + i, keys tc + 8 j
        float s[RM][KJ];
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
#pragma unroll 1
        for (int c = 0; c < C::NCH; ++c) {
            float4 kf[KJ];
#pragma unroll
            for (int j = 0; j < KJ; ++j)
                kf[j] = *reinterpret_cast<const float4*>(
                    kt + j * 8 * LD + c * 4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float4 qv = *reinterpret_cast<const float4*>(
                    qcol + (c * 4 + e) * BQ);
#pragma unroll
                for (int j = 0; j < KJ; ++j) {
                    const float kv = part(kf[j], e);
                    s[0][j] = fmaf(qv.x, kv, s[0][j]);
                    s[1][j] = fmaf(qv.y, kv, s[1][j]);
                    s[2][j] = fmaf(qv.z, kv, s[2][j]);
                    s[3][j] = fmaf(qv.w, kv, s[3][j]);
                }
            }
        }

        // the warp's first row, recomputed here: held across the loop it
        // would be the one register past 128 at D = 64
        const int first = q_offset + q0 + fresh_tid() / 32 * WR;
        if (k0 + BK > Sk || (causal && k0 + BK - 1 > first)
            || (WINDOW && k0 <= first + WR - 1 - window)) {
#pragma unroll
            for (int i = 0; i < RM; ++i) {
                const int qpos = first + tr * RM + i;
                const int lim = causal ? min(qpos, Sk - 1) : Sk - 1;
                const int lo = WINDOW ? qpos - window : INT_MIN;
#pragma unroll
                for (int j = 0; j < KJ; ++j) {
                    const int kp = k0 + tc + 8 * j;
                    if (kp > lim || kp <= lo) s[i][j] = mask_raw;
                }
            }
        }

        // online softmax update; s becomes p.  The 8 lanes of a row
        // differ in lane bits 2-4.
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            float mt = s[i][0];
#pragma unroll
            for (int j = 1; j < KJ; ++j) mt = fmaxf(mt, s[i][j]);
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 4));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 8));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 16));
            const float m_new = fmaxf(m[i], mt);
            const float m_sub = fmaxf(m_new, clamp_raw);
            const float corr = ex2((fmaxf(m[i], clamp_raw) - m_sub) * c2);
            const float mc = m_sub * c2;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < KJ; ++j) {
                s[i][j] = ex2(fmaf(s[i][j], c2, -mc));
                sum += s[i][j];
            }
            l[i] = l[i] * corr + sum;
            m[i] = m_new;
#pragma unroll
            for (int n = 0; n < NO; ++n) acc[i][n] *= corr;
        }

        // acc += P V, 16 keys (keys tc + 8 j of j = 2 hf, 2 hf + 1 from
        // each lane) at a time through shared memory
#pragma unroll 1
        for (int hf = 0; hf < C::NPART; ++hf) {
            __syncwarp();               // the lanes are done with the last one
            if constexpr (KJ == 8) {
                switch (hf) {
                    case 0: store_p<0>(p_lane, tc, s); break;
                    case 1: store_p<2>(p_lane, tc, s); break;
                    case 2: store_p<4>(p_lane, tc, s); break;
                    default: store_p<6>(p_lane, tc, s); break;
                }
            } else {
                if (hf == 0) store_p<0>(p_lane, tc, s);
                else store_p<2>(p_lane, tc, s);
            }
            __syncwarp();
            const float* vh = vt + hf * PK * D;
#pragma unroll
            for (int kk = 0; kk < PK; ++kk) {
                const float4 pf =
                    *reinterpret_cast<const float4*>(p_lane + kk * WR);
                const float pr[RM] = {pf.x, pf.y, pf.z, pf.w};
                float vv[NO];
#pragma unroll
                for (int n = 0; n < NV; ++n) {
                    const float* src = vh + kk * D + n * TC * VEC;
                    if constexpr (VEC == 4) {
                        const float4 x = *reinterpret_cast<const float4*>(src);
                        vv[4 * n] = x.x;
                        vv[4 * n + 1] = x.y;
                        vv[4 * n + 2] = x.z;
                        vv[4 * n + 3] = x.w;
                    } else {
                        const float2 x = *reinterpret_cast<const float2*>(src);
                        vv[2 * n] = x.x;
                        vv[2 * n + 1] = x.y;
                    }
                }
#pragma unroll
                for (int i = 0; i < RM; ++i)
#pragma unroll
                    for (int n = 0; n < NO; ++n)
                        acc[i][n] = fmaf(pr[i], vv[n], acc[i][n]);
            }
        }
    }
    float* og = o + (size_t)(b * H + h) * Sq * D + tc * VEC;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(0xffffffffu, lt, 4);
        lt += __shfl_xor_sync(0xffffffffu, lt, 8);
        lt += __shfl_xor_sync(0xffffffffu, lt, 16);
        const int r = q0 + fresh_tid() / 32 * WR + tr * RM + i;
        if (r >= Sq) continue;
        const float inv = 1.f / fmaxf(lt, 1e-30f);
        if constexpr (STATS) {
            if (tc == 0) {
                // the row's statistics for the backward: m in scaled
                // units (clamped as the softmax clamps it), 1 / max(l,
                // 1e-30)
                const size_t at = (size_t)(b * H + h) * Sq + r;
                stats[at] = fmaxf(m[i], clamp_raw) * scale;
                stats[(size_t)B * H * Sq + at] = inv;
            }
        }
#pragma unroll
        for (int n = 0; n < NV; ++n) {
            float* dst = og + (size_t)r * D + n * TC * VEC;
            if constexpr (VEC == 4) {
                *reinterpret_cast<float4*>(dst) = make_float4(
                    acc[i][4 * n] * inv, acc[i][4 * n + 1] * inv,
                    acc[i][4 * n + 2] * inv, acc[i][4 * n + 3] * inv);
            } else {
                *reinterpret_cast<float2*>(dst) = make_float2(
                    acc[i][2 * n] * inv, acc[i][2 * n + 1] * inv);
            }
        }
    }
}

template <int D, bool WINDOW, bool STATS>
cudaError_t configure() {
    auto kern = flash_attention_f32_kernel<D, WINDOW, STATS>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
}

template <int D, bool WINDOW, bool STATS>
int launch_with(const float* q, const float* k, const float* v, float* o,
                int B, int H, int KH, int Sq, int Sk, int q_offset,
                int causal, int window, float scale, float* stats,
                cudaStream_t stream) {
    const cudaError_t err = configure<D, WINDOW, STATS>();
    if (err != cudaSuccess) return (int)err;
    const int n_qt = (Sq + BQ - 1) / BQ;
    const long long blocks = (long long)n_qt * H * B;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    flash_attention_f32_kernel<D, WINDOW, STATS><<<(unsigned)blocks, THREADS,
                                                    Cfg<D>::SMEM, stream>>>(
        q, k, v, o, B, H, KH, Sq, Sk, q_offset, causal, window, scale, n_qt,
        stats);
    return (int)cudaGetLastError();
}

// the instance that writes the statistics is a template of its own, so
// that serving runs the kernel without them, instruction for instruction
template <int D, bool WINDOW>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int H, int KH, int Sq, int Sk, int q_offset, int causal,
           int window, float scale, float* stats, cudaStream_t stream) {
    return stats != nullptr
        ? launch_with<D, WINDOW, true>(q, k, v, o, B, H, KH, Sq, Sk,
                                       q_offset, causal, window, scale,
                                       stats, stream)
        : launch_with<D, WINDOW, false>(q, k, v, o, B, H, KH, Sq, Sk,
                                        q_offset, causal, window, scale,
                                        nullptr, stream);
}

template <int D>
int plan(int* out) {
    const cudaError_t err = configure<D, false, false>();
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flash_attention_f32_kernel<D, false, false>, THREADS,
        Cfg<D>::SMEM);
    if (occ != cudaSuccess) return (int)occ;
    out[0] = BQ;
    out[1] = Cfg<D>::BK;
    out[2] = THREADS;
    out[3] = RM;
    out[4] = Cfg<D>::SMEM;
    out[5] = per_sm;
    return 0;
}

}  // namespace

#define PFDNN_HEAD_DIMS(X) \
    X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(192)

extern "C" {

// q, k, v and out are float32; scale is float32(1 / sqrt(D)), as the
// reference rounds it; window > 0 is the sliding window (0: none);
// stats (NULL: none) receives float32 [2, B * H * Sq]: each row's m and
// 1 / max(l, 1e-30), for the backward
int pfdnn_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KH, int Sq,
                              int Sk, int D, int q_offset, int causal,
                              int window, float scale, void* stats,
                              void* stream) {
    const auto* qf = static_cast<const float*>(q);
    const auto* kf = static_cast<const float*>(k);
    const auto* vf = static_cast<const float*>(v);
    auto* of = static_cast<float*>(o);
    auto* st = static_cast<float*>(stats);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PFDNN_CASE(DD)                                                  \
    case DD:                                                            \
        return window > 0                                               \
            ? launch<DD, true>(qf, kf, vf, of, B, H, KH, Sq, Sk,        \
                               q_offset, causal, window, scale, st, s)  \
            : launch<DD, false>(qf, kf, vf, of, B, H, KH, Sq, Sk,       \
                                q_offset, causal, 0, scale, st, s);
    switch (D) {
        PFDNN_HEAD_DIMS(PFDNN_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PFDNN_CASE
}

// the tiling of head dim D on the current device: out[0..5] = query rows
// a CTA, keys a tile, threads a CTA, rows a lane, shared-memory bytes a
// CTA, CTAs an SM holds
int pfdnn_flash_attention_f32_plan(int D, int* out) {
#define PFDNN_CASE(DD) \
    case DD:           \
        return plan<DD>(out);
    switch (D) {
        PFDNN_HEAD_DIMS(PFDNN_CASE)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PFDNN_CASE
}

}  // extern "C"
