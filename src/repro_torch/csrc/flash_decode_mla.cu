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
// reference clamped to max(m, 0.5 * NEG_INF); p rounded to the cache's
// dtype before P.V, float32 accumulation; out = acc / max(l, 1e-30) in
// q's dtype.  A length of 0 gives zeros.
//
// Nothing is concatenated: each key tile is scored from the two cache
// tensors and takes its values from the ckv rows already in shared
// memory, so the latent is read from device memory once.
//
// Pass 1, grid (n_split, head groups, B), 256 threads: the cache range
// of each sequence is cut into n_split chunks of ceil(S / n_split)
// positions (the wrapper picks n_split from S and the SM count only).
// A CTA serves HG = 16 query heads (deepseek-v2-lite's 16: every head
// of the latent), so each cache row is read once for the whole group.
// Its threads stream 32-key tiles of [ckv | krope] rows into shared
// memory by 16-byte cp.async, two stages deep (rows padded by 16 bytes:
// conflict-free 16-byte reads), while the group's q sits in shared
// memory as float32.  Scores: warp w owns heads 2w and 2w + 1 and lane j
// key j of the tile; the warp's maximum (five shuffles) updates (m, l)
// in the same registers, the rounded p goes to shared memory key-major
// with the factor that rescales the accumulators.  P.V: thread t owns
// heads 4 (t / 64) .. + 3 and the 8 columns 8 (t % 64) .. + 7 of the
// 512, 32 float32 accumulators.  The partial (m, l, acc[512]) of each
// (b, head, split) goes to float32 scratch that the wrapper allocates.
//
// Pass 2, grid (H, B): combines the n_split partials of each (b, head)
// in split order (no atomics: deterministic) with the clamp, and writes
// acc / max(l, 1e-30).
//
// What bounds it on an H100: the cache is read once, 1152 bytes a
// position in bf16, for 2 * 1088 flops a position and head, so at 16
// heads the work is about 30 flops a byte: byte-bound against the
// tensor cores, operation-bound against the CUDA cores this version
// runs on (a tensor-core version is a later step).
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
constexpr int TK = 32;          // keys per tile
constexpr int HG = 16;          // query heads per CTA
constexpr int THREADS = 256;
constexpr int PV_HEADS = 4;     // heads a P.V thread owns
constexpr int PV_COLS = 8;      // columns a P.V thread owns
static_assert(HG / PV_HEADS * R / PV_COLS == THREADS, "P.V covers [HG, R]");
static_assert(THREADS / 32 * 2 == HG && TK == 32, "a warp scores 2 heads");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// 16 bytes of T as floats
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int N = 4;
    static __device__ __forceinline__ void load(const float* p, float* out) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    }
};
template <> struct Vec<__nv_bfloat16> {
    static constexpr int N = 8;
    static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                                float* out) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            out[2 * i] = f.x;
            out[2 * i + 1] = f.y;
        }
    }
};

template <typename T>
struct MCfg {
    static constexpr int VN = Vec<T>::N;
    static constexpr int CH_R = R / VN;                // 16-byte chunks of ckv
    static constexpr int CH_K = DK / VN;               // of a key row
    static constexpr int ROW = DK * (int)sizeof(T) + 16;   // padded row bytes
    static constexpr int TILE = TK * ROW;
    static constexpr int Q_BYTES = HG * DK * 4;
    static constexpr int P_BYTES = TK * HG * 4;
    static constexpr int SMEM = Q_BYTES + 2 * TILE + P_BYTES + HG * 4;
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// positions [j0, min(j0 + TK, j1)) of one sequence into a padded tile of
// [ckv | krope] rows; rows at or past j1 are neither read nor written
template <typename T>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* ckv,
                                          const T* krope, int j0, int j1) {
    using C = MCfg<T>;
    const int rows = min(TK, j1 - j0);
    for (int i = threadIdx.x; i < rows * C::CH_K; i += THREADS) {
        const int r = i / C::CH_K, c = i % C::CH_K;
        const T* src = c < C::CH_R
            ? ckv + (size_t)(j0 + r) * R + c * C::VN
            : krope + (size_t)(j0 + r) * DR + (c - C::CH_R) * C::VN;
        cp_async16(dst + r * C::ROW + c * 16, src);
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mla_split_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                 const T* __restrict__ ckv, const T* __restrict__ krope,
                 const int32_t* __restrict__ length,
                 float* __restrict__ part, int B, int H, int S,
                 int n_split, int chunk, float scale) {
    using C = MCfg<T>;
    extern __shared__ __align__(16) uint8_t smem[];
    float* qs = reinterpret_cast<float*>(smem);          // [HG][DK]
    uint8_t* kv = smem + C::Q_BYTES;                     // [2][TILE]
    float* ps = reinterpret_cast<float*>(kv + 2 * C::TILE);  // [TK][HG]
    float* corr_s = ps + TK * HG;                        // [HG]

    const int split = blockIdx.x;
    const int h0 = blockIdx.y * HG;
    const int b = blockIdx.z;
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;

    const int len = max(0, min(length[b], S));
    const int c0 = split * chunk;
    const int c1 = min(c0 + chunk, len);
    const size_t n_acc = (size_t)B * H * n_split * R;

    if (c0 >= c1) {
        for (int i = tid; i < HG * R; i += THREADS) {
            const int h = h0 + i / R;
            if (h < H)
                part[(((size_t)b * H + h) * n_split + split) * R + i % R] = 0.f;
        }
        if (tid < HG && h0 + tid < H) {
            float* ml = part + n_acc
                + (((size_t)b * H + h0 + tid) * n_split + split) * 2;
            ml[0] = NEG_INF;
            ml[1] = 0.f;
        }
        return;
    }

    const T* ckv_b = ckv + (size_t)b * S * R;
    const T* krope_b = krope + (size_t)b * S * DR;
    const int n_t = (c1 - c0 + TK - 1) / TK;
    load_tile<T>(kv, ckv_b, krope_b, c0, c1);
    cp_async_commit();

    // the group's q as float32 rows of DK (heads past H as zeros)
    for (int i = tid; i < HG * DK; i += THREADS) {
        const int hl = i / DK, d = i % DK, h = h0 + hl;
        float x = 0.f;
        if (h < H)
            x = d < R ? to_f(q_lat[((size_t)b * H + h) * R + d])
                      : to_f(q_rope[((size_t)b * H + h) * DR + d - R]);
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
            load_tile<T>(kv + (st ^ 1) * C::TILE, ckv_b, krope_b, j0 + TK, c1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                // tile t (and, at t = 0, q) landed
        const uint8_t* tile = kv + st * C::TILE;
        const int nk = min(TK, c1 - j0);

        float sc[2] = {NEG_INF, NEG_INF};
        if (lane < nk) {
            const T* krow = reinterpret_cast<const T*>(tile + lane * C::ROW);
            const float* q0 = qs + sh0 * DK;
            const float* q1 = q0 + DK;
            float d0 = 0.f, d1 = 0.f;
#pragma unroll 4
            for (int c = 0; c < C::CH_K; ++c) {
                float kf[C::VN];
                Vec<T>::load(krow + c * C::VN, kf);
#pragma unroll
                for (int e = 0; e < C::VN; e += 4) {
                    const float4 a = *reinterpret_cast<const float4*>(
                        q0 + c * C::VN + e);
                    const float4 bq = *reinterpret_cast<const float4*>(
                        q1 + c * C::VN + e);
                    d0 = fmaf(a.x, kf[e], d0);
                    d0 = fmaf(a.y, kf[e + 1], d0);
                    d0 = fmaf(a.z, kf[e + 2], d0);
                    d0 = fmaf(a.w, kf[e + 3], d0);
                    d1 = fmaf(bq.x, kf[e], d1);
                    d1 = fmaf(bq.y, kf[e + 1], d1);
                    d1 = fmaf(bq.z, kf[e + 2], d1);
                    d1 = fmaf(bq.w, kf[e + 3], d1);
                }
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
            ps[lane * HG + sh0 + i] = to_f(from_f<T>(p));
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
                const T* vrow =
                    reinterpret_cast<const T*>(tile + r * C::ROW) + pv_c;
                float vv[PV_COLS];
#pragma unroll
                for (int e = 0; e < PV_COLS; e += C::VN)
                    Vec<T>::load(vrow + e, vv + e);
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

// one CTA per (head, b): the partials in split order, R columns
template <typename T>
__global__ void __launch_bounds__(THREADS)
mla_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                   int B, int H, int n_split) {
    const int h = blockIdx.x, b = blockIdx.y;
    const size_t slot = ((size_t)b * H + h) * n_split;
    const float* acc = part + slot * R;
    const float* ml = part + (size_t)B * H * n_split * R + slot * 2;
    float mg = NEG_INF;
    for (int i = 0; i < n_split; ++i) mg = fmaxf(mg, ml[2 * i]);
    const float m_sub = fmaxf(mg, 0.5f * NEG_INF);
    float lg = 0.f;
    for (int i = 0; i < n_split; ++i)
        lg = fmaf(ml[2 * i + 1], expf(fmaxf(ml[2 * i], 0.5f * NEG_INF) - m_sub),
                  lg);
    const float denom = fmaxf(lg, 1e-30f);
    for (int d = threadIdx.x; d < R; d += THREADS) {
        float a = 0.f;
        for (int i = 0; i < n_split; ++i) {
            const float w = expf(fmaxf(ml[2 * i], 0.5f * NEG_INF) - m_sub);
            a = fmaf(acc[(size_t)i * R + d], w, a);
        }
        o[((size_t)b * H + h) * R + d] = from_f<T>(a / denom);
    }
}

template <typename T>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const int32_t* length, float* part, void* o,
           int B, int H, int S, int n_split, float scale,
           cudaStream_t stream) {
    using C = MCfg<T>;
    const int chunk = (S + n_split - 1) / n_split;
    auto kern = mla_split_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_split, (H + HG - 1) / HG, B);
    kern<<<grid, THREADS, C::SMEM, stream>>>(
        static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
        static_cast<const T*>(ckv), static_cast<const T*>(krope), length,
        part, B, H, S, n_split, chunk, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mla_combine_kernel<T><<<dim3(H, B), THREADS, 0, stream>>>(
        part, static_cast<T*>(o), B, H, n_split);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q_lat, q_rope, ckv, krope and out
// share it); q_lat [B, H, 512], q_rope [B, H, 64], ckv [B, S, 512],
// krope [B, S, 64], out [B, H, 512]; scale is float32(1 / sqrt(576));
// part is float32 scratch of B * H * n_split * (512 + 2) values
int pfdnn_flash_decode_mla(const void* q_lat, const void* q_rope,
                           const void* ckv, const void* krope,
                           const void* length, void* part, void* o, int B,
                           int H, int S, int r, int dr, int n_split,
                           int dtype, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* len = static_cast<const int32_t*>(length);
    float* p = static_cast<float*>(part);
    if (r != R || dr != DR || H <= 0 || n_split <= 0)
        return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return launch<float>(q_lat, q_rope, ckv, krope, len, p, o, B, H, S,
                             n_split, scale, s);
    if (dtype == 1)
        return launch<__nv_bfloat16>(q_lat, q_rope, ckv, krope, len, p, o, B,
                                     H, S, n_split, scale, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
