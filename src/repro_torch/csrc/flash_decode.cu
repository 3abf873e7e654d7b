// Hand-written Hopper kernels of the decode attention, split over the
// sequence (flash-decoding).
//
// Replaces the Pallas TPU kernel flash_decode
// (src/repro/kernels/flash_decode.py:68, _kernel at :25) and computes
// the same function: one query token per sequence, q [B, H, D], over a
// KV cache k/v [B, S, KH, D] of which the first length[b] positions are
// valid (query head h reads KV head h / (H / KH)).  Semantics kept from
// _kernel: s = dot(q, k) in float32 times 1/sqrt(D); positions at or
// past length[b] are masked (NEG_INF = -1e30, and never read); online
// softmax with a float32 (m, l, acc) carry and the reference clamped to
// max(m, 0.5 * NEG_INF); p rounded to V's dtype before P.V, float32
// accumulation; out = acc / max(l, 1e-30) in q's dtype.  A length of 0
// gives zeros, as the reference does.
//
// What bounds it on an H100: decode reads the whole valid cache once
// for about 4 * G flops per cached element, so it is byte-bound
// (3.35 TB/s of HBM3).  The design spreads those bytes over many SMs:
//
// Pass 1, grid (n_split, KH * head groups, B): the cache range of each
// (b, KV head) is cut into n_split chunks of ceil(S / n_split)
// positions; the wrapper picks n_split from S and the SM count only, so
// nothing reads length on the host.  A CTA whose chunk starts at or
// past length[b] writes an empty partial (m = NEG_INF, l = 0, acc = 0)
// and returns.  Otherwise the CTA serves up to 8 query heads of its
// group, one warp per head (G > 8 is cut into head groups), so each K/V
// row comes from device memory once per CTA.  Its threads stream 64-key
// K/V tiles into shared memory with 16-byte cp.async copies, two stages
// deep, so the next tile loads while this one computes (rows padded by
// 16 bytes: conflict-free 16-byte reads).  A warp keeps its head's q in
// registers; lane i scores keys i and i + 32 of a tile, one warp
// maximum per tile (five shuffles) updates (m, l), l stays per lane
// until the end; the rounded p goes to shared memory, and P.V runs with
// each lane owning 16 bytes of D for a stride of keys (16-byte V reads),
// reduced over the lanes once at the end in a fixed order.  The partial
// (m, l, acc[D]) of each (b, head, split) goes to float32 scratch that
// the wrapper allocates.
//
// Pass 2, grid (H, B): combines the n_split partials of each (b, head)
// in split order (no atomics: deterministic) with the clamp, and writes
// acc / max(l, 1e-30).  Where the caller passes an lse buffer, it also
// writes each row's log-sum-exp of the scaled scores, m + log(l) from
// the (m, l) it already holds (NEG_INF for a row with no valid key), so
// that ranks that each hold a slice of the cache can merge their
// partial softmaxes; with none it writes nothing more.
//
// The entry point returns cudaGetLastError() after both launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TK = 64;          // keys per tile
constexpr int MAX_WARPS = 8;    // query heads one CTA serves

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

template <typename T, int D>
struct DCfg {
    static constexpr int VN = Vec<T>::N;
    static constexpr int NCH = D / VN;                 // 16-byte chunks a row
    static constexpr int ROW = D * (int)sizeof(T) + 16;  // padded row bytes
    static constexpr int TILE = TK * ROW;
    static constexpr int NSUB = 32 / NCH;              // key strides in P.V
    static constexpr int SMEM = 4 * TILE                 // K, V x 2 stages
        + MAX_WARPS * TK * 4                           // rounded p
        + MAX_WARPS * NSUB * D * 4;                    // P.V reduction
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

// positions [j0, j1) of one (b, KV head) into a padded tile; rows at or
// past j1 are neither read nor written
template <typename T, int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const T* base,
                                          size_t pos_stride, int j0, int j1,
                                          int tid, int nthreads) {
    using C = DCfg<T, D>;
    const int rows = min(TK, j1 - j0);
    for (int i = tid; i < rows * C::NCH; i += nthreads) {
        const int r = i / C::NCH, c = i % C::NCH;
        cp_async16(dst + r * C::ROW + c * 16,
                   base + (size_t)(j0 + r) * pos_stride + c * C::VN);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ length,
                    float* __restrict__ part, int B, int H, int KH, int S,
                    int n_split, int chunk, int n_hg, int gw, float scale) {
    using C = DCfg<T, D>;
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* ks = smem;                                  // [2][TILE]
    uint8_t* vs = ks + 2 * C::TILE;                      // [2][TILE]
    float* pw = reinterpret_cast<float*>(vs + 2 * C::TILE);  // [warps][TK]
    float* red = pw + MAX_WARPS * TK;                    // [warps][NSUB * D]

    const int split = blockIdx.x;
    const int kh = blockIdx.y / n_hg;
    const int g = (blockIdx.y % n_hg) * gw + threadIdx.x / 32;
    const int b = blockIdx.z;
    const int G = H / KH;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const bool active = g < G;          // the last head group may be short
    const int h = kh * G + g;

    const int len = max(0, min(length[b], S));
    const int c0 = split * chunk;
    const int c1 = min(c0 + chunk, len);
    const size_t slot = ((size_t)b * H + h) * n_split + split;
    float* acc_out = part + slot * D;
    float* ml_out = part + (size_t)B * H * n_split * D + slot * 2;

    if (c0 >= c1) {
        if (active) {
            for (int d = lane; d < D; d += 32) acc_out[d] = 0.f;
            if (lane == 0) {
                ml_out[0] = NEG_INF;
                ml_out[1] = 0.f;
            }
        }
        return;
    }

    float qr[D];
    {
        const T* qg = q + ((size_t)b * H + (active ? h : kh * G)) * D;
#pragma unroll
        for (int d0 = 0; d0 < D; d0 += C::VN) Vec<T>::load(qg + d0, qr + d0);
    }

    const size_t pos_stride = (size_t)KH * D;
    const T* kb = k + (size_t)b * S * pos_stride + (size_t)kh * D;
    const T* vb = v + (size_t)b * S * pos_stride + (size_t)kh * D;

    // P.V: lane (sub, ch) owns columns ch * VN .. + VN for keys sub,
    // sub + NSUB, ...
    const int sub = lane / C::NCH;
    const int ch = lane % C::NCH;
    const bool pv_lane = sub < C::NSUB;

    float m = NEG_INF, l = 0.f;
    float acc[C::VN];
#pragma unroll
    for (int e = 0; e < C::VN; ++e) acc[e] = 0.f;

    const int n_t = (c1 - c0 + TK - 1) / TK;
    load_tile<T, D>(ks, kb, pos_stride, c0, c1, tid, nthreads);
    load_tile<T, D>(vs, vb, pos_stride, c0, c1, tid, nthreads);
    cp_async_commit();
    for (int t = 0; t < n_t; ++t) {
        const int st = t & 1;
        const int j0 = c0 + t * TK;
        if (t + 1 < n_t) {
            const int ns = st ^ 1;
            load_tile<T, D>(ks + ns * C::TILE, kb, pos_stride, j0 + TK, c1,
                            tid, nthreads);
            load_tile<T, D>(vs + ns * C::TILE, vb, pos_stride, j0 + TK, c1,
                            tid, nthreads);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        if (active) {
            const uint8_t* kt = ks + st * C::TILE;
            const uint8_t* vt = vs + st * C::TILE;
            float sc[2];
#pragma unroll
            for (int kl = 0; kl < 2; ++kl) {
                const int r = lane + 32 * kl;
                float dot = 0.f;
                if (j0 + r < c1) {
                    const T* krow = reinterpret_cast<const T*>(kt + r * C::ROW);
#pragma unroll
                    for (int d0 = 0; d0 < D; d0 += C::VN) {
                        float kv[C::VN];
                        Vec<T>::load(krow + d0, kv);
#pragma unroll
                        for (int e = 0; e < C::VN; ++e)
                            dot = fmaf(qr[d0 + e], kv[e], dot);
                    }
                }
                sc[kl] = j0 + r < c1 ? dot * scale : NEG_INF;
            }
            const float m_new = fmaxf(m, warp_max(fmaxf(sc[0], sc[1])));
            const float m_sub = fmaxf(m_new, 0.5f * NEG_INF);
            const float corr = expf(fmaxf(m, 0.5f * NEG_INF) - m_sub);
            const float p0 = expf(sc[0] - m_sub);
            const float p1 = expf(sc[1] - m_sub);
            l = l * corr + (p0 + p1);
            m = m_new;
            pw[warp * TK + lane] = to_f(from_f<T>(p0));
            pw[warp * TK + lane + 32] = to_f(from_f<T>(p1));
#pragma unroll
            for (int e = 0; e < C::VN; ++e) acc[e] *= corr;
            __syncwarp();
            if (pv_lane) {
                const int nk = min(TK, c1 - j0);
                for (int r = sub; r < nk; r += C::NSUB) {
                    float vv[C::VN];
                    Vec<T>::load(reinterpret_cast<const T*>(vt + r * C::ROW)
                                 + ch * C::VN, vv);
                    const float p = pw[warp * TK + r];
#pragma unroll
                    for (int e = 0; e < C::VN; ++e)
                        acc[e] = fmaf(p, vv[e], acc[e]);
                }
            }
            __syncwarp();
        }
        __syncthreads();                // stage st is free for tile t + 2
    }

    if (!active) return;
    l = warp_sum(l);
    float* rw = red + warp * C::NSUB * D;
    if (pv_lane) {
#pragma unroll
        for (int e = 0; e < C::VN; ++e) rw[sub * D + ch * C::VN + e] = acc[e];
    }
    __syncwarp();
    for (int d = lane; d < D; d += 32) {
        float a = 0.f;
#pragma unroll
        for (int s = 0; s < C::NSUB; ++s) a += rw[s * D + d];
        acc_out[d] = a;
    }
    if (lane == 0) {
        ml_out[0] = m;
        ml_out[1] = l;
    }
}

// one CTA of D threads per (head, b): the partials in split order
template <typename T, int D>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                      float* __restrict__ lse, int B, int H, int n_split) {
    const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const size_t slot = ((size_t)b * H + h) * n_split;
    const float* acc = part + slot * D;
    const float* ml = part + (size_t)B * H * n_split * D + slot * 2;
    float mg = NEG_INF;
    for (int i = 0; i < n_split; ++i) mg = fmaxf(mg, ml[2 * i]);
    const float m_sub = fmaxf(mg, 0.5f * NEG_INF);
    float lg = 0.f, a = 0.f;
    for (int i = 0; i < n_split; ++i) {
        const float w = expf(fmaxf(ml[2 * i], 0.5f * NEG_INF) - m_sub);
        lg = fmaf(ml[2 * i + 1], w, lg);
        a = fmaf(acc[(size_t)i * D + d], w, a);
    }
    o[((size_t)b * H + h) * D + d] = from_f<T>(a / fmaxf(lg, 1e-30f));
    if (lse != nullptr && d == 0)
        lse[(size_t)b * H + h] = lg > 0.f ? m_sub + logf(lg) : NEG_INF;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const int32_t* length, float* part, void* o, float* lse, int B,
           int H, int KH, int S, int n_split, float scale,
           cudaStream_t stream) {
    using C = DCfg<T, D>;
    const int G = H / KH;
    const int n_hg = (G + MAX_WARPS - 1) / MAX_WARPS;    // head groups
    const int gw = (G + n_hg - 1) / n_hg;                // heads a group
    const int chunk = (S + n_split - 1) / n_split;
    auto kern = decode_split_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(n_split, KH * n_hg, B);
    kern<<<grid, gw * 32, C::SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), length, part, B, H, KH, S, n_split, chunk,
        n_hg, gw, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_combine_kernel<T, D><<<dim3(H, B), D, 0, stream>>>(
        part, static_cast<T*>(o), lse, B, H, n_split);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const int32_t* length, float* part, void* o, float* lse,
             int B, int H, int KH, int S, int D, int n_split, float scale,
             cudaStream_t s) {
#define PFDNN_CASE(DD)                                                  \
    case DD:                                                            \
        return launch<T, DD>(q, k, v, length, part, o, lse, B, H, KH, S, \
                             n_split, scale, s);
    switch (D) {
        PFDNN_CASE(16) PFDNN_CASE(32) PFDNN_CASE(48) PFDNN_CASE(64)
        PFDNN_CASE(80) PFDNN_CASE(96) PFDNN_CASE(112) PFDNN_CASE(128)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PFDNN_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it);
// scale is float32(1 / sqrt(D)), as the reference rounds it; part is
// float32 scratch of B * H * n_split * (D + 2) values; lse is NULL or a
// float32 [B, H] output: each row's log-sum-exp of its scaled scores
int pfdnn_flash_decode(const void* q, const void* k, const void* v,
                       const void* length, void* part, void* o, int B,
                       int H, int KH, int S, int D, int n_split, int dtype,
                       float scale, void* stream, void* lse) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* len = static_cast<const int32_t*>(length);
    float* p = static_cast<float*>(part);
    float* l = static_cast<float*>(lse);
    if (KH <= 0 || H % KH != 0 || n_split <= 0)
        return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return dispatch<float>(q, k, v, len, p, o, l, B, H, KH, S, D,
                               n_split, scale, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, len, p, o, l, B, H, KH, S,
                                       D, n_split, scale, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
