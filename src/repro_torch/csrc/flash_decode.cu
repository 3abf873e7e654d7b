// Hand-written Hopper kernel of the decode attention.
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
// Design: one CTA of 8 warps per (batch, KV head) serves the G = H / KH
// query heads of its group, so each K/V row is read from device memory
// once, not G times.  The warps split the valid length in 32-key tiles
// (tile t goes to warp t % 8).  In a tile, lane i scores key i against
// all G heads (its K row read as 16-byte vectors, q from shared
// memory); the warp updates each head's (m, l) with shuffles, stages the
// rounded p in shared memory and accumulates P.V with lanes split over
// D (coalesced V rows).  At the end the warps' partial (m, l, acc) are
// combined by log-sum-exp in shared memory, in warp order.
//
// What bounds it on an H100: decode reads the whole valid cache once
// for about 4 * G flops per cached element, so it is byte-bound
// (3.35 TB/s of HBM3).  This simple design leaves on the table: only
// B * KH CTAs (64 at B = 16, KH = 4, fewer than the 132 SMs), no split
// of one sequence across CTAs (flash-decoding's second pass), no
// cp.async/TMA prefetch of the next tile, and the per-key shuffles.
//
// The entry point returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NW = 8;           // warps per CTA
constexpr int THREADS = NW * 32;
constexpr int MAX_G = 16;       // query heads per KV head

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int32_t* __restrict__ length, T* __restrict__ o,
                    int H, int KH, int S, float scale) {
    constexpr int R = (D + 31) / 32;    // V columns per lane
    constexpr int VN = Vec<T>::N;
    __shared__ float qs[MAX_G][D];
    __shared__ float pw[NW][MAX_G][32];
    __shared__ float wm[NW][MAX_G];
    __shared__ float wl[NW][MAX_G];
    __shared__ float comb[MAX_G][D];

    const int kh = blockIdx.x;
    const int b = blockIdx.y;
    const int G = H / KH;
    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int len = max(0, min(length[b], S));

    const T* qg = q + ((size_t)b * H + (size_t)kh * G) * D;
    for (int i = tid; i < G * D; i += THREADS)
        qs[i / D][i % D] = to_f(qg[i]);
    __syncthreads();

    // rows of position j: k + (b * S + j) * KH * D + kh * D
    const size_t pos_stride = (size_t)KH * D;
    const T* kb = k + (size_t)b * S * pos_stride + (size_t)kh * D;
    const T* vb = v + (size_t)b * S * pos_stride + (size_t)kh * D;

    float m[MAX_G], l[MAX_G], acc[MAX_G][R];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
        m[g] = NEG_INF;
        l[g] = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[g][r] = 0.f;
    }

    for (int t0 = warp * 32; t0 < len; t0 += NW * 32) {
        const int j = t0 + lane;
        float s[MAX_G];
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
        if (j < len) {
            const T* krow = kb + (size_t)j * pos_stride;
#pragma unroll 2
            for (int d0 = 0; d0 < D; d0 += VN) {
                float kv[VN];
                Vec<T>::load(krow + d0, kv);
#pragma unroll
                for (int g = 0; g < MAX_G; ++g) {
                    if (g < G) {
#pragma unroll
                        for (int e = 0; e < VN; ++e)
                            s[g] = fmaf(qs[g][d0 + e], kv[e], s[g]);
                    }
                }
            }
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
                const float sg = j < len ? s[g] * scale : NEG_INF;
                const float m_new = fmaxf(m[g], warp_max(sg));
                const float m_sub = fmaxf(m_new, 0.5f * NEG_INF);
                const float p = expf(sg - m_sub);
                const float corr = expf(fmaxf(m[g], 0.5f * NEG_INF) - m_sub);
                l[g] = l[g] * corr + warp_sum(p);
                m[g] = m_new;
                pw[warp][g][lane] = to_f(from_f<T>(p));
#pragma unroll
                for (int r = 0; r < R; ++r) acc[g][r] *= corr;
            }
        }
        __syncwarp();
        const int n = min(32, len - t0);
        for (int i = 0; i < n; ++i) {
            const T* vrow = vb + (size_t)(t0 + i) * pos_stride;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int d = lane + 32 * r;
                if (d < D) {
                    const float vd = to_f(vrow[d]);
#pragma unroll
                    for (int g = 0; g < MAX_G; ++g)
                        if (g < G) acc[g][r] = fmaf(pw[warp][g][i], vd,
                                                    acc[g][r]);
                }
            }
        }
        __syncwarp();
    }

    // log-sum-exp combine of the warps' partials, in warp order
    if (lane == 0) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
                wm[warp][g] = m[g];
                wl[warp][g] = l[g];
            }
        }
    }
    __syncthreads();
    float own[MAX_G];                   // this warp's rescale factor
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
        own[g] = 0.f;
        if (g < G) {
            float mg = NEG_INF;
            for (int w = 0; w < NW; ++w) mg = fmaxf(mg, wm[w][g]);
            const float m_sub = fmaxf(mg, 0.5f * NEG_INF);
            own[g] = expf(fmaxf(m[g], 0.5f * NEG_INF) - m_sub);
        }
    }
    for (int w = 0; w < NW; ++w) {
        if (warp == w) {
#pragma unroll
            for (int g = 0; g < MAX_G; ++g) {
                if (g < G) {
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const int d = lane + 32 * r;
                        if (d < D) {
                            const float prev = w == 0 ? 0.f : comb[g][d];
                            comb[g][d] = fmaf(acc[g][r], own[g], prev);
                        }
                    }
                }
            }
        }
        __syncthreads();
    }
    T* og = o + ((size_t)b * H + (size_t)kh * G) * D;
    for (int i = tid; i < G * D; i += THREADS) {
        const int g = i / D;
        float mg = NEG_INF;
        for (int w = 0; w < NW; ++w) mg = fmaxf(mg, wm[w][g]);
        const float m_sub = fmaxf(mg, 0.5f * NEG_INF);
        float lg = 0.f;
        for (int w = 0; w < NW; ++w)
            lg += wl[w][g] * expf(fmaxf(wm[w][g], 0.5f * NEG_INF) - m_sub);
        og[i] = from_f<T>(comb[g][i % D] / fmaxf(lg, 1e-30f));
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v,
           const int32_t* length, void* o, int B, int H, int KH, int S,
           float scale, cudaStream_t stream) {
    dim3 grid(KH, B);
    flash_decode_kernel<T, D><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), length, static_cast<T*>(o), H, KH, S,
        scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const int32_t* length, void* o, int B, int H, int KH, int S,
             int D, float scale, cudaStream_t s) {
#define PFDNN_CASE(DD)                                                  \
    case DD:                                                            \
        return launch<T, DD>(q, k, v, length, o, B, H, KH, S, scale, s);
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
// scale is float32(1 / sqrt(D)), as the reference rounds it
int pfdnn_flash_decode(const void* q, const void* k, const void* v,
                       const void* length, void* o, int B, int H, int KH,
                       int S, int D, int dtype, float scale,
                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int32_t* len = static_cast<const int32_t*>(length);
    if (H % KH != 0 || H / KH > MAX_G) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return dispatch<float>(q, k, v, len, o, B, H, KH, S, D, scale, s);
    if (dtype == 1)
        return dispatch<__nv_bfloat16>(q, k, v, len, o, B, H, KH, S, D,
                                       scale, s);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
