// Hand-written Hopper kernel of the prefill attention in float32.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention.py:81, _kernel at :29) and computes
// the same function: causal or non-causal GQA attention of
// q [B, H, Sq, D] over k/v [B, KH, Sk, D] (query head h reads KV head
// h / (H / KH)), with queries at absolute positions q_offset + i.
// Semantics kept from _kernel:
//   * s = dot(q, k) in float32, then times 1/sqrt(D);
//   * masked scores are NEG_INF = -1e30 (causal: q_pos < k_pos; ragged
//     tail: k_pos >= Sk);
//   * online softmax with a float32 (m, l, acc) carry, the subtraction
//     reference clamped to max(m, 0.5 * NEG_INF) on both the new and the
//     previous maximum, so a fully masked row gives p = 0;
//   * l sums p in float32; p is rounded to V's dtype before P.V (this
//     matters in bf16); P.V accumulates in float32;
//   * out = acc / max(l, 1e-30), cast to q's dtype;
//   * KV tiles that lie wholly above the causal diagonal are skipped
//     (the Pallas kernel's pl.when on block indices).
//
// Design: one CTA of 256 threads owns a (batch, head, 64-row query
// tile).  It streams 64-key K/V tiles of its KV head through shared
// memory as float32; each thread computes a 4 x 4 block of the score
// tile and owns a 4 x (D/16) block of the output accumulator in
// registers; four threads share a query row for the softmax update.
// No divisibility constraint on Sq or Sk: ragged rows and keys are
// masked by index.  D is a template parameter (16..128, step 16).
//
// What bounds it on an H100: at the serving shapes (Sq = Sk = 1024,
// D = 64) the work is about 4 * D flops per unmasked (q, k) pair
// against 4 * D * elt bytes per row of q, k, v and out, so the
// function is FLOP-bound (989 TFLOP/s dense bf16 on the tensor cores;
// 67 TFLOP/s for float32, which the reference computes without TF32).
// This design runs the products as float32 FMAs on the CUDA cores from
// shared memory.  The tensor cores have no full-float32 product (TF32
// keeps ~10 mantissa bits), so float32 stays here; bfloat16 runs on the
// tensor cores in csrc/flash_attention_wgmma.cu.
//
// The entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;          // query rows per CTA
constexpr int BK = 64;          // keys per K/V tile
constexpr int THREADS = 256;    // 16 x 16 thread grid

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}

template <int D>
constexpr size_t smem_bytes() {
    // q and k tiles padded to D + 1 columns (conflict-free row reads),
    // v tile, p tile padded to BK + 1, one float per row
    return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D
                            + BQ * (BK + 1) + BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int H, int KH, int Sq, int Sk, int q_offset,
                       int causal, float scale) {
    constexpr int DP = D + 1;
    constexpr int PP = BK + 1;
    constexpr int NC = D / 16;          // output columns per thread
    extern __shared__ float smem[];
    float* qs = smem;                   // [BQ][DP]
    float* ks = qs + BQ * DP;           // [BK][DP]
    float* vs = ks + BK * DP;           // [BK][D]
    float* ps = vs + BK * D;            // [BQ][PP]
    float* row = ps + BQ * PP;          // [BQ]: corr, then l

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / KH);
    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    const T* qg = q + ((size_t)(b * H + h) * Sq) * D;
    const T* kg = k + ((size_t)(b * KH + kh) * Sk) * D;
    const T* vg = v + ((size_t)(b * KH + kh) * Sk) * D;

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D;
        qs[r * DP + c] = (q0 + r < Sq) ? to_f(qg[(size_t)(q0 + r) * D + c])
                                        : 0.f;
    }

    // KV tiles to run: all of them, or (causal) those that start at or
    // below the tile's last query position
    int n_tiles = (Sk + BK - 1) / BK;
    if (causal) {
        const int last = q_offset + min(q0 + BQ, Sq) - 1;
        n_tiles = last < 0 ? 0 : min(n_tiles, last / BK + 1);
    }

    // softmax state of row sr, held by its four threads
    const int sr = tid / 4;
    const int part = tid % 4;
    float m_row = NEG_INF, l_row = 0.f;

    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * BK;
        __syncthreads();                // previous tile fully consumed
        for (int i = tid; i < BK * D; i += THREADS) {
            const int r = i / D, c = i % D;
            const bool in = k0 + r < Sk;
            const size_t g = (size_t)(k0 + r) * D + c;
            ks[r * DP + c] = in ? to_f(kg[g]) : 0.f;
            vs[r * D + c] = in ? to_f(vg[g]) : 0.f;
        }
        __syncthreads();

        // scores: rows ty*4 + i, keys tx + 16*j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            float a[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * DP + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty * 4 + i;
            const int qpos = q_offset + q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j;
                const int kpos = k0 + c;
                const bool masked = kpos >= Sk || (causal && qpos < kpos);
                ps[r * PP + c] = masked ? NEG_INF : s[i][j] * scale;
            }
        }
        __syncthreads();

        // online softmax update of row sr over its 64 scores
        {
            float* prow = ps + sr * PP;
            float mt = NEG_INF;
#pragma unroll
            for (int c = 0; c < 16; ++c) mt = fmaxf(mt, prow[part * 16 + c]);
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
            const float m_new = fmaxf(m_row, mt);
            const float m_sub = fmaxf(m_new, 0.5f * NEG_INF);
            const float corr = expf(fmaxf(m_row, 0.5f * NEG_INF) - m_sub);
            float psum = 0.f;
            float p[16];
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                p[c] = expf(prow[part * 16 + c] - m_sub);
                psum += p[c];
            }
            __syncwarp();
#pragma unroll
            for (int c = 0; c < 16; ++c)
                prow[part * 16 + c] = to_f(from_f<T>(p[c]));
            psum += __shfl_xor_sync(0xffffffffu, psum, 1);
            psum += __shfl_xor_sync(0xffffffffu, psum, 2);
            l_row = l_row * corr + psum;
            m_row = m_new;
            if (part == 0) row[sr] = corr;
        }
        __syncthreads();

        // acc = acc * corr + P.V on rows ty*4 + i, columns tx + 16*j
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float corr = row[ty * 4 + i];
#pragma unroll
            for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
        }
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float pr[4], vv[NC];
#pragma unroll
            for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * PP + kk];
#pragma unroll
            for (int j = 0; j < NC; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < NC; ++j)
                    acc[i][j] = fmaf(pr[i], vv[j], acc[i][j]);
        }
    }

    __syncthreads();
    if (part == 0) row[sr] = l_row;
    __syncthreads();
    T* og = o + ((size_t)(b * H + h) * Sq) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        if (q0 + r >= Sq) continue;
        const float denom = fmaxf(row[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < NC; ++j)
            og[(size_t)(q0 + r) * D + tx + 16 * j] =
                from_f<T>(acc[i][j] / denom);
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Sq, int Sk, int q_offset, int causal,
           float scale, cudaStream_t stream) {
    constexpr size_t smem = smem_bytes<D>();
    auto kern = flash_attention_kernel<T, D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), H, KH, Sq, Sk,
        q_offset, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KH, int Sq, int Sk, int D, int q_offset,
             int causal, float scale, cudaStream_t s) {
#define PFDNN_CASE(DD)                                                  \
    case DD:                                                            \
        return launch<T, DD>(q, k, v, o, B, H, KH, Sq, Sk, q_offset,    \
                             causal, scale, s);
    switch (D) {
        PFDNN_CASE(16) PFDNN_CASE(32) PFDNN_CASE(48) PFDNN_CASE(64)
        PFDNN_CASE(80) PFDNN_CASE(96) PFDNN_CASE(112) PFDNN_CASE(128)
        default: return (int)cudaErrorInvalidValue;
    }
#undef PFDNN_CASE
}

}  // namespace

extern "C" {

// q, k, v and out are float32; scale is float32(1 / sqrt(D)), as the
// reference rounds it
int pfdnn_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int KH, int Sq,
                              int Sk, int D, int q_offset, int causal,
                              float scale, void* stream) {
    return dispatch<float>(q, k, v, o, B, H, KH, Sq, Sk, D, q_offset,
                           causal, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
