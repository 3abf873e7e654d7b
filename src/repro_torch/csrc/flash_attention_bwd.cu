// Backward of the prefill attention kernels (flash_attention.cu,
// flash_attention_wgmma.cu): dQ, dK and dV of
//
//     O = softmax(mask(Q Kᵀ · scale)) V
//
// for q [B, H, Sq, D] over k/v [B, KH, Sk, D] (GQA: head h reads KV head
// h / (H / KH)), causal or not, queries at q_offset + i, an optional
// sliding window (keep q_pos - k_pos < window), in float32 or bf16 with
// float32 arithmetic throughout and the gradients written in q's dtype.
//
// It replaces no TPU kernel: the JAX package trains through
// flash_attention_jnp (src/repro/models/layers.py) under XLA's autodiff
// and has no Pallas backward.  It computes the same gradient, by the
// FlashAttention-2 split:
//
//   1. dq_kernel, one CTA a (query tile, head, batch): a first pass over
//      the key tiles the mask reaches recomputes each row's max m (with
//      the forward's 0.5·NEG_INF clamp) and sum l; δ = rowsum(dO ∘ O)
//      from the saved output; the three go to `stats` for pass 2.  A
//      second pass recomputes P = exp(S − m) / max(l, 1e-30), dP = dO Vᵀ,
//      dS = P ∘ (dP − δ) and accumulates dQ = dS K · scale.
//   2. dkv_kernel, one CTA a (key tile, KV head, batch): loops over the
//      group's query heads and the query tiles the mask reaches,
//      recomputes P and dS from `stats`, and accumulates dV = Pᵀ dO and
//      dK = dSᵀ Q · scale over the group, in order.
//
// No atomics: every output element is summed by one thread in a fixed
// order, so the gradient is the same bits run after run (the training
// drill's restart must repeat a step exactly).  A row that sees no key
// has P = 0 and gets zero gradient.  The forward kernels are untouched:
// their row statistics are recomputed here.
//
// Bound: the products.  Per kept (query, key) pair the backward runs
// QKᵀ three times (stats, dQ pass, dKV pass), dO Vᵀ twice, and dS K,
// Pᵀ dO, dSᵀ Q once each: 8 · D multiply-adds, 16 · D operations, on the
// CUDA cores (float32; 67 TFLOP/s on an H100 SXM).  The design keeps
// every tile in shared memory as float32 (rows padded by one float so
// that a warp's 16 column reads fall in 16 banks) and gives each of the
// 256 threads a 4 × 4 (4 × 2 at D = 192) piece of the score tile and of
// each gradient tile, so each multiply-add costs half a shared load.
// Tensor-core products are a follow-up (ROADMAP).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows a tile

template <int D> struct Tile {
  // keys a tile: two K/V, Q/dO and two score tiles of 64 keys would not
  // fit a block's 227 KB at D = 192
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int LD = D + 1;        // row stride of Q, dO, K, V
  static constexpr int LS = BK + 1;       // row stride of P, dS
  static constexpr int NJ = BK / 16;      // score columns a thread
  static constexpr int ND = D / 16;       // gradient columns a thread
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
};

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i,
                                        float x) {
  p[i] = __float2bfloat16(x);
}

// rows [row0, row0 + ROWS) of a [n, D] matrix into shared memory as
// float32 with row stride D + 1; rows past n are zeros
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int row0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? load_f(src, (size_t)g * D + c) : 0.f;
  }
}

__device__ __forceinline__ bool kept(int qpos, int k, int sk, int causal,
                                     int window) {
  return k < sk && (!causal || qpos >= k)
      && (window <= 0 || qpos - k < window);
}

// sum over the 16 threads of a half warp (the threads of one row)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// acc[i][j] = Σ_d A[ty + 16 i][d] · B[tx + 16 j][d]: the score-shaped
// product of two row-major tiles (stride D + 1)
template <int D, int NI, int NJ>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[NI][NJ],
                                              const float* a,
                                              const float* b, int ty,
                                              int tx) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[NI], bv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// 1. statistics and dQ --------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::MIN_BLOCKS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ o,
          const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ stats, int H, int KH, int Sq, int Sk,
          int q_offset, int causal, int window, float scale) {
  using P = Tile<D>;
  constexpr int BK = P::BK, LD = P::LD, LS = P::LS, NJ = P::NJ,
                ND = P::ND, NI = kBQ / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kBQ * LD;       // dO
  float* sK = sO + kBQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;        // dS

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int qt = n_qt - 1 - blockIdx.x;     // heaviest causal tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * kBQ;
  const size_t qbase = ((size_t)b * H + h) * Sq;
  const size_t kbase = ((size_t)b * KH + kh) * Sk;
  const size_t total = (size_t)gridDim.z * H * Sq;   // rows of stats

  // the key tiles any real row of this tile keeps
  const int last = min(q0 + kBQ, Sq) - 1;
  int k_hi = Sk, k_lo = 0;
  if (causal) k_hi = max(0, min(Sk, q_offset + last + 1));
  if (window > 0) k_lo = max(0, q_offset + q0 - window + 1);
  const int kt_lo = k_lo / BK;
  const int kt_hi = k_hi > k_lo ? (k_hi + BK - 1) / BK : kt_lo;

  load_tile<T, D, kBQ>(sQ, q + qbase * D, q0, Sq);
  load_tile<T, D, kBQ>(sO, dout + qbase * D, q0, Sq);

  // pass 1: m and l of each row, online, with the forward's clamp
  float m[NI], l[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) { m[i] = kNegInf; l[i] = 0.f; }
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D, BK>(sK, k + kbase * D, k0, Sk);
    __syncthreads();
    float s[NI][NJ];
    rows_dot_rows<D, NI, NJ>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = kept(qpos, k0 + tx + 16 * j, Sk, causal, window)
            ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_sub = fmaxf(m_new, 0.5f * kNegInf);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        sum += s[i][j] > 0.5f * kNegInf ? __expf(s[i][j] - m_sub) : 0.f;
      l[i] = l[i] * __expf(fmaxf(m[i], 0.5f * kNegInf) - m_sub)
          + row_sum(sum);
      m[i] = m_new;
    }
  }
  // per-row m (clamped), 1 / max(l, 1e-30) and δ = rowsum(dO ∘ O)
  float inv_l[NI], delta[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = q0 + ty + 16 * i;
    m[i] = fmaxf(m[i], 0.5f * kNegInf);
    inv_l[i] = 1.f / fmaxf(l[i], 1e-30f);
    float part = 0.f;
    if (r < Sq) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = tx + 16 * j;
        part += sO[(ty + 16 * i) * LD + c]
            * load_f(o, (qbase + r) * D + c);
      }
    }
    delta[i] = row_sum(part);
    if (tx == 0 && r < Sq) {
      stats[qbase + r] = m[i];
      stats[total + qbase + r] = inv_l[i];
      stats[2 * total + qbase + r] = delta[i];
    }
  }

  // pass 2: dQ = dS K over the same key tiles
  float acc[NI][ND];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D, BK>(sK, k + kbase * D, k0, Sk);
    load_tile<T, D, BK>(sV, v + kbase * D, k0, Sk);
    __syncthreads();
    float s[NI][NJ], dp[NI][NJ];
    rows_dot_rows<D, NI, NJ>(s, sQ, sK, ty, tx);
    rows_dot_rows<D, NI, NJ>(dp, sO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const float p = kept(qpos, k0 + c, Sk, causal, window)
            ? __expf(s[i][j] * scale - m[i]) * inv_l[i] : 0.f;
        sS[(ty + 16 * i) * LS + c] = p * (dp[i][j] - delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float av[NI], bv[ND];
#pragma unroll
      for (int i = 0; i < NI; ++i) av[i] = sS[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) bv[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      store_f(dq, (qbase + r) * D + tx + 16 * j, acc[i][j] * scale);
  }
}

// 2. dK and dV ----------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::MIN_BLOCKS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ stats, T* __restrict__ dk,
           T* __restrict__ dv, int H, int KH, int Sq, int Sk, int q_offset,
           int causal, int window, float scale) {
  using P = Tile<D>;
  constexpr int BK = P::BK, LD = P::LD, LS = P::LS, NJ = P::NJ,
                ND = P::ND, NI = kBQ / 16, NK = BK / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + kBQ * LD;       // dO
  float* sP = sO + kBQ * LD;
  float* sS = sP + kBQ * LS;       // dS
  float* sM = sS + kBQ * LS;       // m, 1/l, δ of the tile's rows
  float* sL = sM + kBQ;
  float* sD = sL + kBQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / KH;
  const int k0 = kt * BK;
  const size_t kbase = ((size_t)b * KH + kh) * Sk;
  const size_t total = (size_t)gridDim.z * H * Sq;

  // the query tiles with a row that keeps a key of this tile
  const int kmax = min(k0 + BK, Sk) - 1;
  int r_lo = 0, r_hi = Sq;
  if (causal) r_lo = max(0, k0 - q_offset);
  if (window > 0) r_hi = max(0, min(Sq, kmax + window - q_offset));
  const int qt_lo = r_lo / kBQ;
  const int qt_hi = r_hi > r_lo ? (r_hi + kBQ - 1) / kBQ : qt_lo;

  load_tile<T, D, BK>(sK, k + kbase * D, k0, Sk);
  load_tile<T, D, BK>(sV, v + kbase * D, k0, Sk);

  float adk[NK][ND], adv[NK][ND];
#pragma unroll
  for (int i = 0; i < NK; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) { adk[i][j] = 0.f; adv[i][j] = 0.f; }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const size_t qbase = ((size_t)b * H + h) * Sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();
      load_tile<T, D, kBQ>(sQ, q + qbase * D, q0, Sq);
      load_tile<T, D, kBQ>(sO, dout + qbase * D, q0, Sq);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool real = q0 + r < Sq;
        const size_t row = qbase + q0 + r;
        sM[r] = real ? stats[row] : 0.f;
        sL[r] = real ? stats[total + row] : 0.f;
        sD[r] = real ? stats[2 * total + row] : 0.f;
      }
      __syncthreads();
      float s[NI][NJ], dp[NI][NJ];
      rows_dot_rows<D, NI, NJ>(s, sQ, sK, ty, tx);
      rows_dot_rows<D, NI, NJ>(dp, sO, sV, ty, tx);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int r = ty + 16 * i;
        const int qpos = q_offset + q0 + r;
        const bool real = q0 + r < Sq;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = tx + 16 * j;
          const float p = real && kept(qpos, k0 + c, Sk, causal, window)
              ? __expf(s[i][j] * scale - sM[r]) * sL[r] : 0.f;
          sP[r * LS + c] = p;
          sS[r * LS + c] = p * (dp[i][j] - sD[r]);
        }
      }
      __syncthreads();
      // dV += Pᵀ dO, dK += dSᵀ Q over the tile's rows, in row order
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float pv[NK], sv[NK], ov[ND], qv[ND];
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          pv[i] = sP[r * LS + ty + 16 * i];
          sv[i] = sS[r * LS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          ov[j] = sO[r * LD + tx + 16 * j];
          qv[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < NK; ++i)
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            adv[i][j] = fmaf(pv[i], ov[j], adv[i][j]);
            adk[i][j] = fmaf(sv[i], qv[j], adk[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Sk) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const size_t at = (kbase + c) * D + tx + 16 * j;
      store_f(dk, at, adk[i][j] * scale);
      store_f(dv, at, adv[i][j]);
    }
  }
}

template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * kBQ + 2 * Tile<D>::BK) * Tile<D>::LD
                          + kBQ * Tile<D>::LS);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * ((2 * kBQ + 2 * Tile<D>::BK) * Tile<D>::LD
                          + 2 * kBQ * Tile<D>::LS + 3 * kBQ);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* stats,
           int B, int H, int KH, int Sq, int Sk, int q_offset, int causal,
           int window, float scale, cudaStream_t stream) {
  static_assert(dkv_smem<D>() <= 232448, "shared memory of a block");
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kThreads);
  if (Sq > 0) {
    dq_kernel<T, D><<<dim3((Sq + kBQ - 1) / kBQ, H, B), block, dq_smem<D>(),
                      stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)o,
        (const T*)dout, (T*)dq, stats, H, KH, Sq, Sk, q_offset, causal,
        window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Sk > 0) {
    constexpr int BK = Tile<D>::BK;
    dkv_kernel<T, D><<<dim3((Sk + BK - 1) / BK, KH, B), block,
                       dkv_smem<D>(), stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, stats,
        (T*)dk, (T*)dv, H, KH, Sq, Sk, q_offset, causal, window, scale);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* o, const void* dout, void* dq, void* dk, void* dv,
             float* stats, int B, int H, int KH, int Sq, int Sk,
             int q_offset, int causal, int window, float scale,
             cudaStream_t stream) {
#define PFDNN_BWD_CASE(DIM)                                               \
  case DIM:                                                               \
    return launch<T, DIM>(q, k, v, o, dout, dq, dk, dv, stats, B, H, KH, \
                          Sq, Sk, q_offset, causal, window, scale, stream);
  switch (D) {
    PFDNN_BWD_CASE(16)
    PFDNN_BWD_CASE(32)
    PFDNN_BWD_CASE(48)
    PFDNN_BWD_CASE(64)
    PFDNN_BWD_CASE(80)
    PFDNN_BWD_CASE(96)
    PFDNN_BWD_CASE(112)
    PFDNN_BWD_CASE(128)
    PFDNN_BWD_CASE(192)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PFDNN_BWD_CASE
}

}  // namespace

// dq [B, H, Sq, D] and dk, dv [B, KH, Sk, D] in the inputs' type (dtype
// 0: float32, 1: bfloat16) from q, k, v, the forward's output o and its
// cotangent dout; `stats` is float32 scratch of 3 · B · H · Sq values.
// Returns a cudaError_t (0 on success); launches on `stream`, does not
// synchronise and allocates nothing.
extern "C" int pfdnn_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
    int H, int KH, int Sq, int Sk, int D, int q_offset, int causal,
    int window, int dtype, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* st = (float*)stats;
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, dout, dq, dk, dv, st, B, H, KH,
                           Sq, Sk, q_offset, causal, window, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, dout, dq, dk, dv, st, B,
                                   H, KH, Sq, Sk, q_offset, causal, window,
                                   scale, s);
  return (int)cudaErrorInvalidValue;
}
