// Backward of the float32 prefill attention kernel (flash_attention.cu):
// dQ, dK and dV of
//
//     O = softmax(mask(Q Kᵀ · scale)) V
//
// for q [B, H, Sq, D] over k/v [B, KH, Sk, D] (GQA: head h reads KV head
// h / (H / KH)), causal or not, queries at q_offset + i, an optional
// sliding window (keep q_pos - k_pos < window), in float32 throughout.
// (bf16 has its own kernels on the tensor cores,
// flash_attention_bwd_wgmma.cu: the tensor cores have no full-float32
// product.)
//
// It replaces no TPU kernel: the JAX package trains through
// flash_attention_jnp (src/repro/models/layers.py) under XLA's autodiff
// and has no Pallas backward.  It computes the same gradient, by the
// FlashAttention-2 split, from the row statistics the forward kernel
// saved (`stats`: each row's clamped max m and 1 / max(l, 1e-30)):
//
//   1. dq_kernel, one CTA a (query tile, head, batch): δ = rowsum(dO ∘
//      O) from the saved output, to `delta` for pass 2; then over the
//      key tiles the mask reaches it recomputes P = exp(S − m) · (1 / l),
//      dP = dO Vᵀ, dS = P ∘ (dP − δ) and accumulates dQ = dS K · scale.
//   2. dkv_kernel, one CTA a (key tile, KV head, batch): loops over the
//      group's query heads and the query tiles the mask reaches,
//      recomputes P and dS, and accumulates dV = Pᵀ dO and dK = dSᵀ Q ·
//      scale over the group, in order.
//
// No atomics: every output element is summed by one thread in a fixed
// order, so the gradient is the same bits run after run (the training
// drill's restart must repeat a step exactly).  A row that sees no key
// has P = 0 and gets zero gradient.
//
// Bound: the products.  Per kept (query, key) pair the backward runs
// QKᵀ twice (dQ pass, dKV pass), dO Vᵀ twice, and dS K, Pᵀ dO, dSᵀ Q
// once each: 7 · D multiply-adds, 14 · D operations, on the CUDA cores
// (float32; 67 TFLOP/s on an H100 SXM).  The design keeps every tile in
// shared memory (rows padded by one float so that a warp's 16 column
// reads fall in 16 banks) and gives each of the 256 threads a 4 × 4
// (4 × 2 at D = 192) piece of the score tile and of each gradient tile,
// so each multiply-add costs half a shared load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// rows [row0, row0 + ROWS) of a [n, D] matrix into shared memory with
// row stride D + 1; rows past n are zeros
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < n ? src[(size_t)g * D + c] : 0.f;
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

// 1. δ and dQ --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::MIN_BLOCKS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, float* __restrict__ dq,
          const float* __restrict__ stats, float* __restrict__ delta_out,
          int H, int KH, int Sq, int Sk, int q_offset, int causal,
          int window, float scale) {
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

  load_tile<D, kBQ>(sQ, q + qbase * D, q0, Sq);
  load_tile<D, kBQ>(sO, dout + qbase * D, q0, Sq);
  __syncthreads();

  // per-row m, 1 / max(l, 1e-30) (the forward's) and δ = rowsum(dO ∘ O)
  float m[NI], inv_l[NI], delta[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = q0 + ty + 16 * i;
    m[i] = r < Sq ? stats[qbase + r] : 0.f;
    inv_l[i] = r < Sq ? stats[total + qbase + r] : 0.f;
    float part = 0.f;
    if (r < Sq) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int c = tx + 16 * j;
        part += sO[(ty + 16 * i) * LD + c]
            * o[(qbase + r) * D + c];
      }
    }
    delta[i] = row_sum(part);
    if (tx == 0 && r < Sq) delta_out[qbase + r] = delta[i];
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
    load_tile<D, BK>(sK, k + kbase * D, k0, Sk);
    load_tile<D, BK>(sV, v + kbase * D, k0, Sk);
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
      dq[(qbase + r) * D + tx + 16 * j] = acc[i][j] * scale;
  }
}

// 2. dK and dV ----------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::MIN_BLOCKS)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ stats,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, int H, int KH, int Sq, int Sk, int q_offset,
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

  load_tile<D, BK>(sK, k + kbase * D, k0, Sk);
  load_tile<D, BK>(sV, v + kbase * D, k0, Sk);

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
      load_tile<D, kBQ>(sQ, q + qbase * D, q0, Sq);
      load_tile<D, kBQ>(sO, dout + qbase * D, q0, Sq);
      for (int r = tid; r < kBQ; r += kThreads) {
        const bool real = q0 + r < Sq;
        const size_t row = qbase + q0 + r;
        sM[r] = real ? stats[row] : 0.f;
        sL[r] = real ? stats[total + row] : 0.f;
        sD[r] = real ? delta[row] : 0.f;
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
      dk[at] = adk[i][j] * scale;
      dv[at] = adv[i][j];
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

template <int D>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, float* dq, float* dk, float* dv,
           const float* stats, float* delta, int B, int H, int KH, int Sq,
           int Sk, int q_offset, int causal, int window, float scale,
           cudaStream_t stream) {
  static_assert(dkv_smem<D>() <= 232448, "shared memory of a block");
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kThreads);
  if (Sq > 0) {
    dq_kernel<D><<<dim3((Sq + kBQ - 1) / kBQ, H, B), block,
                          dq_smem<D>(), stream>>>(
        q, k, v, o, dout, dq, stats, delta, H, KH, Sq, Sk, q_offset,
        causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (Sk > 0) {
    constexpr int BK = Tile<D>::BK;
    dkv_kernel<D><<<dim3((Sk + BK - 1) / BK, KH, B), block,
                           dkv_smem<D>(), stream>>>(
        q, k, v, dout, stats, delta, dk, dv, H, KH, Sq, Sk, q_offset,
        causal, window, scale);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// dq [B, H, Sq, D] and dk, dv [B, KH, Sk, D], float32, from q, k, v, the
// forward's output o and its cotangent dout; `stats` holds the forward's
// float32 [2, B · H · Sq] row statistics (m, 1 / max(l, 1e-30)); `delta`
// is float32 scratch of B · H · Sq values.  Returns a cudaError_t (0 on
// success); launches on `stream`, does not synchronise and allocates
// nothing.
extern "C" int pfdnn_flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const void* stats,
    void* delta, int B, int H, int KH, int Sq, int Sk, int D, int q_offset,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define PFDNN_BWD_CASE(DIM)                                                \
  case DIM:                                                                \
    return launch<DIM>((const float*)q, (const float*)k, (const float*)v,  \
                       (const float*)o, (const float*)dout, (float*)dq,    \
                       (float*)dk, (float*)dv, (const float*)stats,        \
                       (float*)delta, B, H, KH, Sq, Sk, q_offset, causal,  \
                       window, scale, s);
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
