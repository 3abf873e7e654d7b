// Hand-written Hopper kernels of the subset-stacked rail sweep.
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (src/repro/kernels/dp_sweep.py) and computes the same function, bit
// for bit, on float64 lane tensors that live in a device mirror of a
// BucketStack ([cap, L, S] node tensors, [cap, L-1, S, S] transition
// tensors).  Lanes are gathered by index inside the kernel, so a sweep
// round moves no operand bytes from the host.
//
//   pfdnn_dp_multi         <- dp_multi_stacked_pallas     (_dp_kernel)
//   pfdnn_kbest_multi      <- kbest_multi_stacked_pallas  (_kbest_kernel)
//   pfdnn_path_components  <- path_components_pallas     (_gather_kernel)
//
// Bit-identity with the numpy reference rests on three rules:
//   * every product and sum is rounded on its own (__dmul_rn /
//     __dadd_rn, and the build passes --fmad=false besides), in the
//     reference's order: node = (w_e*e_op) + (w_t*t_op), edge cost =
//     ((w_e*e_trans) + (w_t*t_trans)) + cost;
//   * argmin scans previous states in index order with a strict '<',
//     which is numpy's first-occurrence tie rule;
//   * the k-best lists take candidates in flat (sp*k + r) order and
//     insert behind equal values, which is the stable (value, index)
//     order of the reference's argsort.
// Invalid (and padded) states cost +inf after weighting; padded slots
// of the transition tensors hold finite values, so no NaN can arise.
//
// What bounds them on an H100: the DP and k-best kernels read each
// lane's [L-1, S, S] transition slabs once per weight column (K times),
// so they are bound by L2 bandwidth and by the serial layer recurrence,
// not by HBM; the gather is a handful of dependent loads per thread.
// The design keeps the recurrence's state (one cost row, or an [S, k]
// k-best slab) in shared memory and only the backpointers in global
// scratch.  Making them fast (several columns per CTA, staged
// transition tiles) is later work.
//
// Every entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ double node_cost(const double* e_op,
                                            const double* t_op,
                                            const uint8_t* valid, int o,
                                            double we, double wt) {
    if (!valid[o]) return CUDART_INF;
    return __dadd_rn(__dmul_rn(we, e_op[o]), __dmul_rn(wt, t_op[o]));
}

// One CTA per (lane, weight column), one thread per next state.
__global__ void dp_kernel(const double* __restrict__ t_op,
                          const double* __restrict__ e_op,
                          const uint8_t* __restrict__ valid,
                          const double* __restrict__ t_trans,
                          const double* __restrict__ e_trans,
                          const int64_t* __restrict__ lanes,
                          const double* __restrict__ w_e,
                          const double* __restrict__ w_t,
                          int32_t* __restrict__ parents,
                          int32_t* __restrict__ out,
                          int K, int L, int S) {
    extern __shared__ double cost[];                    // [S]
    const int bq = blockIdx.x;
    const int sn = threadIdx.x;
    const int64_t lane = lanes[bq / K];
    const double we = w_e[bq];
    const double wt = w_t[bq];
    const size_t ls = (size_t)L * S;
    const double* top = t_op + lane * ls;
    const double* eop = e_op + lane * ls;
    const uint8_t* val = valid + lane * ls;
    const size_t slab = (size_t)S * S;
    const double* ttr = t_trans + lane * (size_t)(L - 1) * slab;
    const double* etr = e_trans + lane * (size_t)(L - 1) * slab;
    int32_t* par = parents + (size_t)bq * (L - 1) * S;

    cost[sn] = node_cost(eop, top, val, sn, we, wt);
    __syncthreads();
    for (int i = 1; i < L; ++i) {
        const double* tt = ttr + (size_t)(i - 1) * slab + sn;
        const double* et = etr + (size_t)(i - 1) * slab + sn;
        double best = __dadd_rn(
            __dadd_rn(__dmul_rn(we, et[0]), __dmul_rn(wt, tt[0])), cost[0]);
        int arg = 0;
        for (int sp = 1; sp < S; ++sp) {
            const double v = __dadd_rn(
                __dadd_rn(__dmul_rn(we, et[(size_t)sp * S]),
                          __dmul_rn(wt, tt[(size_t)sp * S])),
                cost[sp]);
            if (v < best) {
                best = v;
                arg = sp;
            }
        }
        const double nd = node_cost(eop, top, val, i * S + sn, we, wt);
        __syncthreads();                 // every thread has read cost
        cost[sn] = __dadd_rn(best, nd);
        par[(size_t)(i - 1) * S + sn] = arg;
        __syncthreads();
    }
    if (sn == 0) {
        double best = cost[0];
        int s = 0;
        for (int sp = 1; sp < S; ++sp) {
            if (cost[sp] < best) {
                best = cost[sp];
                s = sp;
            }
        }
        int32_t* o = out + (size_t)bq * L;
        o[L - 1] = s;
        for (int i = L - 2; i >= 0; --i) {
            s = par[(size_t)i * S + s];
            o[i] = s;
        }
    }
}

// Stable top-k insertion: the list (vals, idx) holds the n <= k best
// candidates seen so far in (value, arrival) order; a new candidate
// goes behind every value it does not beat.
__device__ __forceinline__ void topk_insert(double* vals, int32_t* idx,
                                            int& n, int k, double v,
                                            int32_t j) {
    if (n == k && !(v < vals[k - 1])) return;
    int pos = n < k ? n : k - 1;
    while (pos > 0 && v < vals[pos - 1]) {
        vals[pos] = vals[pos - 1];
        idx[pos] = idx[pos - 1];
        --pos;
    }
    vals[pos] = v;
    idx[pos] = j;
    if (n < k) ++n;
}

// One CTA per (lane, μ), one thread per next state; the [S, k] cost
// slab of the previous layer and the next one sit in shared memory.
__global__ void kbest_kernel(const double* __restrict__ t_op,
                             const double* __restrict__ e_op,
                             const uint8_t* __restrict__ valid,
                             const double* __restrict__ t_trans,
                             const double* __restrict__ e_trans,
                             const int64_t* __restrict__ lanes,
                             const double* __restrict__ mus,
                             int32_t* __restrict__ back,
                             int32_t* __restrict__ paths,
                             int32_t* __restrict__ counts,
                             int K, int L, int S, int k) {
    extern __shared__ double smem[];
    double* cur = smem;                                 // [S * k]
    double* nxt = cur + (size_t)S * k;                  // [S * k]
    int32_t* nidx = (int32_t*)(nxt + (size_t)S * k);    // [S * k]
    const int bq = blockIdx.x;
    const int sn = threadIdx.x;
    const int64_t lane = lanes[bq / K];
    const double mu = mus[bq];
    const size_t ls = (size_t)L * S;
    const double* top = t_op + lane * ls;
    const double* eop = e_op + lane * ls;
    const uint8_t* val = valid + lane * ls;
    const size_t slab = (size_t)S * S;
    const double* ttr = t_trans + lane * (size_t)(L - 1) * slab;
    const double* etr = e_trans + lane * (size_t)(L - 1) * slab;
    int32_t* bk = back + (size_t)bq * (L - 1) * k * S;

    cur[sn * k] = node_cost(eop, top, val, sn, 1.0, mu);
    for (int r = 1; r < k; ++r) cur[sn * k + r] = CUDART_INF;
    __syncthreads();
    for (int i = 1; i < L; ++i) {
        const double* tt = ttr + (size_t)(i - 1) * slab + sn;
        const double* et = etr + (size_t)(i - 1) * slab + sn;
        double* lv = nxt + (size_t)sn * k;
        int32_t* li = nidx + (size_t)sn * k;
        int n = 0;
        for (int sp = 0; sp < S; ++sp) {
            const double edge = __dadd_rn(et[(size_t)sp * S],
                                          __dmul_rn(mu, tt[(size_t)sp * S]));
            const double* c = cur + (size_t)sp * k;
            for (int r = 0; r < k; ++r)
                topk_insert(lv, li, n, k, __dadd_rn(c[r], edge), sp * k + r);
        }
        // e_op + μ·t_op, the node cost the reference adds after the
        // k-best selection (w_e = 1 exactly, so the product is e_op)
        const double nd = node_cost(eop, top, val, i * S + sn, 1.0, mu);
        int32_t* b_i = bk + (size_t)(i - 1) * k * S;
        for (int r = 0; r < k; ++r) {
            lv[r] = __dadd_rn(lv[r], nd);
            b_i[(size_t)r * S + sn] = li[r];
        }
        __syncthreads();
        double* t = cur;
        cur = nxt;
        nxt = t;
    }
    if (sn == 0) {
        int n = 0;
        int finite = 0;
        for (int j = 0; j < S * k; ++j) {
            if (isfinite(cur[j])) ++finite;
            topk_insert(nxt, nidx, n, k, cur[j], j);
        }
        counts[bq] = finite < k ? finite : k;
    }
    __syncthreads();
    for (int j = sn; j < k; j += blockDim.x) {
        int f = nidx[j];
        int s = f / k;
        int r = f % k;
        int32_t* row = paths + ((size_t)bq * k + j) * L;
        row[L - 1] = s;
        for (int i = L - 2; i >= 0; --i) {
            f = bk[((size_t)i * k + r) * S + s];
            s = f / k;
            r = f % k;
            row[i] = s;
        }
    }
}

// One thread per (path, layer).
__global__ void gather_kernel(const int64_t* __restrict__ lanes,
                              const int64_t* __restrict__ path_idx,
                              const double* __restrict__ t_op,
                              const double* __restrict__ e_op,
                              const double* __restrict__ t_trans,
                              const double* __restrict__ e_trans,
                              const int64_t* __restrict__ sw,
                              double* __restrict__ t_out,
                              double* __restrict__ e_out,
                              double* __restrict__ tt_out,
                              double* __restrict__ et_out,
                              int64_t* __restrict__ sw_out,
                              int P, int L, int S) {
    const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= (int64_t)P * L) return;
    const int64_t p = g / L;
    const int l = (int)(g % L);
    const int64_t lane = lanes[p];
    const int64_t s = path_idx[g];
    const size_t o = ((size_t)lane * L + l) * S + s;
    t_out[g] = t_op[o];
    e_out[g] = e_op[o];
    if (l < L - 1) {
        const int64_t s2 = path_idx[g + 1];
        const size_t ot = (((size_t)lane * (L - 1) + l) * S + s) * S + s2;
        const size_t oo = (size_t)p * (L - 1) + l;
        tt_out[oo] = t_trans[ot];
        et_out[oo] = e_trans[ot];
        sw_out[oo] = sw[ot];
    }
}

}  // namespace

extern "C" {

int pfdnn_dp_multi(const double* t_op, const double* e_op,
                   const uint8_t* valid, const double* t_trans,
                   const double* e_trans, const int64_t* lanes,
                   const double* w_e, const double* w_t, int32_t* parents,
                   int32_t* out, int B, int K, int L, int S,
                   void* stream) {
    dp_kernel<<<B * K, S, S * sizeof(double), (cudaStream_t)stream>>>(
        t_op, e_op, valid, t_trans, e_trans, lanes, w_e, w_t, parents, out,
        K, L, S);
    return (int)cudaGetLastError();
}

int pfdnn_kbest_multi(const double* t_op, const double* e_op,
                      const uint8_t* valid, const double* t_trans,
                      const double* e_trans, const int64_t* lanes,
                      const double* mus, int32_t* back, int32_t* paths,
                      int32_t* counts, int B, int K, int L, int S, int k,
                      void* stream) {
    const size_t smem =
        (size_t)S * k * (2 * sizeof(double) + sizeof(int32_t));
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kbest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kbest_kernel<<<B * K, S, smem, (cudaStream_t)stream>>>(
        t_op, e_op, valid, t_trans, e_trans, lanes, mus, back, paths, counts,
        K, L, S, k);
    return (int)cudaGetLastError();
}

int pfdnn_path_components(const int64_t* lanes, const int64_t* paths,
                          const double* t_op, const double* e_op,
                          const double* t_trans, const double* e_trans,
                          const int64_t* sw, double* t_out, double* e_out,
                          double* tt_out, double* et_out, int64_t* sw_out,
                          int P, int L, int S, void* stream) {
    const int threads = 256;
    const int64_t n = (int64_t)P * L;
    const int blocks = (int)((n + threads - 1) / threads);
    gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        lanes, paths, t_op, e_op, t_trans, e_trans, sw, t_out, e_out, tt_out,
        et_out, sw_out, P, L, S);
    return (int)cudaGetLastError();
}

}  // extern "C"
