// Hand-written Hopper kernels of the subset-stacked rail sweep.
//
// Each kernel replaces one Pallas TPU kernel of the JAX package
// (src/repro/kernels/dp_sweep.py) and computes the same function, bit
// for bit, on float64 lane tensors that live in a device mirror of a
// BucketStack ([cap, L, S] node tensors, [cap, L-1, S, S] transition
// tensors).  Lanes are gathered by index inside the kernel, so a sweep
// round moves no operand bytes from the host.
//
//   pfdnn_dp_multi         <- dp_multi_stacked_pallas     (dp_kernel)
//   pfdnn_kbest_multi      <- kbest_multi_stacked_pallas  (kbest_kernel)
//   pfdnn_path_components  <- path_components_pallas     (gather_kernel)
//
// Bit-identity with the numpy reference rests on three rules:
//   * every product and sum is rounded on its own (__dmul_rn /
//     __dadd_rn, and the build passes --fmad=false besides), in the
//     reference's order: node = (w_e*e_op) + (w_t*t_op), edge cost =
//     ((w_e*e_trans) + (w_t*t_trans)) + cost;
//   * an argmin keeps the lexicographic (value, index) minimum, which is
//     numpy's first-occurrence tie rule however the candidates are split
//     among threads;
//   * the k best come out in the lexicographic (value, sp*k + r) order,
//     the stable order of the reference's argsort.
// Invalid (and padded) states cost +inf after weighting; padded slots
// of the transition tensors hold finite values, so no NaN can arise.
//
// What bounds them on an H100.  Both recurrences are a chain of L-1
// dependent layers over [S, S] float64 slabs; one layer of one lane is
// little work (S = 64: 4096 edges a column), so the time goes to each
// layer's latency: its loads, its dependent compares and the exchange
// that ends it.  The byte bound (each slab read once) is far below and
// cannot be reached: every layer needs the whole previous row.  The
// first CUDA design (one CTA per (lane, column), slab columns read from
// global memory inside the scan, a k-best kept by S*k shifting
// insertions per thread) paid that latency on a few SMs.  This design:
//   * splits the next states of a (lane, column group) over a cluster of
//     CL = 8 CTAs (fewer for S < 8).  Each CTA stages only its slice of
//     each layer's two slabs, with its slice of that layer's node row,
//     by cp.async three stages deep, so two layers are in flight while
//     one computes; staged rows are padded so a warp reading one column
//     down its rows spreads over the banks.
//   * ends a layer without a cluster barrier: every CTA holds the whole
//     row buffers, and the row values a CTA computes reach the others'
//     shared memory by st.async (DP) or by one bulk copy a slice (k-best),
//     completing bytes on the receiver's mbarrier; the receiver waits on
//     that barrier's phase.  (A cluster barrier a layer cost more than
//     the layer's own work on an H100.)
//   * dp_kernel: a cluster serves GC weight columns of one lane (GC the
//     smallest of 1, 2, 4, 8 whose clusters fit one wave of the SMs, so a
//     slab tile is read once for GC columns); a warp takes one next
//     state, its lanes split over the GC columns (32 / GC a column) and
//     the predecessors, and a shuffle tree takes the lexicographic
//     (value, index) argmin; cost rows stay in shared memory.
//   * kbest_kernel: every predecessor list cur[sp] is sorted (it starts
//     [node, inf, ...], and adding one node cost or one edge cost is
//     monotone under rounding), and flat indices sp*k + r rise along
//     it, so the k best candidates of a next state are the first k
//     outputs of a k-way merge of the S lists.  A warp runs one merge:
//     lanes hold the heads of lists sp = lane, lane + 32, ... in
//     registers (each edge computed once per (sp, sn, mu)), with the
//     entry after each head loaded a round ahead; each of the k rounds
//     is one warp argmin, after which the winning list advances its
//     head: ~k*(argmin + S/32) dependent steps instead of S*k
//     insertions.  The final top k is the same merge over the S final
//     lists.  One cluster serves all K mu of a lane (as many as fit in
//     shared memory) from one staged slab; an invalid next state's
//     entries are inf, and its pointers only stay in range (no finite
//     path passes it).
//   * every loop that holds a shuffle has the same bounds on every lane
//     (the work is predicated), so the shuffles run converged; a
//     per-warp loop bound made the compiler emulate each one with
//     collective loops.
// The backpointers stay in global memory ([B, K, L-1, S] and [B, K,
// L-1, k, S] int32); the backtrack is a chain of L-1 dependent loads.
// On an H100 the merge's k rounds still take most of a k-best layer,
// and the DP's layer is bound by its exchange and staging latency.
//
// Every entry point returns the cudaError_t of its launch as an int.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_STATES = 1024;
// dynamic shared memory a CTA may opt into on sm_90
constexpr size_t SMEM_BUDGET = 232448;
constexpr int MAX_CLUSTER = 8;               // the portable cluster size
constexpr int NSTAGE = 3;                    // staged tiles in flight
constexpr int DP_THREADS = 256;
constexpr int KB_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------------------ staging

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// copies `bytes` (1..4) from src and zero-fills the rest of the word
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest NSTAGE - 2 groups have landed (in this thread)
__device__ __forceinline__ void cp_async_wait_stage() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NSTAGE - 2) : "memory");
}

// Rows of a tile copy in 16-byte chunks when S and tn are even.
__host__ __device__ inline bool vec_rows(int S, int tn) {
    return S % 2 == 0 && tn % 2 == 0;
}

// Row stride (doubles) of a staged tile of tn columns, so a warp reading
// one column down 32 rows spreads over the banks: odd (every bank pair
// once), or 2 mod 4 where rows copy in 16-byte chunks.
__host__ __device__ inline int padded_stride(int S, int tn) {
    if (!vec_rows(S, tn)) return tn | 1;
    return tn % 4 == 0 ? tn + 2 : tn;
}

// 32-bit words that hold tn valid bytes starting anywhere in a word
__host__ __device__ inline int valid_words(int tn) { return (tn + 6) / 4 + 1; }

// One stage: e_trans and t_trans tile rows [S][tp], then the tile's
// columns of the next node row: e_op, t_op [tn] and valid (words); an
// even count of doubles, so every stage and what follows the stages
// start 16-byte aligned.
__host__ __device__ inline size_t stage_doubles(int S, int tn, int tp) {
    const size_t n = (size_t)2 * S * tp + 2 * (size_t)tn +
                     ((size_t)valid_words(tn) + 1) / 2;
    return n + (n & 1);
}

struct Tile {
    const double* E;   // [S][tp]
    const double* T;
    const double* NE;  // [tn]
    const double* NT;
    const uint8_t* NV; // NV[j]: valid of the tile's column j
};

__device__ __forceinline__ Tile tile_view(const double* stage, int S,
                                          int tn, int tp,
                                          const uint8_t* vsrc) {
    Tile v;
    v.E = stage;
    v.T = stage + (size_t)S * tp;
    v.NE = v.T + (size_t)S * tp;
    v.NT = v.NE + tn;
    v.NV = reinterpret_cast<const uint8_t*>(v.NT + tn) +
           ((uintptr_t)vsrc & 3);
    return v;
}

// Issue the copies of one tile: columns [col0, col0 + tn) of layer
// li's two slabs (rows of stride tp) and of its node row.
__device__ __forceinline__ void stage_tile(double* dst, const double* e_slab,
                                           const double* t_slab,
                                           const double* eop_row,
                                           const double* top_row,
                                           const uint8_t* val_row, int S,
                                           int col0, int tn, int tp, int tid,
                                           int nthreads) {
    const bool vec = vec_rows(S, tn) && tp % 2 == 0 && col0 % 2 == 0;
    const int cpr = vec ? tn / 2 : tn;            // copies a row
    for (int idx = tid; idx < 2 * S * cpr; idx += nthreads) {
        const int row = idx / cpr;
        const int x = (idx - row * cpr) * (vec ? 2 : 1);
        const int w = row >= S;
        const int sp = row - w * S;
        double* d = dst + (size_t)w * S * tp + (size_t)sp * tp + x;
        const double* src = (w ? t_slab : e_slab) + (size_t)sp * S + col0 + x;
        if (vec)
            cp_async16(d, src);
        else
            cp_async8(d, src);
    }
    double* ne = dst + (size_t)2 * S * tp;
    for (int x = tid; x < 2 * tn; x += nthreads) {
        const int w = x >= tn;
        cp_async8(ne + x, (w ? top_row : eop_row) + col0 + x - w * tn);
    }
    // valid bytes by aligned words: the first may start before the
    // row's first byte (inside the tensor), the last stops at its end
    const uint8_t* v0 = val_row + col0;
    const uintptr_t a = (uintptr_t)v0;
    const uintptr_t a0 = a & ~(uintptr_t)3;
    const int nw = (int)((a - a0) + tn + 3) / 4;
    unsigned* nv = reinterpret_cast<unsigned*>(ne + 2 * tn);
    for (int w = tid; w < nw; w += nthreads) {
        const uintptr_t src = a0 + 4 * (uintptr_t)w;
        const long left = (long)(a + tn - src);
        cp_async4(nv + w, (const void*)src, left < 4 ? (int)left : 4);
    }
}

// Row exchange between the CTAs of a cluster.  A CTA sends each row
// value it computes to every CTA of the cluster (itself included) with
// st.async (the DP: a few values a layer), or writes its slice into its
// own buffer and copies the slice to every other CTA with one bulk copy
// a segment (the k-best: k values a next state); either way the bytes
// complete on the receiver's mbarrier for that buffer, which the
// receiver arms with the bytes it expects and waits on.  A layer's copies need the whole previous row, so no CTA can
// write a buffer that another still reads, and no barrier across the
// cluster is needed until the end.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cluster_addr(unsigned local, int rank) {
    unsigned out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(out) : "r"(local), "r"(rank));
    return out;
}

// Store one double into another CTA's shared memory, completing 8 bytes
// on its mbarrier.
__device__ __forceinline__ void send(unsigned dst, double v, unsigned bar) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64"
        " [%0], %1, [%2];\n"
        :: "r"(dst), "l"(__double_as_longlong(v)), "r"(bar) : "memory");
}

// Copy `bytes` (a multiple of 16, both ends 16-byte aligned) of this
// CTA's shared memory to another CTA's, completing on its mbarrier.
__device__ __forceinline__ void send_bulk(unsigned dst, unsigned src,
                                          unsigned bytes, unsigned bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
        "::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// this thread's shared-memory writes, made visible to the bulk copies
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete; a wait of ~10 s
// (a fault in the byte accounting) traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    const long long t0 = clock64();
    while (true) {
        unsigned done;
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
            " p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > 20000000000ll) asm volatile("trap;");
    }
}

// The row buffer (0 or 1) layer i writes, and the parity of its
// barrier's phase for that layer (buffer i & 1 serves layers i, i + 2,
// ...; layer 0's row is computed in place by every CTA).
__device__ __forceinline__ unsigned layer_parity(int i) {
    return (unsigned)((i - 1) >> 1) & 1u;
}

// -------------------------------------------------------- arithmetic

__device__ __forceinline__ double weighted(double we, double e, double wt,
                                           double t) {
    return __dadd_rn(__dmul_rn(we, e), __dmul_rn(wt, t));
}

__device__ __forceinline__ bool lex_less(double v1, int i1, double v2,
                                         int i2) {
    return v1 < v2 || (v1 == v2 && i1 < i2);
}

// Lexicographic (value, index) minimum over aligned groups of `width`
// lanes (a power of two <= 32) by a shuffle tree; every lane of a group
// gets its group's, and every lane of the warp must take part.  Indices
// are >= 0; INT_MAX marks an empty slot.  (Three chained redux.sync on
// order-preserving keys are quicker for one warp alone, but their unit
// is shared: with 16 warps an SM they were slower than the shuffles on
// an H100.)
__device__ __forceinline__ void group_argmin(double& v, int& i, int width) {
    for (int m = width >> 1; m > 0; m >>= 1) {
        const double ov = __shfl_xor_sync(FULL, v, m);
        const int oi = __shfl_xor_sync(FULL, i, m);
        if (lex_less(ov, oi, v, i)) {
            v = ov;
            i = oi;
        }
    }
}

// The CTA's slice of next states: [lo, hi) of S.
struct Slice {
    int lo, hi, ntiles;
};

__device__ __forceinline__ Slice slice_of(int rank, int S, int SL, int TN) {
    Slice s;
    s.lo = min(S, rank * SL);
    s.hi = min(S, s.lo + SL);
    s.ntiles = (s.hi - s.lo + TN - 1) / TN;
    return s;
}

// Lane-store base pointers of one lane.
struct LaneView {
    const double* top;
    const double* eop;
    const uint8_t* val;
    const double* ttr;
    const double* etr;
};

__device__ __forceinline__ LaneView lane_view(
    const double* t_op, const double* e_op, const uint8_t* valid,
    const double* t_trans, const double* e_trans, int64_t lane, int L,
    int S) {
    const size_t ls = (size_t)L * S;
    const size_t slabs = (size_t)(L - 1) * S * S;
    LaneView v;
    v.top = t_op + lane * ls;
    v.eop = e_op + lane * ls;
    v.val = valid + lane * ls;
    v.ttr = t_trans + lane * slabs;
    v.etr = e_trans + lane * slabs;
    return v;
}

// The pipeline over (layer, tile) steps of one CTA's slice: issue step
// `step` into its stage (a no-op past the last step).
__device__ __forceinline__ void issue_step(double* stages, size_t stage_len,
                                           const LaneView& lv, Slice sl,
                                           int step, int L, int S, int TN,
                                           int TP, int tid, int nthreads) {
    if (sl.ntiles > 0 && step < (L - 1) * sl.ntiles) {
        const int li = 1 + step / sl.ntiles;
        const int t = step - (li - 1) * sl.ntiles;
        const int col0 = sl.lo + t * TN;
        const int tn = min(TN, sl.hi - col0);
        const size_t slab = (size_t)S * S;
        stage_tile(stages + (size_t)(step % NSTAGE) * stage_len,
                   lv.etr + (size_t)(li - 1) * slab,
                   lv.ttr + (size_t)(li - 1) * slab,
                   lv.eop + (size_t)li * S, lv.top + (size_t)li * S,
                   lv.val + (size_t)li * S, S, col0, tn, TP, tid, nthreads);
    }
    cp_async_commit();
}

// ----------------------------------------------------------------- dp

// Row stride (doubles) of the DP's cost rows: S rounded up to even and
// then to 8 mod 16, so the lanes of a warp reading 4 columns x 8 rows
// fall two to a bank pair at most.
__host__ __device__ inline int row_stride(int S) {
    const int sp = S + (S & 1);
    return sp + ((8 - sp % 16) + 16) % 16;
}

// A cluster of CL CTAs per (lane, group of GC weight columns); CTA
// `rank` computes next states [rank*SL, rank*SL + SL).  Warp w takes one
// next state of a pass; its lanes split over the GC columns, 32 / GC
// lanes a column, and each lane scans predecessors sp = part, part +
// 32 / GC, ....  Cost rows are [2][GC][RS], RS = row_stride(S).
template <int GC>
__global__ void __launch_bounds__(DP_THREADS)
dp_kernel(const double* __restrict__ t_op, const double* __restrict__ e_op,
          const uint8_t* __restrict__ valid,
          const double* __restrict__ t_trans,
          const double* __restrict__ e_trans,
          const int64_t* __restrict__ lanes, const double* __restrict__ w_e,
          const double* __restrict__ w_t, int32_t* parents, int32_t* out,
          int K, int L, int S, int CL, int SL, int TN, int TP) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int RS = row_stride(S);
    const size_t stage_len = stage_doubles(S, TN, TP);
    double* stages = reinterpret_cast<double*>(smem);        // [NSTAGE]
    double* rows = stages + NSTAGE * stage_len;              // [2][GC][RS]
    unsigned long long* bars =                               // [2]
        reinterpret_cast<unsigned long long*>(rows + 2 * GC * (size_t)RS);

    const int b = blockIdx.x / CL;
    const int q0 = blockIdx.y * GC;
    const int gc = min(GC, K - q0);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nwarps = DP_THREADS / 32;
    constexpr int LPC = 32 / GC;                // lanes a column
    const int c = lane / LPC;                   // this lane's column
    const int part = lane % LPC;
    const LaneView lv = lane_view(t_op, e_op, valid, t_trans, e_trans,
                                  lanes[b], L, S);
    const double* wer = w_e + (size_t)b * K + q0;
    const double* wtr = w_t + (size_t)b * K + q0;
    const double we = wer[min(c, gc - 1)];
    const double wt = wtr[min(c, gc - 1)];
    const Slice sl = slice_of(rank, S, SL, TN);
    for (int step = 0; step < NSTAGE - 1; ++step)
        issue_step(stages, stage_len, lv, sl, step, L, S, TN, TP, tid,
                   DP_THREADS);
    // layer 0's row, in place in buffer 0 of every CTA
    for (int idx = tid; idx < gc * S; idx += DP_THREADS) {
        const int cc = idx / S;
        const int s = idx - cc * S;
        rows[(size_t)cc * RS + s] =
            lv.val[s] ? weighted(wer[cc], lv.eop[s], wtr[cc], lv.top[s])
                      : CUDART_INF;
    }
    if (tid == 0) {
        mbar_init(smem_addr(bars));
        mbar_init(smem_addr(bars + 1));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // every CTA of the cluster runs, with its barriers armed, before any
    // copy into another's shared memory
    cluster.sync();
    // every value of a row arrives by st.async, this CTA's own included
    const unsigned expect = (unsigned)(gc * S * sizeof(double));
    const unsigned bars_at = smem_addr(bars);
    int step = 0;
    for (int i = 1; i < L; ++i) {
        const int pw = i & 1;                   // the buffer layer i writes
        if (tid == 0) mbar_expect(smem_addr(bars + pw), expect);
        if (i > 1) mbar_wait(smem_addr(bars + (pw ^ 1)), layer_parity(i - 1));
        const double* cr = rows + (size_t)((pw ^ 1) * GC + c) * RS;
        double* nr = rows + (size_t)(pw * GC + c) * RS;   // the sends' target
        int32_t* par =
            parents + ((size_t)(b * K + q0 + c) * (L - 1) + (i - 1)) * S;
        for (int t = 0; t < sl.ntiles; ++t, ++step) {
            cp_async_wait_stage();
            __syncthreads();
            const int col0 = sl.lo + t * TN;
            const int tn = min(TN, sl.hi - col0);
            const Tile tl = tile_view(stages + (size_t)(step % NSTAGE) *
                                      stage_len, S, tn, TP,
                                      lv.val + (size_t)i * S + col0);
            // loop bounds the same on every lane, so the shuffles below
            // run converged (a per-warp bound makes the compiler emulate
            // them with collective loops)
            for (int base = 0; base < tn; base += nwarps) {
                const int snl = base + warp;
                const bool act = snl < tn;
                double best = CUDART_INF;
                int arg = INT_MAX;
                if (act) {
                    for (int sp = part; sp < S; sp += LPC) {
                        const double v = __dadd_rn(
                            weighted(we, tl.E[(size_t)sp * TP + snl], wt,
                                     tl.T[(size_t)sp * TP + snl]),
                            cr[sp]);
                        if (lex_less(v, sp, best, arg)) {
                            best = v;
                            arg = sp;
                        }
                    }
                }
                group_argmin(best, arg, LPC);
                if (act && c < gc) {
                    const int sn = col0 + snl;
                    const double nd =
                        tl.NV[snl] ? weighted(we, tl.NE[snl], wt, tl.NT[snl])
                                   : CUDART_INF;
                    const double v = __dadd_rn(best, nd);
                    // the column's lanes share the sends, one CTA each
                    for (int to = part; to < CL; to += LPC)
                        send(cluster_addr(smem_addr(nr + sn), to), v,
                             cluster_addr(bars_at + pw * 8u, to));
                    if (part == 0) par[sn] = arg;
                }
            }
            // the tile two steps on goes into the stage read a step ago;
            // the last tile's waits until the row values are sent
            if (t + 1 < sl.ntiles)
                issue_step(stages, stage_len, lv, sl, step + NSTAGE - 1, L, S,
                           TN, TP, tid, DP_THREADS);
        }
        if (sl.ntiles > 0)
            issue_step(stages, stage_len, lv, sl, step - 1 + NSTAGE - 1, L,
                       S, TN, TP, tid, DP_THREADS);
    }
    if (L > 1) mbar_wait(smem_addr(bars + ((L - 1) & 1)), layer_parity(L - 1));
    // every CTA's parents are written and every copy has landed
    cluster.sync();
    const size_t cur = (size_t)((L - 1) & 1) * GC * RS;

    // the last layer's argmin, then the backtrack: a warp per column,
    // columns dealt round the cluster
    for (int base = rank; base < gc; base += CL * nwarps) {
        const int cc = base + CL * warp;
        double bv = CUDART_INF;
        int bi = INT_MAX;
        if (cc < gc) {
            for (int s = lane; s < S; s += 32) {
                const double v = rows[cur + (size_t)cc * RS + s];
                if (lex_less(v, s, bv, bi)) {
                    bv = v;
                    bi = s;
                }
            }
        }
        group_argmin(bv, bi, 32);
        if (cc < gc && lane == 0) {
            const size_t col = (size_t)b * K + q0 + cc;
            int32_t* o = out + col * L;
            const int32_t* pc = parents + col * (L - 1) * S;
            int s = bi;
            o[L - 1] = s;
            for (int i = L - 2; i >= 0; --i) {
                s = pc[(size_t)i * S + s];
                o[i] = s;
            }
        }
    }
}

// ------------------------------------------------------------- k-best

// The first k outputs of the k-way merge of the S sorted lists cl[sp]
// (candidate (sp, r) is cl[sp*kp + r] + edge(sp), r < k, flat index
// sp*k + r), run by one warp: lane l holds lists sp = l, l + 32, ... (at
// most NL).  With E == nullptr the edge is -0.0, which adds nothing.
// emit(r, value, flat index) runs on every lane for each rank r when
// `work`; without it the warp only takes part in the shuffles (which
// run on every lane, whatever the data, so they stay converged).
template <int NL, typename Emit>
__device__ __forceinline__ void merge_lists(bool work, const double* cl,
                                            int kp, const double* E,
                                            const double* T, int tp, int col,
                                            double mu, int S, int k,
                                            int lane, Emit emit) {
    // per list: its edge, its head's value and rank, and the value
    // after the head (loaded a round ahead, off the rounds' chain)
    double e[NL], hv[NL], nv[NL];
    int h[NL];
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        const int sp = lane + 32 * j;
        h[j] = k;
        e[j] = -0.0;
        hv[j] = nv[j] = CUDART_INF;
        if (work && sp < S) {
            if (E != nullptr)
                e[j] = __dadd_rn(E[(size_t)sp * tp + col],
                                 __dmul_rn(mu, T[(size_t)sp * tp + col]));
            h[j] = 0;
            hv[j] = __dadd_rn(cl[(size_t)sp * kp], e[j]);
            if (k > 1) nv[j] = __dadd_rn(cl[(size_t)sp * kp + 1], e[j]);
        }
    }
    // the lane's least head, and which of its lists holds it
    double bv = CUDART_INF;
    int bi = INT_MAX, bj = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        const int f = (lane + 32 * j) * k + h[j];
        if (h[j] < k && lex_less(hv[j], f, bv, bi)) {
            bv = hv[j];
            bi = f;
            bj = j;
        }
    }
    for (int r = 0; r < k; ++r) {
        double wv = bv;
        int wi = bi;
        group_argmin(wv, wi, 32);
        if (work) emit(r, wv, wi);
        if (work && bi == wi && r + 1 < k) {
            // the winning list advances its head
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                if (j == bj) {
                    const int sp = lane + 32 * j;
                    ++h[j];
                    hv[j] = nv[j];
                    if (h[j] + 1 < k)
                        nv[j] = __dadd_rn(cl[(size_t)sp * kp + h[j] + 1],
                                          e[j]);
                }
            }
            bv = CUDART_INF;
            bi = INT_MAX;
#pragma unroll
            for (int j = 0; j < NL; ++j) {
                const int f = (lane + 32 * j) * k + h[j];
                if (h[j] < k && lex_less(hv[j], f, bv, bi)) {
                    bv = hv[j];
                    bi = f;
                    bj = j;
                }
            }
        }
    }
}

// A cluster of CL CTAs per (lane, group of KC values of mu); CTA `rank`
// computes the lists of next states [rank*SL, rank*SL + SL); a warp runs
// one merge per (mu, next state) of the staged tile.  Lists are
// [2][KC][S][KP], KP = k rounded up to even.
template <int NL>
__global__ void __launch_bounds__(KB_THREADS)
kbest_kernel(const double* __restrict__ t_op,
             const double* __restrict__ e_op,
             const uint8_t* __restrict__ valid,
             const double* __restrict__ t_trans,
             const double* __restrict__ e_trans,
             const int64_t* __restrict__ lanes,
             const double* __restrict__ mus, int32_t* back,
             int32_t* __restrict__ paths, int32_t* __restrict__ counts,
             int K, int L, int S, int k, int KC, int CL, int SL, int TN,
             int TP) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int KP = k + (k & 1);
    const size_t stage_len = stage_doubles(S, TN, TP);
    const size_t list = (size_t)S * KP;
    double* stages = reinterpret_cast<double*>(smem);        // [NSTAGE]
    double* lists = stages + NSTAGE * stage_len;             // [2][KC][S][KP]
    double* mu_s = lists + 2 * (size_t)KC * list;            // [KC]
    int* fin = reinterpret_cast<int*>(mu_s + KC);            // [KC][k]
    unsigned long long* bars =                               // [2]
        reinterpret_cast<unsigned long long*>(
            fin + (((size_t)KC * k + 1) & ~(size_t)1));

    const int b = blockIdx.x / CL;
    const int q0 = blockIdx.y * KC;
    const int kc = min(KC, K - q0);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nwarps = KB_THREADS / 32;
    const LaneView lv = lane_view(t_op, e_op, valid, t_trans, e_trans,
                                  lanes[b], L, S);
    const size_t col_base = (size_t)b * K + q0;   // first (lane, mu) row
    const Slice sl = slice_of(rank, S, SL, TN);
    for (int step = 0; step < NSTAGE - 1; ++step)
        issue_step(stages, stage_len, lv, sl, step, L, S, TN, TP, tid,
                   KB_THREADS);
    for (int c = tid; c < kc; c += KB_THREADS) mu_s[c] = mus[col_base + c];
    __syncthreads();
    // e_op + mu*t_op (w_e = 1 exactly) as the only entry of each list,
    // layer 0's lists in place in buffer 0 of every CTA
    for (int idx = tid; idx < kc * (int)list; idx += KB_THREADS) {
        const int c = idx / (int)list;
        const int rem = idx - c * (int)list;
        const int s = rem / KP;
        lists[idx] = rem - s * KP == 0 && lv.val[s]
                         ? weighted(1.0, lv.eop[s], mu_s[c], lv.top[s])
                         : CUDART_INF;
    }
    if (tid == 0) {
        mbar_init(smem_addr(bars));
        mbar_init(smem_addr(bars + 1));
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cluster.sync();
    // this CTA's slice of the lists, and the bytes the others send
    const int width = sl.hi - sl.lo;
    const unsigned expect =
        (unsigned)(kc * (size_t)(S - width) * KP * sizeof(double));
    int step = 0;
    for (int i = 1; i < L; ++i) {
        const int pw = i & 1;                   // the buffer layer i writes
        if (tid == 0) mbar_expect(smem_addr(bars + pw), expect);
        if (i > 1) mbar_wait(smem_addr(bars + (pw ^ 1)), layer_parity(i - 1));
        const double* cr = lists + (size_t)(pw ^ 1) * KC * list;
        double* nl = lists + (size_t)pw * KC * list;
        for (int t = 0; t < sl.ntiles; ++t, ++step) {
            cp_async_wait_stage();
            __syncthreads();
            const int col0 = sl.lo + t * TN;
            const int tn = min(TN, sl.hi - col0);
            const Tile tl = tile_view(stages + (size_t)(step % NSTAGE) *
                                      stage_len, S, tn, TP,
                                      lv.val + (size_t)i * S + col0);
            // loop bounds the same on every lane, so the shuffles of the
            // merge run converged (a per-warp bound makes the compiler
            // emulate them with collective loops)
            const int ntask = kc * tn;
            for (int base = 0; base < ntask; base += nwarps) {
                const int task = base + warp;
                const bool active = task < ntask;
                const int c = active ? task / tn : 0;
                const int snl = active ? task - c * tn : 0;
                const int sn = col0 + snl;
                const double mu = mu_s[c];
                double* nrow = nl + (size_t)c * list + (size_t)sn * KP;
                int32_t* brow =
                    back + ((col_base + c) * (L - 1) + (i - 1)) * k * S + sn;
                const bool ok = active && tl.NV[snl];
                if (active && !ok) {
                    // an invalid state: every entry is inf; the pointers
                    // only need to stay in range
                    for (int r = lane; r < k; r += 32) {
                        nrow[r] = CUDART_INF;
                        brow[(size_t)r * S] = r;
                    }
                }
                // e_op + mu*t_op, the node cost the reference adds after
                // the k-best selection
                const double nd =
                    ok ? weighted(1.0, tl.NE[snl], mu, tl.NT[snl]) : 0.0;
                merge_lists<NL>(ok, cr + (size_t)c * list, KP, tl.E, tl.T, TP,
                                snl, mu, S, k, lane,
                                [&](int r, double v, int f) {
                                    if (lane == (r & 31)) {
                                        nrow[r] = __dadd_rn(v, nd);
                                        brow[(size_t)r * S] = f;
                                    }
                                });
            }
            // the tile two steps on goes into the stage read a step ago;
            // the last tile's waits until the slice is sent
            if (t + 1 < sl.ntiles)
                issue_step(stages, stage_len, lv, sl, step + NSTAGE - 1, L, S,
                           TN, TP, tid, KB_THREADS);
        }
        // the slice goes to every other CTA: one copy a (CTA, mu)
        fence_proxy_async();
        __syncthreads();
        if (width > 0) {
            for (int j = tid; j < (CL - 1) * kc; j += KB_THREADS) {
                const int to = (rank + 1 + j / kc) % CL;
                const double* at = nl + (size_t)(j % kc) * list +
                                   (size_t)sl.lo * KP;
                send_bulk(cluster_addr(smem_addr(at), to), smem_addr(at),
                          (unsigned)(width * KP * sizeof(double)),
                          cluster_addr(smem_addr(bars + pw), to));
            }
        }
        if (sl.ntiles > 0)
            issue_step(stages, stage_len, lv, sl, step - 1 + NSTAGE - 1, L,
                       S, TN, TP, tid, KB_THREADS);
    }
    if (L > 1) mbar_wait(smem_addr(bars + ((L - 1) & 1)), layer_parity(L - 1));
    // every CTA's backpointers are written and every copy has landed
    cluster.sync();
    const double* fl = lists + (size_t)((L - 1) & 1) * KC * list;

    // the final top k: the same merge over the S final lists, no edge;
    // values of mu dealt round the cluster, a warp each
    for (int base = rank; base < kc; base += CL * nwarps) {
        const int c = base + CL * warp;
        const bool active = c < kc;
        const double* cl = fl + (size_t)(active ? c : 0) * list;
        int* frow = fin + (active ? c : 0) * k;
        merge_lists<NL>(active, cl, KP, nullptr, nullptr, 0, 0, 0.0, S, k,
                        lane, [&](int r, double, int f) {
                            if (lane == 0) frow[r] = f;
                        });
        int finite = 0;
        if (active)
            for (int j = lane; j < S * k; j += 32) {
                const int s = j / k;
                finite += isfinite(cl[(size_t)s * KP + (j - s * k)]);
            }
        for (int m = 16; m > 0; m >>= 1)
            finite += __shfl_xor_sync(FULL, finite, m);
        if (active && lane == 0) counts[col_base + c] = min(finite, k);
    }
    __syncthreads();
    for (int j = tid; j < kc * k; j += KB_THREADS) {
        const int c = j / k;
        if (c % CL != rank) continue;
        const int rank_r = j - c * k;
        int f = fin[j];
        int s = f / k;
        int r = f - s * k;
        int32_t* row = paths + ((col_base + c) * k + rank_r) * L;
        const int32_t* bk = back + (col_base + c) * (L - 1) * k * S;
        row[L - 1] = s;
        for (int i = L - 2; i >= 0; --i) {
            f = bk[((size_t)i * k + r) * S + s];
            s = f / k;
            r = f - s * k;
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

// ------------------------------------------------------- launch plans

namespace {

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || n <= 0)
            n = 1;
    }
    return n;
}

// CTAs a (lane, column group) is split over: 8, fewer when S < 8
int cluster_size(int S) {
    int cl = MAX_CLUSTER;
    while (cl > 1 && cl > S) cl /= 2;
    return cl;
}

// next states a CTA takes: S / cl rounded up to an even count, so every
// slice starts 16-byte aligned in the row buffers
int slice_width(int S, int cl) {
    const int sl = (S + cl - 1) / cl;
    return sl + (sl & 1);
}

size_t stages_bytes(int S, int tn) {
    return NSTAGE * stage_doubles(S, tn, padded_stride(S, tn)) *
           sizeof(double);
}

// Widest tile (columns, at most sl) whose stages fit beside `fixed`
// bytes; 0 if none fits.
int widest_tile(int S, int sl, size_t fixed) {
    for (int tn = sl; tn > 0; --tn) {
        // narrower tiles stay even, so rows still copy in 16-byte chunks
        if (tn < sl && tn > 1 && tn % 2 && S % 2 == 0) continue;
        if (fixed + stages_bytes(S, tn) <= SMEM_BUDGET) return tn;
    }
    return 0;
}

// cost rows [2][gc][row_stride(S)] and two mbarriers
size_t dp_fixed(int S, int gc) {
    return (size_t)2 * gc * row_stride(S) * sizeof(double) + 16;
}

// lists [2][kc][S][k rounded up to even], mu [kc], final indices
// [kc][k] (padded to 8 bytes) and two mbarriers
size_t kbest_fixed(int S, int k, int kc) {
    return (size_t)2 * kc * S * (k + (k & 1)) * sizeof(double) +
           kc * sizeof(double) +
           (((size_t)kc * k + 1) & ~(size_t)1) * sizeof(int) + 16;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& raised) {
    if (bytes <= 48 * 1024 || raised) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BUDGET);
    raised = err == cudaSuccess;
    if (!raised) cudaGetLastError();
    return err;
}

template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid,
                           int threads, size_t smem, int cl,
                           cudaStream_t stream, bool& raised,
                           Args... args) {
    const cudaError_t err = allow_smem(kernel, smem, raised);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t launch = cudaLaunchKernelEx(&cfg, kernel, args...);
    // read (and so clear) the last error too: a refused launch must not
    // surface again at the next one
    const cudaError_t last = cudaGetLastError();
    return launch != cudaSuccess ? launch : last;
}

template <int GC>
cudaError_t launch_dp(dim3 grid, size_t smem, int cl, cudaStream_t stream,
                      const double* t_op, const double* e_op,
                      const uint8_t* valid, const double* t_trans,
                      const double* e_trans, const int64_t* lanes,
                      const double* w_e, const double* w_t,
                      int32_t* parents, int32_t* out, int K, int L, int S,
                      int sl, int tn, int tp) {
    static bool raised = false;
    return launch_cluster(dp_kernel<GC>, grid, DP_THREADS, smem, cl, stream,
                          raised, t_op, e_op, valid, t_trans, e_trans, lanes,
                          w_e, w_t, parents, out, K, L, S, cl, sl, tn, tp);
}

template <int NL>
cudaError_t launch_kbest(dim3 grid, size_t smem, int cl, cudaStream_t stream,
                         const double* t_op, const double* e_op,
                         const uint8_t* valid, const double* t_trans,
                         const double* e_trans, const int64_t* lanes,
                         const double* mus, int32_t* back, int32_t* paths,
                         int32_t* counts, int K, int L, int S, int k, int kc,
                         int sl, int tn, int tp) {
    static bool raised = false;
    return launch_cluster(kbest_kernel<NL>, grid, KB_THREADS, smem, cl,
                          stream, raised, t_op, e_op, valid, t_trans,
                          e_trans, lanes, mus, back, paths, counts, K, L, S,
                          k, kc, cl, sl, tn, tp);
}

}  // namespace

extern "C" {

int pfdnn_dp_multi(const double* t_op, const double* e_op,
                   const uint8_t* valid, const double* t_trans,
                   const double* e_trans, const int64_t* lanes,
                   const double* w_e, const double* w_t, int32_t* parents,
                   int32_t* out, int B, int K, int L, int S,
                   void* stream) {
    if (S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
    const int cl = cluster_size(S);
    const int sl = slice_width(S, cl);
    // columns a cluster serves: the fewest whose clusters fit one wave
    // of the SMs (up to 8), no more than K needs
    int gc = 1;
    while (gc < 8 && gc < K &&
           (long)cl * B * ((K + gc - 1) / gc) > sm_count())
        gc *= 2;
    // narrower tiles than 8 columns only when nothing else fits
    while (gc > 1 && widest_tile(S, sl, dp_fixed(S, gc)) < (sl < 8 ? sl : 8))
        gc /= 2;
    const int tn = widest_tile(S, sl, dp_fixed(S, gc));
    if (tn < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = dp_fixed(S, gc) + stages_bytes(S, tn);
    const dim3 grid(cl * B, (K + gc - 1) / gc);
    const cudaStream_t st = (cudaStream_t)stream;
    const int tp = padded_stride(S, tn);
    cudaError_t err;
    switch (gc) {
        case 8:
            err = launch_dp<8>(grid, smem, cl, st, t_op, e_op, valid,
                               t_trans, e_trans, lanes, w_e, w_t, parents,
                               out, K, L, S, sl, tn, tp);
            break;
        case 4:
            err = launch_dp<4>(grid, smem, cl, st, t_op, e_op, valid,
                               t_trans, e_trans, lanes, w_e, w_t, parents,
                               out, K, L, S, sl, tn, tp);
            break;
        case 2:
            err = launch_dp<2>(grid, smem, cl, st, t_op, e_op, valid,
                               t_trans, e_trans, lanes, w_e, w_t, parents,
                               out, K, L, S, sl, tn, tp);
            break;
        default:
            err = launch_dp<1>(grid, smem, cl, st, t_op, e_op, valid,
                               t_trans, e_trans, lanes, w_e, w_t, parents,
                               out, K, L, S, sl, tn, tp);
    }
    return (int)err;
}

int pfdnn_kbest_multi(const double* t_op, const double* e_op,
                      const uint8_t* valid, const double* t_trans,
                      const double* e_trans, const int64_t* lanes,
                      const double* mus, int32_t* back, int32_t* paths,
                      int32_t* counts, int B, int K, int L, int S, int k,
                      void* stream) {
    if (S < 1 || S > MAX_STATES || k < 1) return (int)cudaErrorInvalidValue;
    const int cl = cluster_size(S);
    const int sl = slice_width(S, cl);
    // all K values of mu in one cluster, as many as leave room for tiles
    // of 8 columns (or the whole slice)
    int kc = K;
    while (kc > 1 &&
           widest_tile(S, sl, kbest_fixed(S, k, kc)) < (sl < 8 ? sl : 8))
        --kc;
    const int tn = widest_tile(S, sl, kbest_fixed(S, k, kc));
    if (tn < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = kbest_fixed(S, k, kc) + stages_bytes(S, tn);
    const dim3 grid(cl * B, (K + kc - 1) / kc);
    const cudaStream_t st = (cudaStream_t)stream;
    const int tp = padded_stride(S, tn);
    // list heads a lane holds: S / 32, rounded up to a power of two
    const int nl = S <= 32 ? 1 : S <= 64 ? 2 : S <= 128 ? 4 : S <= 256 ? 8
                 : S <= 512 ? 16 : 32;
    cudaError_t err;
    switch (nl) {
#define PFDNN_KBEST(N)                                                     \
    case N:                                                                \
        err = launch_kbest<N>(grid, smem, cl, st, t_op, e_op, valid,       \
                              t_trans, e_trans, lanes, mus, back, paths,   \
                              counts, K, L, S, k, kc, sl, tn, tp);         \
        break;
        PFDNN_KBEST(1)
        PFDNN_KBEST(2)
        PFDNN_KBEST(4)
        PFDNN_KBEST(8)
        PFDNN_KBEST(16)
        PFDNN_KBEST(32)
#undef PFDNN_KBEST
        default:
            err = cudaErrorInvalidValue;
    }
    return (int)err;
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
