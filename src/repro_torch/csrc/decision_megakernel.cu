// The RouteBalance per-batch decision on Hopper: KNN top-k -> packed-GBM
// TPOT heads -> Eq. 2 admission (+ prefix-affinity discount) -> LPT
// greedy scan with dead reckoning, for K scheduler windows per call.
//
// Replaces src/repro/kernels/decision_megakernel.py::decision_call (the
// Pallas kernel `_kernel`, pl.pallas_call at line 283).
//
// What bounds it on an H100. Stage 1 reads the KNN index once:
// N*E*4 bytes of embeddings plus the label rows of the chosen
// neighbours, and does 2*K*R*N*E float32 operations on the CUDA cores
// (no tensor cores: the distances keep full float32). At the main
// path's small batches that is bytes-bound; from a few dozen rows up it
// is operations-bound (chip_smoke.py computes both bounds per shape).
// The scan is R dependent steps, each a handful of reductions over I: a
// chain of latencies, not a throughput. Before it, each instance's TPOT
// walks its tier's trees (60 of depth 3 on the main path): done one
// tree after another, that is some 180 dependent loads, about 1.5 us an
// instance for a warp, so 3.2 ms at I = 16,384 in one CTA of 8 warps.
//
// What the design does about it. One __global__ function per call,
// `decision_fused`:
//   0. The per-instance preamble runs on the whole grid first. CTAs take
//      a slice of the instances each, one a warp, strided over the CTAs
//      that hold one: as many CTAs as I needs at 8 instances a CTA, at
//      most the grid (2 at the main path's I = 16, every CTA at I =
//      16,384). The slices go to the last index split's CTAs first, one
//      per row tile, then the split before it: where the index does not
//      divide evenly the last split is the shortest (1 of 2 tiles at the
//      main path's 14,886 rows), so a small roster's trees ride on the
//      CTAs that finish stage 1 first. A warp walks its instance's
//      trees, one lane per tree, the leaf values then added in tree order
//      by shuffles, and writes the TPOT (window-invariant) to an (I,)
//      scratch. With the prefix-affinity term on, the same warp then
//      writes its instance's discount factor 1 - w_aff * hit for every
//      row of every window, pad rows included, to a (K*R, I) scratch: the
//      hit depends on the row and the instance, never on the carry, so
//      the plane is read once a call (a warp per instance, its sketch
//      slots across the lanes, one vote a signature column), not once a
//      scan step. With the global carry the slice also writes b0 and each
//      window's initial carry rows. Then the CTA draws the trees' ticket
//      and goes on to stage 1; the CTA that draws the trees' last ticket
//      draws one ticket of every window for them.
//   1. Stage 1 is the lookup's one-launch body (knn_common.cuh,
//      `fused_topk`, shared with knn_topk.cu): (index splits x row tiles)
//      over the K*R rows, the layout taken from the lookup's measured
//      table for K*R rows (kernels/knn_topk.py), the split lists merged
//      by the CTA that draws a row tile's last ticket. That CTA also does
//      each row's state-free work right after the merge: the
//      inverse-distance weights, the label mixes and the LPT key, to
//      scratch; no k list is kept.
//   2. Each window has a second ticket, drawn once by every row tile
//      that holds rows of it and once for the trees. The CTA that draws a
//      window's last ticket (on the cluster carry, its cluster, after
//      stage 1) runs that window's scan: the LPT order and
//      the greedy loop over the TPOT the grid wrote. With I <= 32 (the
//      main path) one warp runs the loop, lane i holding instance i's
//      constants and its (d, b, free) carry in registers, so a step is
//      three warp reductions; above, the block runs it, thread t owning
//      the columns i = t (mod blockDim.x). Eq. 2 admission and Eq. 1 are
//      evaluated for one row over I on the fly; with the affinity term a
//      step reads the row's factors the grid wrote, one float a column.
// No CTA waits on a CTA outside its cluster: every hand-over is a last
// ticket, and every ticket is left at 0.
// The block's per-instance arrays (the carry d/b/free, b0, the TPOT, and
// a step's cost and latency: 28 B an instance) have three homes, chosen
// by the wrapper from the shapes alone (`carry_of`):
//   * The shared carry keeps them in the scanning CTA's shared memory,
//     up to I = 4096 (MAX_SHARED_I in the wrapper) where they fit beside
//     the R-length arrays, and copies the TPOT in.
//   * The cluster carry, past that up to 16 x 4096 instances, spreads
//     them over a thread-block cluster of C CTAs (2 to 16, the wrapper's
//     choice: at most 1,024 columns a CTA where C allows), rank r holding
//     the contiguous slice of ceil(I / C) columns from r ceil(I / C) in
//     its own shared memory. The grid's x is padded to whole clusters;
//     the pad CTAs take slices of the preamble but no index split. A CTA
//     that draws a window's last ticket only records it; after stage 1
//     every CTA of the cluster meets at a cluster barrier, reads which
//     windows its siblings completed through distributed shared memory
//     and the whole cluster scans each in window order. Every CTA runs
//     the R-length preamble (the LPT order) itself; each step's passes
//     run over a CTA's own columns, and each reduction folds every CTA's
//     result, posted to a slot in its shared memory, after one cluster
//     barrier (`cluster_reduce`); pass A's also takes the normalizers,
//     so a step has two (three in the off modes). A CTA still
//     waits only on CTAs of its own cluster, which the hardware
//     co-schedules. A last barrier keeps every CTA's shared memory alive
//     while the others may read it.
//   * The global carry, past the cluster's reach or where the slices do
//     not fit, keeps d/b/free in the window's rows of the outputs
//     d1/b1/f1 (no copy at the end), the TPOT in its (I,) scratch, and b0
//     and, per window, a step's cost and latency in a ((1 + 2K), I)
//     scratch, L2-resident (about 330 KB at I = 16,384, K = 1).
// Only the owner of a column writes it in the scan, every column's
// arithmetic is the same, and every per-step reduction is a max, an any
// or a lexicographic arg-max / arg-min, exact in any grouping: the three
// carries are bitwise equal. What other CTAs wrote (the label mixes, the
// TPOT, the affinity factors, the global carry's rows) is read through
// L2 (__ldcg).
// The dynamic shared memory is the larger of stage 1's need and the
// scan's, and every CTA gets it. At the main path's I = 16 that is stage
// 1's (43 KB at the 4-row tile), and registers (128 a thread, for the
// scan) hold the kernel to two CTAs an SM; at I = 4096 the shared carry
// makes it about 115 KB, one CTA an SM, so stage 1 runs in about twice
// the waves there; with the global carry it is stage 1's again, and with
// the cluster carry's 1,024 columns a CTA (28 KB) it is about stage 1's
// (32 KB at R = 16, M = 16). The shared carry's boundary is measured, not
// the opt-in limit: the global carry's reads from L2 cost the scan more
// than stage 1's second CTA an SM gains at I = 4096 for R >= 16, and
// less at I = 8192 (chip_smoke.py times the carries about the
// boundaries).
//
// Timers. With `timers` set (a traced call), thread 0 of block (0, 0)
// writes %globaltimer at the kernel's entry (the block dispatched first;
// the trees end at least one tree walk after it); the CTA that draws the
// trees' last ticket writes it into 1 + 4w for every window w (the end of
// the last slice: the trees and, with the term on, the affinity factors);
// and the CTA that scans window w (on the cluster carry, rank 0 of the
// scanning cluster) writes it at 2 + 4w when its scan starts and at 3 +
// 4w after the greedy loop, and at 4 + 4w the loop's pass A time: over
// the steps, the sum of each step's start to the end of pass A's
// admission reduction (cost, latency with its affinity factor read, and
// Eq. 2 over every instance; on the cluster carry the same reduction also
// takes the normalizers), read by the scan's thread 0.
// Where no reduction closes pass A (no budget filter, off the cluster
// carry) a traced call adds a barrier there. Null (every untraced call): one branch on the pointer
// a step. Nothing reads the buffer and a barrier changes no
// value, so the outputs are the same either way.
//
// Exactness. Everything after the distance dot product spells the
// plain PyTorch version's operations one by one, with IEEE rounding:
// the file is built with --fmad=false and uses __fadd_rn/__fmul_rn/
// __fdiv_rn/__fsqrt_rn, never fast math; the TPOT sums its trees in
// order; quantization rounds half to even (rintf); every argmax/argmin
// takes the lowest index on ties, and the top-k orders by (distance,
// index), so no split layout changes a result.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <climits>

#include "knn_common.cuh"

namespace cg = cooperative_groups;

namespace {

using knn::FULL;
using knn::lex_less;
using knn::warp_argmin;
constexpr int THREADS = knn::THREADS;
constexpr float QUANTUM = 1.220703125e-4f;   // 2^-13
constexpr float INV_QUANTUM = 8192.0f;

enum Mode { FULL_MODE = 0, OFF_REACTIVE = 1, OFF_PREDICTIVE = 2,
            STATIC_PRIOR = 3 };

}  // namespace

// Field order and types are mirrored by a ctypes.Structure in
// repro_torch/kernels/decision_megakernel.py: pointers first, then ints,
// then floats.
struct RtDecisionParams {
  const float* emb;          // (K, R, E)
  const uint8_t* row_valid;  // (K, R)
  const float* budgets;      // (K, R), nan = no budget
  const float* len_in;       // (K, R)
  const int* psig;           // (K, R, sig_w)
  const float* d;            // (I,) telemetry mirror
  const float* b;
  const float* free_;
  const float* ctx;
  const uint8_t* alive;      // (I,)
  const float* x;            // (N, E)
  const float* xsq;          // (N,)
  const float* qual;         // (N, M)
  const float* leng;         // (N, M)
  const int* m_of_i;         // (I,)
  const int* tier_of_i;      // (I,)
  const float* maxb;
  const float* price_in;
  const float* price_out;
  const float* nominal;
  const int* sig_plane;      // (I, sig_slots)
  const int* gfeat;          // (tiers, n_trees, n_internal)
  const float* gthr;         // (tiers, n_trees, n_internal)
  const float* gleaf;        // (tiers, n_trees, n_leaves)
  const float* gbase;        // (tiers,)
  float* cand_d;             // (K*R, S, k) scratch: split lists
  int* cand_i;
  int* tickets;              // (row tiles,) scratch, left 0
  int* wtickets;             // (K + 1,) scratch, left 0: a ticket per
                             // window, then the trees'
  float* qmix;               // (K*R, M) scratch: label mixes
  float* lmix;
  float* plm;                // (K*R,) scratch: LPT key
  float* tpot;               // (I,) scratch: the TPOT heads
  float* scan_i;             // (1 + 2K, I) scratch of the global carry
                             // (b0, then per window a step's cost and
                             // latency), or null: the shared carry
  float* aff;                // (K*R, I) scratch: the affinity factors,
                             // or null: the term is off
  int* choice;               // (K, R)
  float* est;                // (K, R)
  float* lchosen;            // (K, R)
  float* d1;                 // (K, I)
  float* b1;
  float* f1;
  long long* timers;         // (1 + 4K,) %globaltimer stamps, or null
  int K, R, E, N, M, I, k, per_split;
  int sig_w, sig_slots;
  int n_trees, n_internal, n_leaves, depth;
  int mode, lpt, budget_filter, use_gbm, use_aff;
  float eps, wq, wl, wc, w_aff, lr;
};

namespace {

__device__ __forceinline__ long long global_timer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool lex_greater(float av, int ai, float bv,
                                            int bi) {
  return av > bv || (av == bv && ai < bi);
}

// ---------------------------------------------------------------------------
// After stage 1's merge: a row's weights, label mixes and LPT key.

struct MixRow {
  const RtDecisionParams* p;
  // lane r < k holds the row's r-th nearest (d, idx); called by the warp
  __device__ void operator()(int row, int lane, float my_d, int my_i) const {
    const int k = p->k, M = p->M;
    float wgt = (lane < k)
        ? __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(fmaxf(my_d, 0.f)), p->eps))
        : 0.f;
    float wsum = __shfl_sync(FULL, wgt, 0);
    for (int j = 1; j < k; ++j) wsum = __fadd_rn(wsum, __shfl_sync(FULL, wgt, j));
    wgt = __fdiv_rn(wgt, wsum);
    float lmax = -INFINITY;
    for (int m0 = 0; m0 < M; m0 += 32) {
      const int m = m0 + lane;
      float aq = 0.f, al = 0.f;
      for (int j = 0; j < k; ++j) {
        const float wj = __shfl_sync(FULL, wgt, j);
        const int ij = __shfl_sync(FULL, my_i, j);
        if (m < M) {
          const size_t o = (size_t)ij * M + m;
          aq = __fadd_rn(aq, __fmul_rn(p->qual[o], wj));
          al = __fadd_rn(al, __fmul_rn(p->leng[o], wj));
        }
      }
      if (m < M) {
        p->qmix[(size_t)row * M + m] = aq;
        p->lmix[(size_t)row * M + m] = al;
        lmax = fmaxf(lmax, al);
      }
    }
    for (int off = 16; off; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, off));
    if (lane == 0) p->plm[row] = p->row_valid[row] ? lmax : -1e30f;
  }
};

// ---------------------------------------------------------------------------
// The scan of one window, by one CTA.

struct ScanSmem {
  float* qmix;   // R x M
  float* lmix;   // R x M
  float* plm;    // R   LPT key
  int* order;    // R
  float* bud;    // R
  float* lin;    // R
  int* rv;       // R
  int* pick;     // R
  float* est;    // R
  float* d;      // I   carry
  float* b;      // I   carry
  float* fr;     // I   carry
  float* b0;     // I
  float* tpot;   // I
  float* tc;     // I   this step's cost, then its score
  float* tt;     // I   this step's latency
  float* redf;   // 64
  int* redi;     // 32
};

// Element i of d, b, fr, b0 or tpot in the scan: with the global carry
// (GL) the grid wrote them before the scan, so they are read from L2.
template <bool GL>
__device__ __forceinline__ float ld(const float* a, int i) {
  return GL ? __ldcg(a + i) : a[i];
}

// Shared-memory words of the scan: the R-length arrays, the reduction
// words and the seven per-instance arrays of the `cols` columns a CTA
// holds there: I with the shared carry, ceil(I / C) with the cluster
// carry, 0 with the global carry. (The wrapper's `scan_smem_bytes`.)
__host__ __device__ inline size_t scan_smem_words(int R, int M, int cols) {
  return (size_t)2 * R * M + (size_t)7 * R + (size_t)7 * cols + 96;
}

// The scan's arrays for window w: the R-length ones and the reduction
// words from shared memory; the per-instance ones from shared memory too,
// `cols` of each (shared and cluster carry), or (global carry) the carry
// d/b/free in the window's rows of the outputs d1/b1/f1, the TPOT in its
// scratch, b0 in the carry's first scratch row and a step's cost and
// latency in the window's two.
__device__ ScanSmem carve(float* base, const RtDecisionParams& prm, int w,
                          int cols) {
  const int R = prm.R, M = prm.M, I = prm.I;
  ScanSmem s;
  float* p = base;
  s.qmix = p; p += (size_t)R * M;
  s.lmix = p; p += (size_t)R * M;
  s.plm = p; p += R;
  s.order = reinterpret_cast<int*>(p); p += R;
  s.bud = p; p += R;
  s.lin = p; p += R;
  s.rv = reinterpret_cast<int*>(p); p += R;
  s.pick = reinterpret_cast<int*>(p); p += R;
  s.est = p; p += R;
  if (prm.scan_i == nullptr) {
    s.d = p; p += cols;
    s.b = p; p += cols;
    s.fr = p; p += cols;
    s.b0 = p; p += cols;
    s.tpot = p; p += cols;
    s.tc = p; p += cols;
    s.tt = p; p += cols;
  } else {
    const size_t o = (size_t)w * I;
    s.d = prm.d1 + o;
    s.b = prm.b1 + o;
    s.fr = prm.f1 + o;
    s.tpot = prm.tpot;
    s.b0 = prm.scan_i;
    s.tc = prm.scan_i + (1 + 2 * (size_t)w) * I;
    s.tt = s.tc + I;
  }
  s.redf = p; p += 64;
  s.redi = reinterpret_cast<int*>(p);
  return s;
}

// Block-wide reductions: warp shuffles, then the warps' results through
// shared memory. Every thread ends with the result.
__device__ void red_argmin(float& v, int& i, ScanSmem& s) {
  warp_argmin(v, i);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) { s.redf[w] = v; s.redi[w] = i; }
  __syncthreads();
  v = s.redf[0]; i = s.redi[0];
  for (int j = 1; j < nw; ++j)
    if (lex_less(s.redf[j], s.redi[j], v, i)) { v = s.redf[j]; i = s.redi[j]; }
  __syncthreads();
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (lex_greater(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ void red_argmax(float& v, int& i, ScanSmem& s) {
  warp_argmax(v, i);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) { s.redf[w] = v; s.redi[w] = i; }
  __syncthreads();
  v = s.redf[0]; i = s.redi[0];
  for (int j = 1; j < nw; ++j)
    if (lex_greater(s.redf[j], s.redi[j], v, i)) { v = s.redf[j]; i = s.redi[j]; }
  __syncthreads();
}

__device__ __forceinline__ void warp_max2(float& a, float& b) {
  for (int off = 16; off; off >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(FULL, a, off));
    b = fmaxf(b, __shfl_xor_sync(FULL, b, off));
  }
}

__device__ void red_max2(float& a, float& b, ScanSmem& s) {
  warp_max2(a, b);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) { s.redf[w] = a; s.redf[32 + w] = b; }
  __syncthreads();
  a = s.redf[0]; b = s.redf[32];
  for (int j = 1; j < nw; ++j) {
    a = fmaxf(a, s.redf[j]); b = fmaxf(b, s.redf[32 + j]);
  }
  __syncthreads();
}

__device__ void red_any_argmin(bool& any, float& v, int& i, ScanSmem& s) {
  any = __any_sync(FULL, any);
  warp_argmin(v, i);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s.redf[w] = v; s.redi[w] = i; s.redf[32 + w] = any ? 1.f : 0.f;
  }
  __syncthreads();
  v = s.redf[0]; i = s.redi[0]; any = s.redf[32] != 0.f;
  for (int j = 1; j < nw; ++j) {
    if (lex_less(s.redf[j], s.redi[j], v, i)) { v = s.redf[j]; i = s.redi[j]; }
    any = any || (s.redf[32 + j] != 0.f);
  }
  __syncthreads();
}

__device__ __forceinline__ float quantize(float v) {
  return __fmul_rn(rintf(__fmul_rn(v, INV_QUANTUM)), QUANTUM);
}

// Instance i's constants, as the scan reads them
struct Inst {
  float pin, pout, nom, tp, b0;
};

// A row's cost c and latency T on instance i (carry d, b, free), as the
// plain version forms them; with the affinity term (AFF), T times the
// factor the grid wrote for the row on instance i (`arow`, the row's
// factors).
template <bool AFF>
__device__ __forceinline__ void cost_latency(
    const RtDecisionParams& p, const float* arow, int i, const Inst& in,
    float lin, float l, float d, float b, float fr, float& c, float& T) {
  c = __fmul_rn(__fadd_rn(__fmul_rn(lin, in.pin), __fmul_rn(l, in.pout)),
                1e-6f);
  const float wait = (fr > 0.f) ? 0.f : __fdiv_rn(d, fmaxf(b, 1.f));
  const float tpe = __fmul_rn(in.tp, fmaxf(__fdiv_rn(b, in.b0), 1.f));
  T = (p.mode == STATIC_PRIOR) ? __fmul_rn(in.nom, l)
                               : __fmul_rn(tpe, __fadd_rn(wait, l));
  if (AFF) T = __fmul_rn(T, __ldcg(arow + i));
}

// Eq. 1, quantized: the row's score of one allowed instance
__device__ __forceinline__ float score(const RtDecisionParams& p, float wl,
                                       float q, float c, float T, float cmax,
                                       float tmax) {
  return quantize(__fadd_rn(
      __fadd_rn(__fmul_rn(p.wq, q),
                __fmul_rn(p.wc, __fsub_rn(1.f, __fdiv_rn(c, cmax)))),
      __fmul_rn(wl, __fsub_rn(1.f, __fdiv_rn(T, tmax)))));
}

// The R-step greedy loop for I <= 32, in one warp: lane i holds instance
// i's constants and carry in registers and writes d1/b1/f1 at the end.
template <bool GL, bool AFF>
__device__ void run_scan_warp(const RtDecisionParams& p, ScanSmem& s, int w,
                              int lane) {
  const int I = p.I, M = p.M;
  const bool off = p.mode == OFF_REACTIVE || p.mode == OFF_PREDICTIVE;
  const float wl = off ? 0.f : p.wl;
  const bool mine = lane < I;
  const int i = lane;
  int m_i = 0;
  Inst in{0.f, 0.f, 0.f, 0.f, 1.f};
  float d = 0.f, b = 1.f, fr = 0.f, maxb = 0.f;
  bool al = false;
  if (mine) {
    m_i = p.m_of_i[i];
    in = Inst{p.price_in[i], p.price_out[i], p.nominal[i],
              ld<GL>(s.tpot, i), ld<GL>(s.b0, i)};
    d = ld<GL>(s.d, i); b = ld<GL>(s.b, i); fr = ld<GL>(s.fr, i);
    maxb = p.maxb[i];
    al = p.alive[i] != 0;
  }
  const bool timed = p.timers != nullptr;
  long long pass_a = 0;                     // traced: pass A's time
  for (int t = 0; t < p.R; ++t) {
    const long long ta = (timed && lane == 0) ? global_timer() : 0;
    const int rr = s.order[t];
    const float lin = s.lin[rr];
    const float bud = s.bud[rr];
    const bool has_budget = !isnan(bud);
    const float* arow = AFF ? p.aff + ((size_t)w * p.R + rr) * I : nullptr;

    float c = 0.f, T = 0.f, l = 0.f, q = 0.f;
    bool ok = false;
    float cs_v = INFINITY;          // lanes past I stay (inf, INT_MAX)
    int cs_i = INT_MAX;
    if (mine) {
      l = s.lmix[rr * M + m_i];
      q = s.qmix[rr * M + m_i];
      cost_latency<AFF>(p, arow, i, in, lin, l, d, b, fr, c, T);
      ok = al && (!has_budget || c <= bud);
      cs_v = al ? c : INFINITY;
      cs_i = i;
    }
    bool allowed = al;
    if (p.budget_filter) {
      const bool any_c = __any_sync(FULL, ok);
      warp_argmin(cs_v, cs_i);
      allowed = mine && (any_c ? ok : (i == cs_i));
    } else if (timed) {
      __syncwarp();
    }
    if (timed && lane == 0) pass_a += global_timer() - ta;
    float cmax = allowed ? c : -INFINITY, tmax = allowed ? T : -INFINITY;
    warp_max2(cmax, tmax);
    cmax = fmaxf(cmax, 1e-12f);
    tmax = fmaxf(tmax, 1e-12f);
    const float sc = allowed ? score(p, wl, q, c, T, cmax, tmax) : -INFINITY;
    int win;
    if (off) {
      float best = sc;
      float tie = !mine ? -INFINITY
                        : (p.mode == OFF_REACTIVE) ? __fadd_rn(d, b) : T;
      const float tie_own = tie;
      warp_max2(best, tie);
      const float den = fmaxf(tie, 1e-9f);
      float v = INFINITY;
      int vi = INT_MAX;
      if (mine) {
        v = (sc >= best) ? __fdiv_rn(tie_own, den) : INFINITY;
        vi = i;
      }
      warp_argmin(v, vi);
      win = vi;
    } else {
      float v = mine ? sc : -INFINITY;
      int vi = mine ? i : INT_MAX;
      warp_argmax(v, vi);
      win = vi;
    }
    // the winning lane records it and dead-reckons
    if (i == win) {
      s.pick[rr] = win;
      s.est[rr] = T;
      const bool v = s.rv[rr] != 0;
      d = __fadd_rn(d, v ? l : 0.f);
      const bool has_free = (fr > 0.f) && v;
      fr = __fadd_rn(fr, has_free ? -1.f : -0.f);
      if (has_free) b = fminf(__fadd_rn(b, 1.f), maxb);
    }
    __syncwarp();
  }
  if (mine) {
    const size_t o = (size_t)w * I + i;
    p.d1[o] = d;
    p.b1[o] = b;
    p.f1[o] = fr;
  }
  if (timed && lane == 0) p.timers[4 + 4 * w] = pass_a;
}

// The R-step greedy loop for I > 32, by the whole block: thread `tid`
// owns the instances i = tid (mod blockDim.x). Every I-length array is
// written by the owner of the column only (tpot, b0 and the initial
// carry before the scan began), so the carry may sit in shared memory or
// in global memory (the outputs themselves) with the same operations in
// the same order.
template <bool GL, bool AFF>
__device__ void run_scan_block(const RtDecisionParams& p, ScanSmem& s, int w) {
  const int I = p.I, M = p.M, tid = threadIdx.x, nthr = blockDim.x;
  const bool off = p.mode == OFF_REACTIVE || p.mode == OFF_PREDICTIVE;
  const float wl = off ? 0.f : p.wl;
  const bool timed = p.timers != nullptr;
  long long pass_a = 0;                     // traced: pass A's time
  for (int t = 0; t < p.R; ++t) {
    const long long ta = (timed && tid == 0) ? global_timer() : 0;
    const int rr = s.order[t];
    const float lin = s.lin[rr];
    const float bud = s.bud[rr];
    const bool has_budget = !isnan(bud);
    const float* arow = AFF ? p.aff + ((size_t)w * p.R + rr) * I : nullptr;

    // pass A: cost and latency per instance; admission reductions
    bool any_c = false;
    float cs_v = INFINITY;
    int cs_i = INT_MAX;
    for (int i = tid; i < I; i += nthr) {
      const float l = s.lmix[rr * M + p.m_of_i[i]];
      const bool al = p.alive[i] != 0;
      const Inst in{p.price_in[i], p.price_out[i], p.nominal[i],
                    ld<GL>(s.tpot, i), ld<GL>(s.b0, i)};
      float c, T;
      cost_latency<AFF>(p, arow, i, in, lin, l, ld<GL>(s.d, i),
                        ld<GL>(s.b, i), ld<GL>(s.fr, i), c, T);
      s.tc[i] = c;
      s.tt[i] = T;
      any_c = any_c || (al && (!has_budget || c <= bud));
      const float csel = al ? c : INFINITY;
      if (lex_less(csel, i, cs_v, cs_i)) { cs_v = csel; cs_i = i; }
    }
    if (p.budget_filter) red_any_argmin(any_c, cs_v, cs_i, s);
    else if (timed) __syncthreads();
    if (timed && tid == 0) pass_a += global_timer() - ta;

    // pass B: normalizers over the allowed candidates
    float cmax = -INFINITY, tmax = -INFINITY;
    for (int i = tid; i < I; i += nthr) {
      const bool al = p.alive[i] != 0;
      const float c = s.tc[i];
      bool allowed = al;
      if (p.budget_filter)
        allowed = any_c ? (al && (!has_budget || c <= bud)) : (i == cs_i);
      if (allowed) { cmax = fmaxf(cmax, c); tmax = fmaxf(tmax, s.tt[i]); }
    }
    red_max2(cmax, tmax, s);
    cmax = fmaxf(cmax, 1e-12f);
    tmax = fmaxf(tmax, 1e-12f);

    // pass C: Eq. 1 scores, quantized; argmax, or (off modes) the score
    // max and the tie metric's max over ALL columns
    float best_v = -INFINITY, tie_max = -INFINITY;
    int best_i = INT_MAX;
    for (int i = tid; i < I; i += nthr) {
      const bool al = p.alive[i] != 0;
      const float c = s.tc[i], T = s.tt[i];
      bool allowed = al;
      if (p.budget_filter)
        allowed = any_c ? (al && (!has_budget || c <= bud)) : (i == cs_i);
      const float q = s.qmix[rr * M + p.m_of_i[i]];
      const float sc =
          allowed ? score(p, wl, q, c, T, cmax, tmax) : -INFINITY;
      if (off) {
        s.tc[i] = sc;
        best_v = fmaxf(best_v, sc);
        const float tie = (p.mode == OFF_REACTIVE)
                              ? __fadd_rn(ld<GL>(s.d, i), ld<GL>(s.b, i)) : T;
        tie_max = fmaxf(tie_max, tie);
      } else if (lex_greater(sc, i, best_v, best_i)) {
        best_v = sc; best_i = i;
      }
    }
    int win;
    if (off) {
      red_max2(best_v, tie_max, s);
      const float den = fmaxf(tie_max, 1e-9f);
      float v = INFINITY;
      int vi = INT_MAX;
      for (int i = tid; i < I; i += nthr) {
        const float tie = (p.mode == OFF_REACTIVE)
                              ? __fadd_rn(ld<GL>(s.d, i), ld<GL>(s.b, i))
                              : s.tt[i];
        const float cand = (s.tc[i] >= best_v) ? __fdiv_rn(tie, den)
                                               : INFINITY;
        if (lex_less(cand, i, v, vi)) { v = cand; vi = i; }
      }
      red_argmin(v, vi, s);
      win = vi;
    } else {
      red_argmax(best_v, best_i, s);
      win = best_i;
    }

    // the owner of the winning column records it and dead-reckons
    if (win % nthr == tid) {
      s.pick[rr] = win;
      s.est[rr] = s.tt[win];
      const bool v = s.rv[rr] != 0;
      const float l = s.lmix[rr * M + p.m_of_i[win]];
      s.d[win] = __fadd_rn(ld<GL>(s.d, win), v ? l : 0.f);
      const float fr = ld<GL>(s.fr, win);
      const bool has_free = (fr > 0.f) && v;
      s.fr[win] = __fadd_rn(fr, has_free ? -1.f : -0.f);
      if (has_free)
        s.b[win] = fminf(__fadd_rn(ld<GL>(s.b, win), 1.f), p.maxb[win]);
    }
    __syncthreads();
  }
  if (timed && tid == 0) p.timers[4 + 4 * w] = pass_a;
  if (GL) return;                           // the carry is the output
  for (int i = tid; i < I; i += nthr) {
    const size_t o = (size_t)w * I + i;
    p.d1[o] = s.d[i];
    p.b1[o] = s.b[i];
    p.f1[o] = s.fr[i];
  }
}

// ---------------------------------------------------------------------------
// The cluster carry's reductions: a partial a warp, folded under one of
// the exact operations below, so that no grouping changes a bit.

struct Part {
  float v, u;   // a value, and a second value
  int i;        // a column
};

// A step's admission and normalizers, folded in one reduction: the
// cheapest alive column (v its cost, or inf where none is alive, i the
// column) with its cost c and latency t as they are; whether any column
// is admitted; and the max cost and latency over the admitted columns
// (over the alive ones without the budget filter).
struct Adm {
  float v, c, t, any, cm, tm;
  int i;
};

struct ArgMax {       // the highest v, the lowest column on ties
  __device__ Part operator()(const Part& a, const Part& b) const {
    return lex_greater(b.v, b.i, a.v, a.i) ? b : a;
  }
};
struct ArgMin {       // the lowest v, the lowest column on ties
  __device__ Part operator()(const Part& a, const Part& b) const {
    return lex_less(b.v, b.i, a.v, a.i) ? b : a;
  }
};
struct Max2 {         // the max of v and the max of u
  __device__ Part operator()(const Part& a, const Part& b) const {
    return Part{fmaxf(a.v, b.v), fmaxf(a.u, b.u), 0};
  }
};
struct AdmOp {        // ArgMin of (v, i) with its (c, t); any; the maxes
  __device__ Adm operator()(const Adm& a, const Adm& b) const {
    Adm r = lex_less(b.v, b.i, a.v, a.i) ? b : a;
    r.any = fmaxf(a.any, b.any);
    r.cm = fmaxf(a.cm, b.cm);
    r.tm = fmaxf(a.tm, b.tm);
    return r;
  }
};

__device__ __forceinline__ Part shfl_xor(const Part& x, int off) {
  return Part{__shfl_xor_sync(FULL, x.v, off), __shfl_xor_sync(FULL, x.u, off),
              __shfl_xor_sync(FULL, x.i, off)};
}
__device__ __forceinline__ Adm shfl_xor(const Adm& x, int off) {
  return Adm{__shfl_xor_sync(FULL, x.v, off), __shfl_xor_sync(FULL, x.c, off),
             __shfl_xor_sync(FULL, x.t, off), __shfl_xor_sync(FULL, x.any, off),
             __shfl_xor_sync(FULL, x.cm, off), __shfl_xor_sync(FULL, x.tm, off),
             __shfl_xor_sync(FULL, x.i, off)};
}

template <class T, class Op>
__device__ __forceinline__ T warp_fold(T x, const Op& op) {
  for (int off = 16; off; off >>= 1) x = op(x, shfl_xor(x, off));
  return x;
}

constexpr int WARPS = THREADS / 32;

// One reduction over the cluster, in two levels: each warp folds its
// lanes, warp 0 folds the warps' results into the CTA's, posted to buffer
// `buf` in its shared memory; after one cluster barrier each warp reads
// the C CTAs' results through distributed shared memory, one a lane, and
// folds them. Every thread returns the result. (Every warp reading every
// warp's result of every CTA moved 8 times the remote words and cost the
// step more than the block barrier that this saves.) `buf` flips at every
// reduction, whatever its type, so two reductions in a row never share a
// buffer and one cluster barrier a reduction is enough: a buffer is
// written again only after the next reduction's barrier, which every
// reader of its last value passes only once it has read it.
template <class T, class Op>
__device__ T cluster_reduce(T x, T id, const Op& op, T (*slots)[WARPS + 1],
                            int& buf, cg::cluster_group& cl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* sl = slots[buf];                       // the warps' results, the CTA's
  x = warp_fold(x, op);
  if (lane == 0) sl[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = warp_fold(lane < WARPS ? sl[lane] : id, op);
    if (lane == 0) sl[WARPS] = x;
  }
  cl.sync();
  x = lane < (int)cl.num_blocks() ? cl.map_shared_rank(sl, lane)[WARPS] : id;
  buf ^= 1;
  return warp_fold(x, op);
}

// The R-step greedy loop on the cluster carry: this CTA holds columns
// [i0, i0 + n) of the roster in its shared memory (local column j is
// instance i0 + j) and thread `tid` owns the local columns j = tid (mod
// blockDim.x). Each pass runs over the CTA's own columns with the block
// scan's operations, indices global; its reduction spans the cluster, and
// pass A's also takes the normalizers that the block scan's pass B finds
// (so a step has two reductions, three in the off modes). The CTA that
// owns the winning column dead-reckons it and keeps its latency; every
// CTA records the pick. Each CTA writes its slice of d1/b1/f1.
template <bool AFF>
__device__ void run_scan_cluster(const RtDecisionParams& p, ScanSmem& s,
                                 int w, int i0, int n) {
  __shared__ Part slots[2][WARPS + 1];
  __shared__ Adm aslots[2][WARPS + 1];
  cg::cluster_group cl = cg::this_cluster();
  const int I = p.I, M = p.M, tid = threadIdx.x, nthr = blockDim.x;
  const bool off = p.mode == OFF_REACTIVE || p.mode == OFF_PREDICTIVE;
  const float wl = off ? 0.f : p.wl;
  const bool stamp = p.timers != nullptr && tid == 0 && cl.block_rank() == 0;
  const Part lo{-INFINITY, -INFINITY, INT_MAX}, hi{INFINITY, 0.f, INT_MAX};
  const Adm none{INFINITY, 0.f, 0.f, 0.f, -INFINITY, -INFINITY, INT_MAX};
  int buf = 0;
  long long pass_a = 0;                     // traced: pass A's time
  for (int t = 0; t < p.R; ++t) {
    const long long ta = stamp ? global_timer() : 0;
    const int rr = s.order[t];
    const float lin = s.lin[rr];
    const float bud = s.bud[rr];
    const bool has_budget = !isnan(bud);
    const float* arow = AFF ? p.aff + ((size_t)w * p.R + rr) * I : nullptr;

    // pass A: cost and latency per instance; admission and, in the same
    // reduction, the normalizers over the allowed candidates: the
    // admitted columns' maxes where any is admitted, else the cheapest
    // alive column's own cost and latency (the block scan's pass B)
    Adm a = none;
    for (int j = tid; j < n; j += nthr) {
      const int i = i0 + j;
      const float l = s.lmix[rr * M + p.m_of_i[i]];
      const bool al = p.alive[i] != 0;
      const Inst in{p.price_in[i], p.price_out[i], p.nominal[i], s.tpot[j],
                    s.b0[j]};
      float c, T;
      cost_latency<AFF>(p, arow, i, in, lin, l, s.d[j], s.b[j], s.fr[j], c,
                        T);
      s.tc[j] = c;
      s.tt[j] = T;
      const bool adm = al && (!has_budget || c <= bud);
      if (adm) a.any = 1.f;
      if (p.budget_filter ? adm : al) {
        a.cm = fmaxf(a.cm, c);
        a.tm = fmaxf(a.tm, T);
      }
      const float csel = al ? c : INFINITY;
      if (lex_less(csel, i, a.v, a.i)) {
        a.v = csel; a.i = i; a.c = c; a.t = T;
      }
    }
    a = cluster_reduce(a, none, AdmOp{}, aslots, buf, cl);
    if (stamp) pass_a += global_timer() - ta;
    const bool any_c = a.any != 0.f;
    const int cs_i = a.i;
    const bool one = p.budget_filter && !any_c;
    const float cmax = fmaxf(one ? a.c : a.cm, 1e-12f);
    const float tmax = fmaxf(one ? a.t : a.tm, 1e-12f);

    // pass C: Eq. 1 scores, quantized; argmax, or (off modes) the score
    // max and the tie metric's max over ALL columns
    float best_v = -INFINITY, tie_max = -INFINITY;
    int best_i = INT_MAX;
    for (int j = tid; j < n; j += nthr) {
      const int i = i0 + j;
      const bool al = p.alive[i] != 0;
      const float c = s.tc[j], T = s.tt[j];
      bool allowed = al;
      if (p.budget_filter)
        allowed = any_c ? (al && (!has_budget || c <= bud)) : (i == cs_i);
      const float q = s.qmix[rr * M + p.m_of_i[i]];
      const float sc =
          allowed ? score(p, wl, q, c, T, cmax, tmax) : -INFINITY;
      if (off) {
        s.tc[j] = sc;
        best_v = fmaxf(best_v, sc);
        const float tie = (p.mode == OFF_REACTIVE)
                              ? __fadd_rn(s.d[j], s.b[j]) : T;
        tie_max = fmaxf(tie_max, tie);
      } else if (lex_greater(sc, i, best_v, best_i)) {
        best_v = sc; best_i = i;
      }
    }
    int win;
    if (off) {
      const Part bt = cluster_reduce(Part{best_v, tie_max, 0}, lo, Max2{},
                                     slots, buf, cl);
      const float den = fmaxf(bt.u, 1e-9f);
      float v = INFINITY;
      int vi = INT_MAX;
      for (int j = tid; j < n; j += nthr) {
        const int i = i0 + j;
        const float tie = (p.mode == OFF_REACTIVE)
                              ? __fadd_rn(s.d[j], s.b[j]) : s.tt[j];
        const float cand = (s.tc[j] >= bt.v) ? __fdiv_rn(tie, den)
                                             : INFINITY;
        if (lex_less(cand, i, v, vi)) { v = cand; vi = i; }
      }
      win = cluster_reduce(Part{v, 0.f, vi}, hi, ArgMin{}, slots, buf, cl).i;
    } else {
      win = cluster_reduce(Part{best_v, 0.f, best_i}, lo, ArgMax{}, slots,
                           buf, cl).i;
    }

    // every CTA records the pick; the owner of the winning column keeps
    // its latency and dead-reckons it
    if (tid == 0) s.pick[rr] = win;
    const int j = win - i0;
    if (j >= 0 && j < n && j % nthr == tid) {
      s.est[rr] = s.tt[j];
      const bool v = s.rv[rr] != 0;
      const float l = s.lmix[rr * M + p.m_of_i[win]];
      s.d[j] = __fadd_rn(s.d[j], v ? l : 0.f);
      const float fr = s.fr[j];
      const bool has_free = (fr > 0.f) && v;
      s.fr[j] = __fadd_rn(fr, has_free ? -1.f : -0.f);
      if (has_free) s.b[j] = fminf(__fadd_rn(s.b[j], 1.f), p.maxb[win]);
    }
  }
  if (stamp) p.timers[4 + 4 * w] = pass_a;
  for (int j = tid; j < n; j += nthr) {
    const size_t o = (size_t)w * I + i0 + j;
    p.d1[o] = s.d[j];
    p.b1[o] = s.b[j];
    p.f1[o] = s.fr[j];
  }
}

// Instance i's TPOT (window-invariant), by one warp: a lane per tree,
// the leaf values summed in tree order by shuffles. Every lane returns it.
__device__ float tpot_of(const RtDecisionParams& p, int i, int lane) {
  if (!p.use_gbm) return p.nominal[i];
  const int leaf0 = (1 << p.depth) - 1;
  const float beff = fmaxf(p.b[i], 1.f);
  const float f0 = beff, f1 = p.d[i], f2 = fmaxf(p.ctx[i], 64.f);
  const float f3 = __fmul_rn(beff, f2);
  const int tier = p.tier_of_i[i];
  float out = __fadd_rn(0.f, p.gbase[tier]);
  for (int t0 = 0; t0 < p.n_trees; t0 += 32) {
    const int t = t0 + lane;
    float v = 0.f;
    if (t < p.n_trees) {
      const size_t tr = (size_t)tier * p.n_trees + t;
      const int* f = p.gfeat + tr * p.n_internal;
      const float* th = p.gthr + tr * p.n_internal;
      int node = 0;
      for (int lv = 0; lv < p.depth; ++lv) {
        const int fi = f[node];
        const float fv = fi == 0 ? f0 : fi == 1 ? f1 : fi == 2 ? f2 : f3;
        node = 2 * node + 1 + (fv > th[node] ? 1 : 0);
      }
      v = __fmul_rn(p.lr, p.gleaf[tr * p.n_leaves + (node - leaf0)]);
    }
    const int n = min(32, p.n_trees - t0);
    for (int j = 0; j < n; ++j) out = __fadd_rn(out, __shfl_sync(FULL, v, j));
  }
  return fmaxf(out, 1e-4f);
}

// Instance i's sketch as a warp holds it: lane l has slots l and l + 32,
// 0 past the plane's width (a signature is never 0) and on a dead
// instance, whose factors are those of no hit.
struct Sketch {
  const int* pl;
  int s0, s1;
  bool al;
};

__device__ __forceinline__ Sketch load_sketch(const RtDecisionParams& p,
                                              int i, int lane) {
  const int S = p.sig_slots;
  const int* pl = p.sig_plane + (size_t)i * S;
  const bool al = p.alive[i] != 0;
  return Sketch{pl, (al && lane < S) ? pl[lane] : 0,
                (al && lane + 32 < S) ? pl[lane + 32] : 0, al};
}

// Whether the warp's sketch holds `sig`, on every lane (slots past 64 are
// read again from the plane).
__device__ __forceinline__ bool holds(const Sketch& k, int S, int lane,
                                      int sig) {
  bool m = k.s0 == sig || k.s1 == sig;
  for (int j = 64 + lane; j < S; j += 32) m |= k.pl[j] == sig;
  return __any_sync(FULL, m) != 0;
}

// Instance i's prefix-affinity factor 1 - w_aff * hit for each of the
// K*R rows, by one warp. The hit is the plain version's: the run of a
// row's leading signature columns (a 0 ends it) found among the sketch's
// slots, times 16 tokens, over the row's input length, and 0 on a dead
// instance. In each 32 rows, lane r reads row r's first signature and
// the rows' first columns are voted on one after another (independent
// votes, unrolled); only the rows that matched go on column by column.
// A run of 0 gives a hit of +0 whatever the length, so its factor is f0,
// the dead instance's. Lane r keeps row r's factor and the 32 are stored
// at once.
__device__ void affinity_factors(const RtDecisionParams& p, int i, int lane,
                                 const Sketch& k) {
  const int KR = p.K * p.R, S = p.sig_slots, W = p.sig_w;
  const float f0 = __fsub_rn(1.f, __fmul_rn(p.w_aff, 0.f));
  for (int rw0 = 0; rw0 < KR; rw0 += 32) {
    const int n = min(32, KR - rw0);
    const int first = (k.al && W > 0 && lane < n)
                          ? p.psig[(size_t)(rw0 + lane) * W] : 0;
    unsigned todo = 0;                      // rows whose column 0 matched
    if (k.al) {
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const int sig = __shfl_sync(FULL, first, r);
        todo |= (sig != 0 && holds(k, S, lane, sig) ? 1u : 0u) << r;
      }
    }
    float mine = f0;
    while (todo != 0) {
      const int r = __ffs(todo) - 1;
      todo &= todo - 1;
      const size_t rw = rw0 + r;
      int run = 1;
      for (; run < W; ++run) {
        const int sig = p.psig[rw * W + run];
        if (sig == 0 || !holds(k, S, lane, sig)) break;
      }
      if (lane == r) {
        const float lenf = fmaxf(p.len_in[rw], 1.f);
        const float matched = fminf(__fmul_rn((float)run, 16.f), lenf);
        mine = __fsub_rn(1.f, __fmul_rn(p.w_aff, __fdiv_rn(matched, lenf)));
      }
    }
    if (lane < n) p.aff[(size_t)(rw0 + lane) * p.I + i] = mine;
  }
}

// Slice q's instances, one a warp: the TPOT and, with the affinity term
// (AFF), the factors for every row, the sketch's load in flight during
// the trees' walk.
template <bool AFF>
__device__ void instance_warps(const RtDecisionParams& p, int q,
                               int n_slices) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = q * nwarps + warp; i < p.I; i += n_slices * nwarps) {
    Sketch k{nullptr, 0, 0, false};
    if (AFF) k = load_sketch(p, i, lane);
    const float tp = tpot_of(p, i, lane);
    if (lane == 0) p.tpot[i] = tp;
    if (AFF) affinity_factors(p, i, lane, k);
  }
}

// Slice q of the per-instance preamble, of `n_slices` over the grid: the
// TPOT of one instance a warp and, with the affinity term, its factors
// for every row; with the global carry b0 and each window's initial carry
// rows, one instance a thread. Pad instances (dead) are computed too: the
// off modes read every column.
__device__ void instance_slice(const RtDecisionParams& p, int q,
                               int n_slices) {
  const int I = p.I, tid = threadIdx.x, nthr = blockDim.x;
  if (p.use_aff) instance_warps<true>(p, q, n_slices);
  else instance_warps<false>(p, q, n_slices);
  if (p.scan_i == nullptr) return;
  for (int i = q * nthr + tid; i < I; i += n_slices * nthr) {
    const float beff = fmaxf(p.b[i], 1.f), d = p.d[i], fr = p.free_[i];
    p.scan_i[i] = fmaxf(beff, 1.f);
    for (int w = 0; w < p.K; ++w) {
      const size_t o = (size_t)w * I + i;
      p.d1[o] = d;
      p.b1[o] = beff;
      p.f1[o] = fr;
    }
  }
}

// Window w's greedy loop on the carry GL: one warp for I <= 32, else the
// block; the affinity term's factor read compiled in only where it is on.
template <bool GL>
__device__ void run_scan(const RtDecisionParams& p, ScanSmem& s, int w) {
  if (p.I <= 32) {
    if (threadIdx.x >= 32) return;
    if (p.use_aff) run_scan_warp<GL, true>(p, s, w, threadIdx.x);
    else run_scan_warp<GL, false>(p, s, w, threadIdx.x);
  } else if (p.use_aff) {
    run_scan_block<GL, true>(p, s, w);
  } else {
    run_scan_block<GL, false>(p, s, w);
  }
}

// Window w's scan by this CTA, or (CL) by this CTA's share of its
// cluster: the rows, the LPT order, the greedy loop and the outputs. On
// the cluster carry the CTA holds columns [i0, i0 + n) and writes the
// rows whose pick it owns.
template <bool CL>
__device__ void scan_window(const RtDecisionParams& p, float* smem, int w) {
  const int R = p.R, M = p.M, I = p.I;
  const int tid = threadIdx.x;
  int me = 0, C = 1;                        // CL: rank and cluster size
  if constexpr (CL) {
    cg::cluster_group cl = cg::this_cluster();
    me = (int)cl.block_rank();
    C = (int)cl.num_blocks();
  }
  const int cols = (I + C - 1) / C, i0 = me * cols;
  const int n = max(0, min(I, i0 + cols) - i0);
  const bool stamp = p.timers != nullptr && tid == 0 && me == 0;
  if (stamp) p.timers[2 + 4 * w] = global_timer();
  ScanSmem s = carve(smem, p, w, cols);

  // per-row inputs; the mixes and keys other CTAs wrote (L2, not L1)
  for (int r = tid; r < R; r += blockDim.x) {
    const size_t rw = (size_t)w * R + r;
    s.bud[r] = p.budgets[rw];
    s.lin[r] = p.len_in[rw];
    s.rv[r] = p.row_valid[rw] ? 1 : 0;
    s.plm[r] = __ldcg(p.plm + rw);
  }
  for (int t = tid; t < R * M; t += blockDim.x) {
    s.qmix[t] = __ldcg(p.qmix + (size_t)w * R * M + t);
    s.lmix[t] = __ldcg(p.lmix + (size_t)w * R * M + t);
  }
  // the shared and cluster carries' per-instance arrays and the TPOT the
  // grid wrote (the global carry's are in place)
  const bool gl = p.scan_i != nullptr;
  if (!gl)
    for (int j = tid; j < n; j += blockDim.x) {
      const int i = i0 + j;
      const float beff = fmaxf(p.b[i], 1.f);
      s.d[j] = p.d[i];
      s.b[j] = beff;
      s.fr[j] = p.free_[i];
      s.b0[j] = fmaxf(beff, 1.f);
      s.tpot[j] = __ldcg(p.tpot + i);
    }
  __syncthreads();

  // LPT order: a stable descending rank of the key (pad rows at -1e30)
  for (int r = tid; r < R; r += blockDim.x) {
    int rank = r;
    if (p.lpt) {
      const float kr = s.plm[r];
      rank = 0;
      for (int j = 0; j < R; ++j) {
        const float kj = s.plm[j];
        rank += (kj > kr) || (kj == kr && j < r);
      }
    }
    s.order[rank] = r;
  }
  __syncthreads();

  if constexpr (CL) {
    if (p.use_aff) run_scan_cluster<true>(p, s, w, i0, n);
    else run_scan_cluster<false>(p, s, w, i0, n);
  } else if (gl) {
    run_scan<true>(p, s, w);
  } else {
    run_scan<false>(p, s, w);
  }
  __syncthreads();
  if (stamp) p.timers[3 + 4 * w] = global_timer();

  for (int r = tid; r < R; r += blockDim.x) {
    const size_t rw = (size_t)w * R + r;
    const int c = s.pick[r];
    if (CL && (c < i0 || c >= i0 + n)) continue;
    p.choice[rw] = c;
    p.est[rw] = s.est[r];
    p.lchosen[rw] = s.lmix[r * M + p.m_of_i[c]];
  }
}

// ---------------------------------------------------------------------------
// One of window w's tickets: one for each row tile of RT rows that holds
// rows of w, and one for the trees. The CTA that draws the last scans w,
// or (CL) sets bit w of `done` for its cluster to scan after stage 1.
template <int RT, bool CL>
__device__ void window_ticket(const RtDecisionParams& p, float* smem, int w,
                              int* s_last, unsigned* done) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tiles = ((w + 1) * p.R - 1) / RT - (w * p.R) / RT + 1;
    *s_last = atomicAdd(&p.wtickets[w], 1) == tiles;
  }
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if constexpr (CL) {
    if (threadIdx.x == 0) {
      *done |= 1u << w;
      p.wtickets[w] = 0;
    }
  } else {
    scan_window<false>(p, smem, w);
    if (threadIdx.x == 0) p.wtickets[w] = 0;
  }
}

// The cluster carry's scans, by every CTA of the cluster after stage 1:
// the windows that any of its CTAs completed (`done`, a bit a window),
// read through distributed shared memory, in window order.
__device__ void cluster_scans(const RtDecisionParams& p, float* smem,
                              unsigned* done) {
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();                                // every CTA's `done` is final
  unsigned todo = 0;
  for (int r = 0; r < (int)cl.num_blocks(); ++r)
    todo |= *cl.map_shared_rank(done, r);
  __threadfence();                          // what other clusters wrote
  while (todo != 0) {
    const int w = __ffs(todo) - 1;
    todo &= todo - 1;
    scan_window<true>(p, smem, w);
  }
  cl.sync();                                // the others have read this CTA
}

// ---------------------------------------------------------------------------
// The whole decision: the per-instance preamble in slices over the grid,
// stage 1 on the grid of (index splits x row tiles of RT rows), then each
// window's scan in the CTA that completes it, or (CL, the cluster carry)
// in that CTA's cluster. S splits: gridDim.x, or (CL) the first S of a
// grid padded to whole clusters.

template <int RT, int MR, int MC, int ES, bool CL>
__global__ void __launch_bounds__(THREADS)
decision_fused(const __grid_constant__ RtDecisionParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  __shared__ unsigned s_done;               // CL: the windows completed here
  if (CL && threadIdx.x == 0) s_done = 0;
  if (p.timers != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    p.timers[0] = global_timer();
  // the CTAs that hold a slice: 8 instances each, at most the grid, the
  // last split's first (slice q: split S - 1 - q / T of row tile q % T)
  const int nwarps = THREADS / 32;
  const int q = (gridDim.x - 1 - blockIdx.x) * gridDim.y + blockIdx.y;
  const int n_slices = min((int)(gridDim.x * gridDim.y),
                           max(1, (p.I + nwarps - 1) / nwarps));
  if (q < n_slices) {
    instance_slice(p, q, n_slices);
    __threadfence();
    __syncthreads();
    int* tt = p.wtickets + p.K;                 // the trees' ticket
    if (threadIdx.x == 0) s_last = atomicAdd(tt, 1) == n_slices - 1;
    __syncthreads();
    if (s_last) {
      __threadfence();
      if (threadIdx.x == 0) {
        *tt = 0;
        if (p.timers != nullptr) {
          const long long t = global_timer();
          for (int w = 0; w < p.K; ++w) p.timers[1 + 4 * w] = t;
        }
      }
      for (int w = 0; w < p.K; ++w)
        window_ticket<RT, CL>(p, smem, w, &s_last, &s_done);
      __syncthreads();                          // smem is stage 1's again
    }
  }
  const int KR = p.K * p.R;
  const int S = CL ? ((p.N + knn::CT - 1) / knn::CT + p.per_split - 1)
                         / p.per_split
                   : (int)gridDim.x;
  if ((!CL || (int)blockIdx.x < S) &&
      knn::fused_topk<knn::XSQ_FIRST, RT, MR, MC, ES>(
          p.emb, nullptr, p.x, p.xsq, KR, p.N, p.E, p.k, p.per_split, S,
          p.cand_d, p.cand_i, p.tickets, smem, MixRow{&p})) {
    // this CTA merged row tile blockIdx.y: its rows' mixes are in
    // scratch; one ticket for each window that holds some of them
    const int row0 = blockIdx.y * RT, row1 = min(KR, row0 + RT);
    for (int w = row0 / p.R; w <= (row1 - 1) / p.R; ++w)
      window_ticket<RT, CL>(p, smem, w, &s_last, &s_done);
  }
  if constexpr (CL) cluster_scans(p, smem, &s_done);
}

// Once per device and kernel of the cluster carry: let it take clusters
// past the portable 8 CTAs and any dynamic shared memory the device
// allows a block.
template <class Kern>
cudaError_t allow_clusters(Kern kern, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < knn::MAX_DEVICES && !raised[dev])
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  return knn::allow_optin_smem(kern, raised);
}

// The launch configuration: a grid of (S, row tiles), or (C > 1) of S
// padded to whole clusters of (C, 1, 1).
inline cudaLaunchConfig_t config(const RtDecisionParams& p, int RT, int S,
                                 int C, size_t smem, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((S + C - 1) / C * C, (p.K * p.R + RT - 1) / RT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  if (C > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

template <int RT, int MR, int MC, int ES>
int launch(const RtDecisionParams& p, int S, int C, size_t smem,
           cudaStream_t st) {
  if (C <= 1) {
    auto kern = decision_fused<RT, MR, MC, ES, false>;
    static bool raised[knn::MAX_DEVICES] = {};
    cudaError_t err = knn::allow_optin_smem(kern, raised);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(S, (p.K * p.R + RT - 1) / RT);
    kern<<<grid, THREADS, smem, st>>>(p);
    return (int)cudaGetLastError();
  }
  auto kern = decision_fused<RT, MR, MC, ES, true>;
  static bool raised[knn::MAX_DEVICES] = {};
  cudaError_t err = allow_clusters(kern, raised);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, RT, S, C, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of C CTAs of the cluster-carry kernel at row tile RT
// with `smem` bytes of dynamic shared memory the device holds at once (0:
// none can be resident, so such a launch would fail).
template <int RT, int MR, int MC, int ES>
int resident(int C, size_t smem) {
  auto kern = decision_fused<RT, MR, MC, ES, true>;
  static bool raised[knn::MAX_DEVICES] = {};
  cudaError_t err = allow_clusters(kern, raised);
  if (err != cudaSuccess) return -(int)err;
  RtDecisionParams p = {};
  p.K = 1;
  p.R = RT;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(p, RT, C, C, smem, nullptr, attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the kernel, in bytes: the larger of stage 1's
// at row tile RT and the scan's with `cols` per-instance columns in
// shared memory (I: shared carry; ceil(I / C): cluster carry; 0: global).
size_t rt_decision_smem(int RT, int E, int R, int M, int cols) {
  const size_t scan = sizeof(float) * scan_smem_words(R, M, cols);
  const size_t knn1 = knn::smem_bytes(RT, E);
  return scan > knn1 ? scan : knn1;
}

// Clusters of C CTAs resident at once for the cluster carry at row tile
// RT with `smem` bytes of dynamic shared memory; negative: -cudaError_t.
int rt_decision_resident_clusters(int RT, int C, size_t smem) {
  switch (RT) {
    case 1: return resident<1, 1, 1, knn::SMALL_ES>(C, smem);
    case 2: return resident<2, 2, 1, knn::SMALL_ES>(C, smem);
    case 4: return resident<4, 4, 1, knn::SMALL_ES>(C, smem);
    case 8: return resident<8, 8, 1, knn::SMALL_ES>(C, smem);
    case 16: return resident<16, 1, 4, 1>(C, smem);
    case 32: return resident<32, 2, 4, 1>(C, smem);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// One kernel on `stream`, row tiles of RT in {1, 2, 4, 8, 16, 32} rows
// and S splits of per_split 64-column tiles over the K*R rows; C = 1
// (the warp, shared and global carries: the global one where scan_i is
// set) or the cluster carry's C in {2, 4, 8, 16} CTAs (scan_i null, K <=
// 32); the scratch tickets zero before the first call and left zero by
// every call. Returns the cudaError_t (0 = success).
int rt_decision_megakernel(const RtDecisionParams* p, int RT, int S, int C,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ct = (p->N + knn::CT - 1) / knn::CT;
  if (p->K < 1 || p->R < 1 || p->E % 4 || p->k < 1 || p->k > knn::KMAX ||
      p->k > p->N || p->per_split < 1 ||
      S != (n_ct + p->per_split - 1) / p->per_split ||
      (C != 1 && (C < 2 || C > 16 || (C & (C - 1)) != 0 ||
                  p->scan_i != nullptr || p->K > 32)))
    return (int)cudaErrorInvalidValue;
  const int cols = p->scan_i != nullptr ? 0 : (p->I + C - 1) / C;
  const size_t smem = rt_decision_smem(RT, p->E, p->R, p->M, cols);
  switch (RT) {
    case 1: return launch<1, 1, 1, knn::SMALL_ES>(*p, S, C, smem, st);
    case 2: return launch<2, 2, 1, knn::SMALL_ES>(*p, S, C, smem, st);
    case 4: return launch<4, 4, 1, knn::SMALL_ES>(*p, S, C, smem, st);
    case 8: return launch<8, 8, 1, knn::SMALL_ES>(*p, S, C, smem, st);
    case 16: return launch<16, 1, 4, 1>(*p, S, C, smem, st);
    case 32: return launch<32, 2, 4, 1>(*p, S, C, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
