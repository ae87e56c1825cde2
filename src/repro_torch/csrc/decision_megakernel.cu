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
// tree after another, that is some 180 dependent loads.
//
// What the design does about it. One __global__ function per call,
// `decision_fused`:
//   1. Stage 1 is the lookup's one-launch body (knn_common.cuh,
//      `fused_topk`, shared with knn_topk.cu): (index splits x row tiles)
//      over the K*R rows, the layout taken from the lookup's measured
//      table for K*R rows (kernels/knn_topk.py), the split lists merged
//      by the CTA that draws a row tile's last ticket. That CTA also does
//      each row's state-free work right after the merge: the
//      inverse-distance weights, the label mixes and the LPT key, to
//      scratch; no k list is kept.
//   2. Each window has a second ticket, drawn once by every row tile
//      that holds rows of it. The CTA that draws a window's last ticket
//      runs that window's scan: the TPOT heads, one warp per instance
//      and one lane per tree, the leaf values then added in tree order
//      by shuffles; the LPT order; and the greedy loop. With I <= 32
//      (the main path) one warp runs the loop, lane i holding instance
//      i's constants and its (d, b, free) carry in registers, so a step
//      is three warp reductions; above, the block runs it, thread t
//      owning the columns i = t (mod blockDim.x). Eq. 2 admission, the
//      affinity hit and Eq. 1 are evaluated for one row over I on the
//      fly: no (R, I) plane is ever written.
// The block's per-instance arrays (the carry d/b/free, b0, the TPOT, and
// a step's cost and latency: 28 B an instance) have two homes. The
// shared carry keeps them in shared memory, up to I = 4096 (MAX_SHARED_I
// in the wrapper) where they fit beside the R-length arrays. Past that,
// or where they do not fit, the global carry keeps d/b/free in the
// window's rows of the outputs d1/b1/f1 (no copy at the end) and the
// other four in a (K, 4, I) scratch, L2-resident (458 KB at I = 16,384).
// Only the owner of a column reads or writes it, so the two carries run
// the same operations in the same order: the global one is bitwise the
// shared one.
// The dynamic shared memory is the larger of stage 1's need and the
// scan's, and every CTA gets it. At the main path's I = 16 that is stage
// 1's (43 KB at the 4-row tile), and registers (128 a thread, for the
// scan) hold the kernel to two CTAs an SM; at I = 4096 the shared carry
// makes it about 115 KB, one CTA an SM, so stage 1 runs in about twice
// the waves there; with the global carry it is stage 1's again. The
// boundary is measured, not the opt-in limit: the global carry's reads
// from L2 cost the scan more than stage 1's second CTA an SM gains at
// I = 4096 for R >= 16, and less at I = 8192 (chip_smoke.py times both).
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

#include <climits>

#include "knn_common.cuh"

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
  int* wtickets;             // (K,) scratch, left 0
  float* qmix;               // (K*R, M) scratch: label mixes
  float* lmix;
  float* plm;                // (K*R,) scratch: LPT key
  float* scan_i;             // (K, 4, I) scratch of the global carry, or
                             // null: the shared-memory carry
  int* choice;               // (K, R)
  float* est;                // (K, R)
  float* lchosen;            // (K, R)
  float* d1;                 // (K, I)
  float* b1;
  float* f1;
  int K, R, E, N, M, I, k, per_split;
  int sig_w, sig_slots;
  int n_trees, n_internal, n_leaves, depth;
  int mode, lpt, budget_filter, use_gbm, use_aff;
  float eps, wq, wl, wc, w_aff, lr;
};

namespace {

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

// Shared-memory words of the scan: with the shared carry the seven
// I-length arrays too, with the global carry the R-length ones and the
// reduction words only.
__host__ __device__ inline size_t scan_smem_words(int R, int M, int I,
                                                  bool shared_carry) {
  return (size_t)2 * R * M + (size_t)7 * R
         + (shared_carry ? (size_t)7 * I : 0) + 96;
}

// The scan's arrays for window w: the R-length ones and the reduction
// words from shared memory; the I-length ones from shared memory too
// (shared carry), or (global carry) the carry d/b/free in the window's
// rows of the outputs d1/b1/f1 and the other four in its scratch rows.
__device__ ScanSmem carve(float* base, const RtDecisionParams& prm, int w) {
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
    s.d = p; p += I;
    s.b = p; p += I;
    s.fr = p; p += I;
    s.b0 = p; p += I;
    s.tpot = p; p += I;
    s.tc = p; p += I;
    s.tt = p; p += I;
  } else {
    const size_t o = (size_t)w * I;
    s.d = prm.d1 + o;
    s.b = prm.b1 + o;
    s.fr = prm.f1 + o;
    float* g = prm.scan_i + 4 * o;
    s.b0 = g;
    s.tpot = g + I;
    s.tc = g + 2 * (size_t)I;
    s.tt = g + 3 * (size_t)I;
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

// matched-prefix fraction of request row `rw` against instance i
__device__ float hit_fraction(const RtDecisionParams& p, size_t rw, int i,
                              float lin) {
  const int* rs = p.psig + rw * p.sig_w;
  const int* pl = p.sig_plane + (size_t)i * p.sig_slots;
  int run = 0;
  for (int c = 0; c < p.sig_w; ++c) {
    int sig = rs[c];
    bool present = false;
    if (sig != 0)
      for (int j = 0; j < p.sig_slots; ++j) present |= (pl[j] == sig);
    if (!present) break;
    ++run;
  }
  float lenf = fmaxf(lin, 1.f);
  float matched = fminf(__fmul_rn((float)run, 16.f), lenf);
  return __fdiv_rn(matched, lenf);
}

__device__ __forceinline__ float quantize(float v) {
  return __fmul_rn(rintf(__fmul_rn(v, INV_QUANTUM)), QUANTUM);
}

// Instance i's constants, as the scan reads them
struct Inst {
  float pin, pout, nom, tp, b0;
  bool al;
};

// Row rw's cost c and latency T on instance i (carry d, b, free), as the
// plain version forms them.
__device__ __forceinline__ void cost_latency(
    const RtDecisionParams& p, size_t rw, int i, const Inst& in, float lin,
    float l, float d, float b, float fr, float& c, float& T) {
  c = __fmul_rn(__fadd_rn(__fmul_rn(lin, in.pin), __fmul_rn(l, in.pout)),
                1e-6f);
  const float wait = (fr > 0.f) ? 0.f : __fdiv_rn(d, fmaxf(b, 1.f));
  const float tpe = __fmul_rn(in.tp, fmaxf(__fdiv_rn(b, in.b0), 1.f));
  T = (p.mode == STATIC_PRIOR) ? __fmul_rn(in.nom, l)
                               : __fmul_rn(tpe, __fadd_rn(wait, l));
  if (p.use_aff) {
    const float hit = in.al ? hit_fraction(p, rw, i, lin) : 0.f;
    T = __fmul_rn(T, __fsub_rn(1.f, __fmul_rn(p.w_aff, hit)));
  }
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
__device__ void run_scan_warp(const RtDecisionParams& p, ScanSmem& s, int w,
                              int lane) {
  const int I = p.I, M = p.M;
  const bool off = p.mode == OFF_REACTIVE || p.mode == OFF_PREDICTIVE;
  const float wl = off ? 0.f : p.wl;
  const bool mine = lane < I;
  const int i = lane;
  int m_i = 0;
  Inst in{0.f, 0.f, 0.f, 0.f, 1.f, false};
  float d = 0.f, b = 1.f, fr = 0.f, maxb = 0.f;
  if (mine) {
    m_i = p.m_of_i[i];
    in = Inst{p.price_in[i], p.price_out[i], p.nominal[i], s.tpot[i],
              s.b0[i], p.alive[i] != 0};
    d = s.d[i]; b = s.b[i]; fr = s.fr[i];
    maxb = p.maxb[i];
  }
  const bool al = in.al;
  for (int t = 0; t < p.R; ++t) {
    const int rr = s.order[t];
    const float lin = s.lin[rr];
    const float bud = s.bud[rr];
    const bool has_budget = !isnan(bud);
    const size_t rw = (size_t)w * p.R + rr;

    float c = 0.f, T = 0.f, l = 0.f, q = 0.f;
    bool ok = false;
    float cs_v = INFINITY;          // lanes past I stay (inf, INT_MAX)
    int cs_i = INT_MAX;
    if (mine) {
      l = s.lmix[rr * M + m_i];
      q = s.qmix[rr * M + m_i];
      cost_latency(p, rw, i, in, lin, l, d, b, fr, c, T);
      ok = al && (!has_budget || c <= bud);
      cs_v = al ? c : INFINITY;
      cs_i = i;
    }
    bool allowed = al;
    if (p.budget_filter) {
      const bool any_c = __any_sync(FULL, ok);
      warp_argmin(cs_v, cs_i);
      allowed = mine && (any_c ? ok : (i == cs_i));
    }
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
}

// The R-step greedy loop for I > 32, by the whole block: thread `tid`
// owns the instances i = tid (mod blockDim.x). Every I-length array is
// read and written by the owner of the column only (tpot was written
// before a barrier), so the carry may sit in shared memory or in global
// memory (the outputs themselves) with the same operations in the same
// order.
__device__ void run_scan_block(const RtDecisionParams& p, ScanSmem& s, int w) {
  const int I = p.I, M = p.M, tid = threadIdx.x, nthr = blockDim.x;
  const bool off = p.mode == OFF_REACTIVE || p.mode == OFF_PREDICTIVE;
  const float wl = off ? 0.f : p.wl;
  for (int t = 0; t < p.R; ++t) {
    const int rr = s.order[t];
    const float lin = s.lin[rr];
    const float bud = s.bud[rr];
    const bool has_budget = !isnan(bud);
    const size_t rw = (size_t)w * p.R + rr;

    // pass A: cost and latency per instance; admission reductions
    bool any_c = false;
    float cs_v = INFINITY;
    int cs_i = INT_MAX;
    for (int i = tid; i < I; i += nthr) {
      const float l = s.lmix[rr * M + p.m_of_i[i]];
      const bool al = p.alive[i] != 0;
      const Inst in{p.price_in[i], p.price_out[i], p.nominal[i], s.tpot[i],
                    s.b0[i], al};
      float c, T;
      cost_latency(p, rw, i, in, lin, l, s.d[i], s.b[i], s.fr[i], c, T);
      s.tc[i] = c;
      s.tt[i] = T;
      any_c = any_c || (al && (!has_budget || c <= bud));
      const float csel = al ? c : INFINITY;
      if (lex_less(csel, i, cs_v, cs_i)) { cs_v = csel; cs_i = i; }
    }
    if (p.budget_filter) red_any_argmin(any_c, cs_v, cs_i, s);

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
        const float tie = (p.mode == OFF_REACTIVE) ? __fadd_rn(s.d[i], s.b[i])
                                                   : T;
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
        const float tie = (p.mode == OFF_REACTIVE) ? __fadd_rn(s.d[i], s.b[i])
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
      s.d[win] = __fadd_rn(s.d[win], v ? l : 0.f);
      const bool has_free = (s.fr[win] > 0.f) && v;
      s.fr[win] = __fadd_rn(s.fr[win], has_free ? -1.f : -0.f);
      if (has_free) s.b[win] = fminf(__fadd_rn(s.b[win], 1.f), p.maxb[win]);
    }
    __syncthreads();
  }
  if (p.scan_i != nullptr) return;          // the carry is the output
  for (int i = tid; i < I; i += nthr) {
    const size_t o = (size_t)w * I + i;
    p.d1[o] = s.d[i];
    p.b1[o] = s.b[i];
    p.f1[o] = s.fr[i];
  }
}

__device__ void scan_window(const RtDecisionParams& p, float* smem, int w) {
  const int R = p.R, M = p.M, I = p.I;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  ScanSmem s = carve(smem, p, w);

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
  // per-instance carry
  for (int i = tid; i < I; i += blockDim.x) {
    const float beff = fmaxf(p.b[i], 1.f);
    s.d[i] = p.d[i];
    s.b[i] = beff;
    s.fr[i] = p.free_[i];
    s.b0[i] = fmaxf(beff, 1.f);
  }
  // the state-dependent TPOT (window-invariant): a warp per instance, a
  // lane per tree, the leaf values summed in tree order
  const int leaf0 = (1 << p.depth) - 1;
  for (int i = warp; i < I; i += nwarps) {
    float tp = p.nominal[i];
    if (p.use_gbm) {
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
      tp = fmaxf(out, 1e-4f);
    }
    if (lane == 0) s.tpot[i] = tp;
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

  if (I <= 32) {
    if (warp == 0) run_scan_warp(p, s, w, lane);
  } else {
    run_scan_block(p, s, w);
  }
  __syncthreads();

  for (int r = tid; r < R; r += blockDim.x) {
    const size_t rw = (size_t)w * R + r;
    const int c = s.pick[r];
    p.choice[rw] = c;
    p.est[rw] = s.est[r];
    p.lchosen[rw] = s.lmix[r * M + p.m_of_i[c]];
  }
}

// ---------------------------------------------------------------------------
// The whole decision: stage 1 on a grid of (index splits x row tiles of
// RT rows), then each window's scan in the CTA that completes it.

template <int RT, int MR, int MC, int ES>
__global__ void __launch_bounds__(THREADS)
decision_fused(const __grid_constant__ RtDecisionParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int KR = p.K * p.R;
  if (!knn::fused_topk<knn::XSQ_FIRST, RT, MR, MC, ES>(
          p.emb, nullptr, p.x, p.xsq, KR, p.N, p.E, p.k, p.per_split,
          p.cand_d, p.cand_i, p.tickets, smem, MixRow{&p}))
    return;
  // this CTA merged row tile blockIdx.y: its rows' mixes are in scratch;
  // one ticket for each window that holds some of them
  const int row0 = blockIdx.y * RT, row1 = min(KR, row0 + RT);
  for (int w = row0 / p.R; w <= (row1 - 1) / p.R; ++w) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int tiles = ((w + 1) * p.R - 1) / RT - (w * p.R) / RT + 1;
      s_last = atomicAdd(&p.wtickets[w], 1) == tiles - 1;
    }
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    scan_window(p, smem, w);
    if (threadIdx.x == 0) p.wtickets[w] = 0;
  }
}

template <int RT, int MR, int MC, int ES>
int launch(const RtDecisionParams& p, int S, size_t smem, cudaStream_t st) {
  auto kern = decision_fused<RT, MR, MC, ES>;
  static bool raised[knn::MAX_DEVICES] = {};
  cudaError_t err = knn::allow_optin_smem(kern, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, (p.K * p.R + RT - 1) / RT);
  kern<<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the kernel, in bytes: the larger of stage 1's
// at row tile RT and the scan's, with the shared carry (shared_carry != 0)
// or the global one.
size_t rt_decision_smem(int RT, int E, int R, int M, int I,
                        int shared_carry) {
  const size_t scan = sizeof(float) * scan_smem_words(R, M, I,
                                                      shared_carry != 0);
  const size_t knn1 = knn::smem_bytes(RT, E);
  return scan > knn1 ? scan : knn1;
}

// One kernel on `stream`, row tiles of RT in {1, 2, 4, 8, 16, 32} rows
// and S splits of per_split 64-column tiles over the K*R rows; the
// scratch tickets zero before the first call and left zero by every
// call. Returns the cudaError_t (0 = success).
int rt_decision_megakernel(const RtDecisionParams* p, int RT, int S,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ct = (p->N + knn::CT - 1) / knn::CT;
  if (p->K < 1 || p->R < 1 || p->E % 4 || p->k < 1 || p->k > knn::KMAX ||
      p->k > p->N || p->per_split < 1 ||
      S != (n_ct + p->per_split - 1) / p->per_split)
    return (int)cudaErrorInvalidValue;
  const size_t smem = rt_decision_smem(RT, p->E, p->R, p->M, p->I,
                                       p->scan_i == nullptr);
  switch (RT) {
    case 1: return launch<1, 1, 1, knn::SMALL_ES>(*p, S, smem, st);
    case 2: return launch<2, 2, 1, knn::SMALL_ES>(*p, S, smem, st);
    case 4: return launch<4, 4, 1, knn::SMALL_ES>(*p, S, smem, st);
    case 8: return launch<8, 8, 1, knn::SMALL_ES>(*p, S, smem, st);
    case 16: return launch<16, 1, 4, 1>(*p, S, smem, st);
    case 32: return launch<32, 2, 4, 1>(*p, S, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
