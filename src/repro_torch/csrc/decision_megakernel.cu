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
// Stage 4 is R dependent steps, each a handful of reductions over I: a
// chain of latencies, not a throughput.
//
// What the design does about it. The TPU kernel is one program for the
// whole batch; on this card one CTA would leave 131 of 132 SMs idle in
// stage 1. So the work is two __global__ functions, launched back to
// back on the caller's stream:
//   1. knn_partial_topk: a grid of (8-row tiles x S splits of the
//      index). Each CTA streams its slice of x through shared memory in
//      32-row tiles, one warp per query row; each lane keeps a sorted
//      top-k of its columns, and the warp merges its 32 lists into the
//      split's k best, ordered by (distance, index), written to scratch
//      (knn_common.cuh, shared with knn_topk.cu).
//   2. decision_scan: one CTA per window. It merges the S*k candidates
//      of each row (one warp per row, one lane per split), forms the
//      inverse-distance label mixes, evaluates each instance's GBM
//      trees, ranks the rows for LPT, and runs the greedy loop with the
//      (d, b, free) carry in shared memory. Eq. 2 admission, the
//      affinity hit and Eq. 1 are evaluated for one row over I on the
//      fly with block reductions: no (R, I) plane is ever written. When
//      I <= 32 the loop runs in one warp with shuffles only.
//
// Exactness. Everything after the distance dot product spells the
// plain PyTorch version's operations one by one, with IEEE rounding:
// the file is built with --fmad=false and uses __fadd_rn/__fmul_rn/
// __fdiv_rn/__fsqrt_rn, never fast math; quantization rounds half to
// even (rintf); every argmax/argmin takes the lowest index on ties.
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
  float* cand_d;             // (K*R, S, k) scratch
  int* cand_i;
  int* choice;               // (K, R)
  float* est;                // (K, R)
  float* lchosen;            // (K, R)
  float* d1;                 // (K, I)
  float* b1;
  float* f1;
  int K, R, E, N, M, I, k, S;
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
// Stage 1: partial top-k per (row, split of the index).

__global__ void __launch_bounds__(THREADS)
knn_partial_topk(const float* __restrict__ q, const float* __restrict__ x,
                 const float* __restrict__ xsq, int KR, int N, int E,
                 int k, int S, float* __restrict__ cand_d,
                 int* __restrict__ cand_i) {
  knn::split_topk<knn::XSQ_FIRST>(q, nullptr, x, xsq, KR, N, E, k, S,
                                  cand_d, cand_i);
}

// ---------------------------------------------------------------------------
// Stages 1b-4: one CTA per window.

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

__host__ __device__ inline size_t scan_smem_words(int R, int M, int I) {
  return (size_t)2 * R * M + (size_t)7 * R + (size_t)7 * I + 96;
}

__device__ ScanSmem carve(float* base, int R, int M, int I) {
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
  s.d = p; p += I;
  s.b = p; p += I;
  s.fr = p; p += I;
  s.b0 = p; p += I;
  s.tpot = p; p += I;
  s.tc = p; p += I;
  s.tt = p; p += I;
  s.redf = p; p += 64;
  s.redi = reinterpret_cast<int*>(p);
  return s;
}

// Block-wide (or, with BLOCK=false, warp-wide) reductions. Every thread
// of the participating group ends with the result.
template <bool BLOCK>
__device__ void red_argmin(float& v, int& i, ScanSmem& s) {
  warp_argmin(v, i);
  if (BLOCK) {
    const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) { s.redf[w] = v; s.redi[w] = i; }
    __syncthreads();
    v = s.redf[0]; i = s.redi[0];
    for (int j = 1; j < nw; ++j)
      if (lex_less(s.redf[j], s.redi[j], v, i)) { v = s.redf[j]; i = s.redi[j]; }
    __syncthreads();
  }
}

template <bool BLOCK>
__device__ void red_argmax(float& v, int& i, ScanSmem& s) {
  for (int off = 16; off; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (lex_greater(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (BLOCK) {
    const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) { s.redf[w] = v; s.redi[w] = i; }
    __syncthreads();
    v = s.redf[0]; i = s.redi[0];
    for (int j = 1; j < nw; ++j)
      if (lex_greater(s.redf[j], s.redi[j], v, i)) { v = s.redf[j]; i = s.redi[j]; }
    __syncthreads();
  }
}

template <bool BLOCK>
__device__ void red_max2(float& a, float& b, ScanSmem& s) {
  for (int off = 16; off; off >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(FULL, a, off));
    b = fmaxf(b, __shfl_xor_sync(FULL, b, off));
  }
  if (BLOCK) {
    const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) { s.redf[w] = a; s.redf[32 + w] = b; }
    __syncthreads();
    a = s.redf[0]; b = s.redf[32];
    for (int j = 1; j < nw; ++j) {
      a = fmaxf(a, s.redf[j]); b = fmaxf(b, s.redf[32 + j]);
    }
    __syncthreads();
  }
}

template <bool BLOCK>
__device__ void red_any_argmin(bool& any, float& v, int& i, ScanSmem& s) {
  any = __any_sync(FULL, any);
  warp_argmin(v, i);
  if (BLOCK) {
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
}

__device__ __forceinline__ void sync_group(bool block) {
  if (block) __syncthreads(); else __syncwarp();
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

// One window's R-step greedy loop. Thread `tid` of `nthr` owns the
// instances i = tid (mod nthr).
template <bool BLOCK>
__device__ void run_scan(const RtDecisionParams& p, ScanSmem& s, int w,
                         int tid, int nthr) {
  const int I = p.I, M = p.M;
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
      const float c = __fmul_rn(
          __fadd_rn(__fmul_rn(lin, p.price_in[i]),
                    __fmul_rn(l, p.price_out[i])), 1e-6f);
      const float bi = s.b[i];
      const float wait = (s.fr[i] > 0.f) ? 0.f
                                         : __fdiv_rn(s.d[i], fmaxf(bi, 1.f));
      const float tpe = __fmul_rn(s.tpot[i],
                                  fmaxf(__fdiv_rn(bi, s.b0[i]), 1.f));
      float T = (p.mode == STATIC_PRIOR) ? __fmul_rn(p.nominal[i], l)
                                         : __fmul_rn(tpe, __fadd_rn(wait, l));
      const bool al = p.alive[i] != 0;
      if (p.use_aff) {
        const float hit = al ? hit_fraction(p, rw, i, lin) : 0.f;
        T = __fmul_rn(T, __fsub_rn(1.f, __fmul_rn(p.w_aff, hit)));
      }
      s.tc[i] = c;
      s.tt[i] = T;
      any_c = any_c || (al && (!has_budget || c <= bud));
      const float csel = al ? c : INFINITY;
      if (lex_less(csel, i, cs_v, cs_i)) { cs_v = csel; cs_i = i; }
    }
    if (p.budget_filter) red_any_argmin<BLOCK>(any_c, cs_v, cs_i, s);

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
    red_max2<BLOCK>(cmax, tmax, s);
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
      float sc = __fadd_rn(
          __fadd_rn(__fmul_rn(p.wq, q),
                    __fmul_rn(p.wc, __fsub_rn(1.f, __fdiv_rn(c, cmax)))),
          __fmul_rn(wl, __fsub_rn(1.f, __fdiv_rn(T, tmax))));
      sc = allowed ? quantize(sc) : -INFINITY;
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
      red_max2<BLOCK>(best_v, tie_max, s);
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
      red_argmin<BLOCK>(v, vi, s);
      win = vi;
    } else {
      red_argmax<BLOCK>(best_v, best_i, s);
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
    sync_group(BLOCK);
  }
}

__global__ void __launch_bounds__(THREADS)
decision_scan(RtDecisionParams p) {
  extern __shared__ float smemf[];
  const int w = blockIdx.x;
  const int R = p.R, M = p.M, I = p.I, k = p.k, S = p.S;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  ScanSmem s = carve(smemf, R, M, I);

  // per-row inputs
  for (int r = tid; r < R; r += blockDim.x) {
    const size_t rw = (size_t)w * R + r;
    s.bud[r] = p.budgets[rw];
    s.lin[r] = p.len_in[rw];
    s.rv[r] = p.row_valid[rw] ? 1 : 0;
  }
  // per-instance carry and the state-dependent TPOT (window-invariant)
  const int leaf0 = (1 << p.depth) - 1;
  for (int i = tid; i < I; i += blockDim.x) {
    const float di = p.d[i];
    const float beff = fmaxf(p.b[i], 1.f);
    const float cx = fmaxf(p.ctx[i], 64.f);
    s.d[i] = di;
    s.b[i] = beff;
    s.fr[i] = p.free_[i];
    s.b0[i] = fmaxf(beff, 1.f);
    float tp = p.nominal[i];
    if (p.use_gbm) {
      const float feats[4] = {beff, di, cx, __fmul_rn(beff, cx)};
      const int tier = p.tier_of_i[i];
      float out = __fadd_rn(0.f, p.gbase[tier]);
      for (int t = 0; t < p.n_trees; ++t) {
        const size_t tr = (size_t)tier * p.n_trees + t;
        const int* f = p.gfeat + tr * p.n_internal;
        const float* th = p.gthr + tr * p.n_internal;
        int node = 0;
        for (int lv = 0; lv < p.depth; ++lv)
          node = 2 * node + 1 + (feats[f[node]] > th[node] ? 1 : 0);
        const float v = p.gleaf[tr * p.n_leaves + (node - leaf0)];
        out = __fadd_rn(out, __fmul_rn(p.lr, v));
      }
      tp = fmaxf(out, 1e-4f);
    }
    s.tpot[i] = tp;
  }
  __syncthreads();

  // stage 1b: merge the S split lists of each row (lane s owns list s),
  // then the inverse-distance weights and label mixes, summed neighbour
  // by neighbour
  for (int r = warp; r < R; r += nwarps) {
    const size_t row = (size_t)w * R + r;
    float my_d;
    int my_i;
    knn::merge_splits(p.cand_d + row * S * k, p.cand_i + row * S * k, S, k,
                      lane, my_d, my_i);
    float wgt = (lane < k)
        ? __fdiv_rn(1.f, __fadd_rn(__fsqrt_rn(fmaxf(my_d, 0.f)), p.eps))
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
          aq = __fadd_rn(aq, __fmul_rn(p.qual[o], wj));
          al = __fadd_rn(al, __fmul_rn(p.leng[o], wj));
        }
      }
      if (m < M) {
        s.qmix[r * M + m] = aq;
        s.lmix[r * M + m] = al;
        lmax = fmaxf(lmax, al);
      }
    }
    for (int off = 16; off; off >>= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, off));
    if (lane == 0) s.plm[r] = s.rv[r] ? lmax : -1e30f;
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
    if (warp == 0) run_scan<false>(p, s, w, lane, 32);
  } else {
    run_scan<true>(p, s, w, tid, blockDim.x);
  }
  __syncthreads();

  for (int r = tid; r < R; r += blockDim.x) {
    const size_t rw = (size_t)w * R + r;
    const int c = s.pick[r];
    p.choice[rw] = c;
    p.est[rw] = s.est[r];
    p.lchosen[rw] = s.lmix[r * M + p.m_of_i[c]];
  }
  for (int i = tid; i < I; i += blockDim.x) {
    const size_t o = (size_t)w * I + i;
    p.d1[o] = s.d[i];
    p.b1[o] = s.b[i];
    p.f1[o] = s.fr[i];
  }
}

constexpr size_t SMEM_DEFAULT = 48 * 1024;

}  // namespace

extern "C" {

// Dynamic shared memory of decision_scan, in bytes.
size_t rt_decision_scan_smem(int R, int M, int I) {
  return sizeof(float) * scan_smem_words(R, M, I);
}

size_t rt_knn_smem(int E) { return knn::smem_bytes(E); }

// Both kernels on `stream`; returns the first cudaError_t (0 = success).
int rt_decision_megakernel(const RtDecisionParams* p, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int KR = p->K * p->R;
  const size_t sm1 = knn::smem_bytes(p->E);
  cudaError_t err;
  if (sm1 > SMEM_DEFAULT) {
    err = cudaFuncSetAttribute(knn_partial_topk,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm1);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 g1((KR + knn::ROWS - 1) / knn::ROWS, p->S);
  knn_partial_topk<<<g1, THREADS, sm1, st>>>(p->emb, p->x, p->xsq, KR, p->N,
                                              p->E, p->k, p->S, p->cand_d,
                                              p->cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t sm2 = rt_decision_scan_smem(p->R, p->M, p->I);
  if (sm2 > SMEM_DEFAULT) {
    err = cudaFuncSetAttribute(decision_scan,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm2);
    if (err != cudaSuccess) return (int)err;
  }
  decision_scan<<<p->K, THREADS, sm2, st>>>(*p);
  return (int)cudaGetLastError();
}

}  // extern "C"
