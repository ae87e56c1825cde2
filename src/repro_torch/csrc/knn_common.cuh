// KNN top-k device code of the decision kernel's stage 1
// (decision_megakernel.cu, K1). The standalone lookup (knn_topk.cu, K2)
// has its own one-launch body and takes only the (distance, index)
// order from here; the QSQ_FIRST form below was K2's before that and
// stays until K1's own redesign, so that K1's code is unchanged.
//
// Stage 1 streams the index (N, E) float32 in S slices ("splits"), one CTA
// per (8 query rows x split), one warp per query row. Each CTA stages its
// rows and 32-row index tiles in shared memory; lane j of a warp owns
// the tile's column j, forms the squared distance and keeps a sorted
// top-k of its own columns in registers. The warp then merges its 32
// lists into the split's k best, written as (rows, S, k) candidates. A
// second pass merges the S lists of a row the same way (one lane per
// split). Every list is ordered by (distance, index), so ties go to the
// lower index, as `lax.top_k` and a stable sort order them.
//
// The two kernels spell the distance differently, because their TPU
// kernels did: K1 (and the plain `topk_soft_lookup`) form
// (xsq - 2 q.x) + qsq, with qsq summed here from the staged row; K2 forms
// (qsq + xsq) - 2 q.x, with qsq given. The dot product is a chain of
// fmaf over e in order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <climits>

namespace knn {

constexpr int KMAX = 32;      // largest k (one lane per neighbour)
constexpr int ROWS = 8;       // query rows per CTA (one warp each)
constexpr int TILE = 32;      // index rows per shared-memory tile
constexpr int THREADS = 256;  // ROWS warps
constexpr unsigned FULL = 0xffffffffu;

enum Form { XSQ_FIRST = 0, QSQ_FIRST = 1 };

__device__ __forceinline__ bool lex_less(float av, int ai, float bv,
                                         int bi) {
  return av < bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (lex_less(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Dynamic shared memory of `split_topk`, in bytes.
inline size_t smem_bytes(int E) {
  const int E4 = E / 4;
  return sizeof(float4) * ((size_t)ROWS * E4 + (size_t)TILE * (E4 + 1));
}

// The split's k best columns of each of the CTA's rows, launched on a
// grid of (ceil(B / ROWS), S) blocks of THREADS threads. Rows are q's
// (B, E); `qsq_in` (B,) is read only by the QSQ_FIRST form. A split
// with fewer than k columns pads its list with (inf, INT_MAX).
template <int FORM>
__device__ __forceinline__ void split_topk(
    const float* __restrict__ q, const float* __restrict__ qsq_in,
    const float* __restrict__ x, const float* __restrict__ xsq, int B,
    int N, int E, int k, int S, float* __restrict__ cand_d,
    int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];
  const int E4 = E >> 2;
  float4* qs = smem4;                          // ROWS x E4
  float4* xs = smem4 + ROWS * E4;              // TILE x (E4 + 1)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nthr = blockDim.x;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + warp;
  const int split = blockIdx.y;
  const int chunk = (N + S - 1) / S;
  const int j0 = split * chunk;
  const int j1 = min(N, j0 + chunk);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  const float4* q4 = reinterpret_cast<const float4*>(q);
  for (int t = tid; t < ROWS * E4; t += nthr) {
    int r = t / E4;
    qs[t] = (row0 + r < B) ? q4[(size_t)(row0 + r) * E4 + (t % E4)]
                           : zero4;
  }
  __syncthreads();

  float qsq = 0.f;
  if (FORM == QSQ_FIRST) {
    if (row < B) qsq = qsq_in[row];
  } else {
    // |q|^2 for this warp's row: lane partial sums, then a shuffle tree
    for (int e4 = lane; e4 < E4; e4 += 32) {
      float4 a = qs[warp * E4 + e4];
      qsq = fmaf(a.x, a.x, qsq); qsq = fmaf(a.y, a.y, qsq);
      qsq = fmaf(a.z, a.z, qsq); qsq = fmaf(a.w, a.w, qsq);
    }
    for (int off = 16; off; off >>= 1)
      qsq += __shfl_xor_sync(FULL, qsq, off);
  }

  float kd[KMAX];
  int ki[KMAX];
  int cnt = 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (int t0 = j0; t0 < j1; t0 += TILE) {
    for (int t = tid; t < TILE * E4; t += nthr) {
      int c = t / E4, e4 = t % E4, j = t0 + c;
      xs[c * (E4 + 1) + e4] = (j < j1) ? x4[(size_t)j * E4 + e4] : zero4;
    }
    __syncthreads();
    const int j = t0 + lane;
    if (row < B && j < j1) {
      float dot = 0.f;
      const float4* xr = xs + lane * (E4 + 1);
      const float4* qr = qs + warp * E4;
      for (int e4 = 0; e4 < E4; ++e4) {
        float4 a = xr[e4], c = qr[e4];
        dot = fmaf(c.x, a.x, dot); dot = fmaf(c.y, a.y, dot);
        dot = fmaf(c.z, a.z, dot); dot = fmaf(c.w, a.w, dot);
      }
      const float d2 = (FORM == QSQ_FIRST)
          ? __fsub_rn(__fadd_rn(qsq, xsq[j]), __fmul_rn(2.f, dot))
          : __fadd_rn(__fsub_rn(xsq[j], __fmul_rn(2.f, dot)), qsq);
      // sorted insert by (distance, index); this lane's columns arrive in
      // ascending index, so an equal distance goes after its ties
      if (cnt < k || d2 < kd[cnt - 1]) {
        int p = (cnt < k) ? cnt : k - 1;
        while (p > 0 && kd[p - 1] > d2) {
          kd[p] = kd[p - 1]; ki[p] = ki[p - 1]; --p;
        }
        kd[p] = d2; ki[p] = j;
        if (cnt < k) ++cnt;
      }
    }
    __syncthreads();
  }
  if (row >= B) return;

  // merge the warp's 32 sorted lists into the split's k best
  int head = 0;
  for (int rnd = 0; rnd < k; ++rnd) {
    float hv = head < cnt ? kd[head] : INFINITY;
    int hi = head < cnt ? ki[head] : INT_MAX;
    float bv = hv;
    int bi = hi;
    warp_argmin(bv, bi);
    if (head < cnt && hi == bi) ++head;        // column indices are unique
    if (lane == 0) {
      size_t o = ((size_t)row * S + split) * k + rnd;
      cand_d[o] = bv;
      cand_i[o] = bi;
    }
  }
}

// Merge a row's S sorted candidate lists of length k (cd/ci point at the
// row's (S, k) block; lane s owns list s, S <= 32) into its k best.
// Lane r < k ends with the r-th nearest (my_d, my_i), in (distance,
// index) order; the other lanes end with (inf, 0).
__device__ __forceinline__ void merge_splits(const float* __restrict__ cd,
                                             const int* __restrict__ ci,
                                             int S, int k, int lane,
                                             float& my_d, int& my_i) {
  int ptr = 0;
  my_d = INFINITY;
  my_i = 0;
  for (int rnd = 0; rnd < k; ++rnd) {
    float hv = INFINITY;
    int hi = INT_MAX;
    if (lane < S && ptr < k) { hv = cd[lane * k + ptr]; hi = ci[lane * k + ptr]; }
    float bv = hv;
    int bi = hi;
    warp_argmin(bv, bi);
    if (lane < S && ptr < k && hi == bi) ++ptr;
    if (lane == rnd) { my_d = bv; my_i = bi; }
  }
}

}  // namespace knn
