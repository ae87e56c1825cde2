// KNN top-k device code shared by the lookup (knn_topk.cu, K2) and stage
// 1 of the decision kernel (decision_megakernel.cu, K1): the k nearest
// index rows of each query row by squared L2 distance, ascending by
// (distance, index), in one launch at any batch.
//
// The grid is (S splits of the index x row tiles of RT rows), each split
// whole 64-column tiles; the caller chooses RT (1, 2, 4, 8, 16 or 32)
// and S per batch from a measured table (kernels/knn_topk.py LAYOUTS):
//   * A CTA stages its rows once, sums |q|^2 from them (unless the
//     caller passes the norms) and streams its x columns through a
//     4-deep ring of 64 x 32-float chunks with 16-byte cp.async, so
//     loads run ahead of the arithmetic.
//   * Small row tiles: each of the 256 threads takes one column and a
//     quarter of each chunk's e, for all the tile's rows, so all 8 warps
//     compute at B = 1; the quarters' dots are added after the tile.
//     Row tiles of 16 and 32: each thread forms an RT/16 x 4 register
//     micro-tile of dots, so each shared-memory load feeds 4 to 8 FMAs.
//   * After each 64-column tile the distances go to shared memory and
//     one warp per row offers them to the row's running top-k, held one
//     entry per lane: a candidate below the k-th entry is inserted by a
//     ballot and a shift.
//   * The split's k best go to scratch; then __threadfence() and an
//     atomicAdd on the row tile's ticket. The CTA that draws the last
//     ticket merges the S lists of its rows the same way, hands each
//     row's final list to the caller's `tail` (lane r < k holds the r-th
//     nearest), and resets the ticket to 0 for the next call on the
//     stream. The ragged edge is masked (no padded copy of x), so no
//     index >= N is ever returned.
//
// The two kernels spell the distance differently, because their TPU
// kernels did: K1 (and the plain `topk_soft_lookup`) form
// (xsq - 2 q.x) + qsq, K2 (qsq + xsq) - 2 q.x, each with IEEE adds
// (__fadd_rn/__fsub_rn, --fmad=false); the dot product is a chain of
// fmaf over e, or four such chains added. Ties go to the lower index.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <climits>

namespace knn {

constexpr int KMAX = 32;          // largest k (one lane per neighbour)
constexpr int THREADS = 256;
constexpr int CT = 64;            // index columns per tile
constexpr int EK = 32;            // floats of e per staged chunk
constexpr int XS = EK + 4;        // padded chunk row (floats)
constexpr int NST = 4;            // chunks in flight
constexpr int DS = CT + 1;        // padded distance row (floats)
constexpr int SMALL_ES = 4;       // e-quarters of a small row tile
constexpr int MAX_DEVICES = 64;
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

template <int FORM>
__device__ __forceinline__ float dist2(float qsq, float xsq, float dot) {
  return FORM == QSQ_FIRST
             ? __fsub_rn(__fadd_rn(qsq, xsq), __fmul_rn(2.f, dot))
             : __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.f, dot)), qsq);
}

// |q|^2 slots, padded so that the chunk ring after them is 16-byte aligned
__host__ __device__ constexpr int qsq_len(int RT) { return (RT + 3) / 4 * 4; }

// Byte size of the dynamic shared memory of `fused_topk`: q rows, |q|^2,
// the chunk ring, the distances (or the small tile's per-quarter dots,
// or the final merge's 8 warp lists).
inline size_t smem_bytes(int RT, int E) {
  const int dist = max(RT > 8 ? RT * DS : SMALL_ES * RT * DS, 2 * 8 * 32);
  return sizeof(float) * ((size_t)RT * (E + 4) + qsq_len(RT) +
                          (size_t)NST * CT * XS + dist);
}

// Once per device and kernel: let the kernel take any dynamic shared
// memory the device allows a block.
template <class Kern>
inline cudaError_t allow_optin_smem(Kern kern, bool* raised) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (raised[dev]) return cudaSuccess;
  int optin = 0;
  cudaFuncAttributes fa;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  if (err == cudaSuccess) raised[dev] = true;
  return err;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sort a warp's 32 (v, j) pairs ascending by (v, j): a bitonic network.
__device__ __forceinline__ void warp_sort(float& v, int& j, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(FULL, v, stride);
      const int oj = __shfl_xor_sync(FULL, j, stride);
      const bool low = ((lane & stride) == 0) == ((lane & size) == 0);
      const bool less = lex_less(ov, oj, v, j);
      if (low ? less : !less) { v = ov; j = oj; }
    }
}

// Offer each lane's (v, j) to a warp's sorted list (lane r < k holds the
// r-th best; lanes >= k hold (inf, INT_MAX)); (td, ti) is entry k - 1.
// A few candidates below entry k - 1 are inserted one at a time by a
// ballot and a shift; more are sorted and merged with the list.
__device__ __forceinline__ void offer(float v, int j, int k, int lane,
                                      float& ld, int& li, float& td,
                                      int& ti) {
  const bool pass = lex_less(v, j, td, ti);
  unsigned m = __ballot_sync(FULL, pass);
  if (__popc(m) > 6) {                 // a sort costs about 7 inserts
    if (!pass) { v = INFINITY; j = INT_MAX; }
    warp_sort(v, j, lane);
    // the 32 smallest of list and chunk, as a bitonic sequence, sorted
    const float rv = __shfl_sync(FULL, v, 31 - lane);
    const int rj = __shfl_sync(FULL, j, 31 - lane);
    if (lex_less(rv, rj, ld, li)) { ld = rv; li = rj; }
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(FULL, ld, stride);
      const int oj = __shfl_xor_sync(FULL, li, stride);
      const bool less = lex_less(ov, oj, ld, li);
      if ((lane & stride) == 0 ? less : !less) { ld = ov; li = oj; }
    }
    if (lane >= k) { ld = INFINITY; li = INT_MAX; }
    td = __shfl_sync(FULL, ld, k - 1);
    ti = __shfl_sync(FULL, li, k - 1);
    return;
  }
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(FULL, v, src);
    const int ci = __shfl_sync(FULL, j, src);
    if (!lex_less(cv, ci, td, ti)) continue;   // the same on every lane
    const int p = __popc(__ballot_sync(FULL, lane < k &&
                                                 lex_less(ld, li, cv, ci)));
    const float ud = __shfl_up_sync(FULL, ld, 1);
    const int ui = __shfl_up_sync(FULL, li, 1);
    if (lane > p && lane < k) { ld = ud; li = ui; }
    else if (lane == p) { ld = cv; li = ci; }
    td = __shfl_sync(FULL, ld, k - 1);
    ti = __shfl_sync(FULL, li, k - 1);
  }
}

// The body of one CTA of the lookup, launched on a grid of (S splits x
// ceil(B / RT) row tiles) of THREADS threads with smem_bytes(RT, E) of
// dynamic shared memory at `smem` (split blockIdx.x < S: a caller whose
// grid is wider keeps its other CTAs out). q (B, E), x (N, E) float32; qsq_in
// (B,) or null (then summed here); xsq (N,); per_split 64-column tiles a
// split; scratch cand_d/cand_i (B, S, k) and one ticket per row tile.
// Thread micro-tile MR rows x MC columns over a 1/ES share of e:
// RT / MR row groups x (CT / MC) column groups x ES = THREADS.
// Returns true in the CTA that merged its row tile, after every final
// list went to `tail(row, lane, d, idx)`, called by the whole warp that
// holds the row's list (lanes >= k hold (inf, INT_MAX)).
template <int FORM, int RT, int MR, int MC, int ES, class Tail>
__device__ __forceinline__ bool fused_topk(
    const float* __restrict__ q, const float* __restrict__ qsq_in,
    const float* __restrict__ x, const float* __restrict__ xsq, int B,
    int N, int E, int k, int per_split, int S, float* __restrict__ cand_d,
    int* __restrict__ cand_i, int* __restrict__ tickets, float* smem,
    const Tail& tail) {
  constexpr int RG = RT / MR, CGN = CT / MC, EW = EK / ES;
  constexpr int RPW = RT >= 8 ? RT / 8 : 1;   // rows of a warp's lists
  static_assert(RG * CGN * ES == THREADS, "thread layout");
  const int E4p = E + 4;
  float* qs = smem;                                // RT x (E + 4)
  float* qsq = qs + RT * E4p;                      // RT
  float* xs = qsq + qsq_len(RT);                   // NST x CT x XS
  float* dist = xs + NST * CT * XS;                // (ES x) RT x DS
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int es = tid / (RG * CGN), rem = tid % (RG * CGN);
  const int tr = rem / CGN, tc = rem % CGN;
  const int split = blockIdx.x, rt = blockIdx.y;
  const int row0 = rt * RT;
  const int n_ct = (N + CT - 1) / CT;
  const int ct0 = split * per_split, ct1 = min(n_ct, ct0 + per_split);
  const int j1 = min(N, ct1 * CT);
  const int nec = (E + EK - 1) / EK;
  const int n_items = (ct1 - ct0) * nec;

  // x chunk of item i: columns of tile ct0 + i / nec, e of chunk i % nec
  auto issue = [&](int i) {
    if (i < n_items) {
      const int jb = (ct0 + i / nec) * CT, eb = (i % nec) * EK;
      float* buf = xs + (i % NST) * CT * XS;
      for (int t = tid; t < CT * (EK / 4); t += THREADS) {
        const int c = t / (EK / 4), e = eb + (t % (EK / 4)) * 4;
        const bool v = jb + c < j1 && e < E;
        cp_async16(buf + c * XS + (e - eb), v ? x + (size_t)(jb + c) * E + e : x,
                   v ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // the rows, asynchronously with the first chunk (rows past B zero)
  for (int t = tid; t < RT * (E / 4); t += THREADS) {
    const int r = t / (E / 4), e = (t % (E / 4)) * 4;
    const bool v = row0 + r < B;
    cp_async16(qs + r * E4p + e, v ? q + (size_t)(row0 + r) * E + e : q,
               v ? 16 : 0);
  }
  for (int i = 0; i < NST; ++i) issue(i);

  // this warp's rows (warp + 8 i) and their running lists
  float ld[RPW], td[RPW];
  int li[RPW], ti[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    ld[i] = td[i] = INFINITY;
    li[i] = ti[i] = INT_MAX;
  }

  float acc[MR][MC];
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int c = 0; c < MC; ++c) acc[a][c] = 0.f;

  for (int i = 0; i < n_items; ++i) {
    cp_async_wait<NST - 1>();
    __syncthreads();
    if (i == 0) {                      // the rows are in: |q|^2
      for (int r = warp; r < RT; r += THREADS / 32) {
        float s = 0.f;
        if (qsq_in) {
          s = row0 + r < B ? qsq_in[row0 + r] : 0.f;
        } else {
          for (int e = lane; e < E; e += 32)
            s = fmaf(qs[r * E4p + e], qs[r * E4p + e], s);
          for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
        }
        if (lane == 0) qsq[r] = s;
      }
      __syncthreads();
    }
    const float* buf = xs + (i % NST) * CT * XS;
    const int eb = (i % nec) * EK;
    for (int e = es * EW; e < es * EW + EW && eb + e < E; e += 4) {
      float4 xv[MC], qv[MR];
#pragma unroll
      for (int c = 0; c < MC; ++c)
        xv[c] = *reinterpret_cast<const float4*>(buf + (tc + CGN * c) * XS + e);
#pragma unroll
      for (int a = 0; a < MR; ++a)
        qv[a] = *reinterpret_cast<const float4*>(qs + (tr + RG * a) * E4p + eb + e);
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          float s = acc[a][c];
          s = fmaf(qv[a].x, xv[c].x, s); s = fmaf(qv[a].y, xv[c].y, s);
          s = fmaf(qv[a].z, xv[c].z, s); s = fmaf(qv[a].w, xv[c].w, s);
          acc[a][c] = s;
        }
    }
    if (i % nec == nec - 1) {
      // the tile is done: distances to shared memory, then the lists
      const int jb = (ct0 + i / nec) * CT;
      if (ES == 1) {
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const int cc = tc + CGN * c, j = jb + cc;
          const float xq = j < j1 ? xsq[j] : 0.f;
#pragma unroll
          for (int a = 0; a < MR; ++a) {
            const int r = tr + RG * a;
            dist[r * DS + cc] = j < j1 && row0 + r < B
                                    ? dist2<FORM>(qsq[r], xq, acc[a][c])
                                    : INFINITY;
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < MR; ++a)
#pragma unroll
          for (int c = 0; c < MC; ++c)
            dist[(es * RT + tr + RG * a) * DS + tc + CGN * c] = acc[a][c];
      }
#pragma unroll
      for (int a = 0; a < MR; ++a)
#pragma unroll
        for (int c = 0; c < MC; ++c) acc[a][c] = 0.f;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < RPW; ++w) {
        const int r = warp + 8 * w;
        if (r < RT && row0 + r < B) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int cc = lane + 32 * h, j = jb + cc;
            float v;
            if (ES == 1) {
              v = dist[r * DS + cc];
            } else {
              float dot = dist[r * DS + cc];
              for (int q2 = 1; q2 < ES; ++q2)
                dot = __fadd_rn(dot, dist[(q2 * RT + r) * DS + cc]);
              v = j < j1 ? dist2<FORM>(qsq[r], xsq[j], dot) : INFINITY;
            }
            // a column past the split never enters: (inf, INT_MAX)
            offer(v, j < j1 ? j : INT_MAX, k, lane, ld[w], li[w], td[w],
                  ti[w]);
          }
        }
      }
    }
    __syncthreads();
    issue(i + NST);
  }
  cp_async_wait<0>();

  // the split's k best, then the ticket
#pragma unroll
  for (int w = 0; w < RPW; ++w) {
    const int r = warp + 8 * w, row = row0 + r;
    if (r < RT && row < B && lane < k) {
      const size_t o = ((size_t)row * S + split) * k + lane;
      cand_d[o] = ld[w];
      cand_i[o] = li[w];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&tickets[rt], 1) == S - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();

  // The last CTA of the row tile merges the S lists of each row: WPR
  // warps share a row (all 8 at B = 1), each over every WPR-th chunk of
  // 32 candidates, loaded MB chunks at a time; then the row's first warp
  // takes in the others' lists through shared memory.
  constexpr int WPR = RT >= 8 ? 1 : 8 / RT, MB = 8;
  float* part_d = dist;                            // 8 warps x 32
  int* part_i = reinterpret_cast<int*>(dist + 8 * 32);
  const int n_cand = S * k, share = warp % WPR;
#pragma unroll
  for (int w = 0; w < RPW; ++w) {
    const int r = WPR > 1 ? warp / WPR : warp + 8 * w, row = row0 + r;
    float md = INFINITY, mtd = INFINITY;
    int mi = INT_MAX, mti = INT_MAX;
    if (r < RT && row < B) {
      const size_t base = (size_t)row * n_cand;
      const int step = 32 * WPR * MB;
      float v[MB], nv[MB];
      int j[MB], nj[MB];
      auto fetch = [&](int c0, float* fv, int* fj) {
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          const int c = c0 + b * 32 * WPR + lane;
          fv[b] = c < n_cand ? __ldcg(cand_d + base + c) : INFINITY;
          fj[b] = c < n_cand ? __ldcg(cand_i + base + c) : INT_MAX;
        }
      };
      fetch(share * 32, v, j);
      for (int c0 = share * 32; c0 < n_cand; c0 += step) {
        fetch(c0 + step, nv, nj);      // the next batch is in flight
#pragma unroll
        for (int b = 0; b < MB; ++b) {
          offer(v[b], j[b], k, lane, md, mi, mtd, mti);
          v[b] = nv[b];
          j[b] = nj[b];
        }
      }
    }
    if (WPR > 1) {
      part_d[warp * 32 + lane] = md;
      part_i[warp * 32 + lane] = mi;
      __syncthreads();
      if (share == 0 && r < RT && row < B)
        for (int o = 1; o < WPR; ++o)
          offer(part_d[(warp + o) * 32 + lane], part_i[(warp + o) * 32 + lane],
                k, lane, md, mi, mtd, mti);
    }
    if (share == 0 && r < RT && row < B) tail(row, lane, md, mi);
  }
  if (tid == 0) tickets[rt] = 0;
  return true;
}

}  // namespace knn
