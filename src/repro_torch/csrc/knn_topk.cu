// The k nearest index rows of each query row by squared L2 distance,
// ascending by (distance, index): the KNN estimator's lookup on Hopper,
// as one launch.
//
// Replaces src/repro/kernels/knn_topk.py::knn_topk (the Pallas kernel
// `_kernel`, pl.pallas_call at line 83): d2 = (|q|^2 + |x|^2) - 2 q.x
// over the whole index, then the k smallest, sorted.
//
// What bounds it on an H100. One call reads the index once, N*E*4 bytes
// plus N*4 of norms (7.7 MB at the staged path's N = 14,886, E = 128:
// about 2.3 us at 3.35 TB/s), and does 2*B*N*E float32 operations on the
// CUDA cores (the distances keep full float32, so no tensor cores). At
// the staged path's small batches (B = 1 to 8) it is bytes-bound; from a
// few dozen rows up it is operations-bound (14.6 us at B = 256 and
// 67 TFLOP/s). chip_smoke.py computes both bounds per shape.
//
// What the design does about it. The TPU kernel walks the index tiles in
// order on one core, carrying the top-k across grid steps. Here one
// __global__ function covers the card at any batch: (S splits of the
// index x row tiles), the row tile and S chosen per batch from a
// measured table, x streamed with cp.async, register micro-tiles at 16-
// and 32-row tiles, per-row top-k lists held one entry per lane, and the
// merge done by the CTA that draws the row tile's last ticket. The body
// is knn_common.cuh's `fused_topk`, shared with the decision kernel's
// stage 1 (its header says how it is laid out); this file adds the
// distance form and writes each row's list out.
//
// Exactness. The distance is the TPU kernel's association, spelled with
// IEEE adds (__fadd_rn/__fsub_rn, --fmad=false); only the dot product's
// summation order differs from the plain version's matmul (a chain of
// fmaf over e, or four such chains added). Ties go to the lower index.
#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

using knn::KMAX;

// writes row `row`'s final list: lane r < k holds the r-th nearest
struct WriteList {
  float* out_d;
  int* out_i;
  int k;
  __device__ void operator()(int row, int lane, float d, int i) const {
    if (lane < k) {
      out_d[(size_t)row * k + lane] = d;
      out_i[(size_t)row * k + lane] = i;
    }
  }
};

template <int RT, int MR, int MC, int ES>
__global__ void __launch_bounds__(knn::THREADS)
knn_topk_fused(const float* __restrict__ q, const float* __restrict__ qsq_in,
               const float* __restrict__ x, const float* __restrict__ xsq,
               int B, int N, int E, int k, int per_split,
               float* __restrict__ cand_d, int* __restrict__ cand_i,
               int* __restrict__ tickets, float* __restrict__ out_d,
               int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  knn::fused_topk<knn::QSQ_FIRST, RT, MR, MC, ES>(
      q, qsq_in, x, xsq, B, N, E, k, per_split, gridDim.x, cand_d, cand_i,
      tickets, smem, WriteList{out_d, out_i, k});
}

template <int RT, int MR, int MC, int ES>
int launch(const float* q, const float* qsq, const float* x, const float* xsq,
           int B, int N, int E, int k, int S, int per_split, float* cand_d,
           int* cand_i, int* tickets, float* out_d, int* out_i,
           cudaStream_t st) {
  auto kern = knn_topk_fused<RT, MR, MC, ES>;
  // once per device: allow any dynamic shared memory the shape can take
  static bool raised[knn::MAX_DEVICES] = {};
  cudaError_t err = knn::allow_optin_smem(kern, raised);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S, (B + RT - 1) / RT);
  kern<<<grid, knn::THREADS, knn::smem_bytes(RT, E), st>>>(
      q, qsq, x, xsq, B, N, E, k, per_split, cand_d, cand_i, tickets, out_d,
      out_i);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory, in bytes, of a row tile of RT rows.
size_t rt_knn_topk_smem(int RT, int E) { return knn::smem_bytes(RT, E); }

// q (B, E), x (N, E) float32 with E % 4 == 0 and 16-byte aligned rows;
// qsq (B,) or null (then summed in the kernel), xsq (N,) float32; row
// tiles of RT in {1, 2, 4, 8, 16, 32} rows; S splits of per_split
// 64-column tiles (S = ceil(ceil(N / 64) / per_split)); scratch
// cand_d/cand_i (B, S, k); tickets, one int per row tile, zero before
// the first call and left zero by every call; outputs out_d/out_i (B,
// k). 1 <= k <= min(32, N). One launch on `stream`; returns the
// cudaError_t (0 = success).
int rt_knn_topk(const float* q, const float* qsq, const float* x,
                const float* xsq, int B, int N, int E, int k, int RT, int S,
                int per_split, float* cand_d, int* cand_i, int* tickets,
                float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_ct = (N + knn::CT - 1) / knn::CT;
  if (B < 1 || E % 4 || k < 1 || k > KMAX || k > N || per_split < 1 ||
      S != (n_ct + per_split - 1) / per_split)
    return (int)cudaErrorInvalidValue;
#define RT_LAUNCH(RT_, MR, MC, ES)                                          \
  return launch<RT_, MR, MC, ES>(q, qsq, x, xsq, B, N, E, k, S, per_split, \
                                 cand_d, cand_i, tickets, out_d, out_i, st)
  switch (RT) {
    case 1: RT_LAUNCH(1, 1, 1, knn::SMALL_ES);
    case 2: RT_LAUNCH(2, 2, 1, knn::SMALL_ES);
    case 4: RT_LAUNCH(4, 4, 1, knn::SMALL_ES);
    case 8: RT_LAUNCH(8, 8, 1, knn::SMALL_ES);
    case 16: RT_LAUNCH(16, 1, 4, 1);
    case 32: RT_LAUNCH(32, 2, 4, 1);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_LAUNCH
}

}  // extern "C"
