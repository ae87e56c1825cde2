// The k nearest index rows of each query row by squared L2 distance,
// ascending by (distance, index): the KNN estimator's lookup on Hopper.
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
// order on one core, carrying the top-k across grid steps; on this card
// one CTA would stream the whole index with 131 of 132 SMs idle. So the
// index is cut into S splits and the work is two __global__ functions,
// launched back to back on the caller's stream:
//   1. knn_topk_partial: a grid of (8-row tiles x S splits). Each CTA
//      streams its split through shared memory, one warp per query row,
//      each lane keeping a sorted top-k of its columns; the warp merges
//      its 32 lists into the split's k best, written to (B, S, k)
//      scratch (knn_common.cuh, shared with the decision kernel's
//      stage 1). S is chosen by the caller so that about two waves of
//      CTAs cover the SMs even at B = 1.
//   2. knn_topk_merge: one warp per row merges the S lists (one lane per
//      split) into the final k and writes d2 and idx.
// The ragged edge is masked in the kernel (no padded copy of x), so no
// index >= N is ever returned.
//
// Exactness. The distance is the TPU kernel's association, spelled with
// IEEE adds (__fadd_rn/__fsub_rn, --fmad=false); only the dot product's
// summation order differs from the plain version's matmul. The norms
// come from the caller. Ties go to the lower index.
#include <cuda_runtime.h>

#include "knn_common.cuh"

namespace {

__global__ void __launch_bounds__(knn::THREADS)
knn_topk_partial(const float* __restrict__ q, const float* __restrict__ qsq,
                 const float* __restrict__ x, const float* __restrict__ xsq,
                 int B, int N, int E, int k, int S,
                 float* __restrict__ cand_d, int* __restrict__ cand_i) {
  knn::split_topk<knn::QSQ_FIRST>(q, qsq, x, xsq, B, N, E, k, S, cand_d,
                                  cand_i);
}

__global__ void __launch_bounds__(knn::THREADS)
knn_topk_merge(const float* __restrict__ cand_d,
               const int* __restrict__ cand_i, int B, int S, int k,
               float* __restrict__ out_d, int* __restrict__ out_i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;                        // whole warps leave
  float my_d;
  int my_i;
  const size_t o = (size_t)row * S * k;
  knn::merge_splits(cand_d + o, cand_i + o, S, k, lane, my_d, my_i);
  if (lane < k) {
    out_d[(size_t)row * k + lane] = my_d;
    out_i[(size_t)row * k + lane] = my_i;
  }
}

constexpr size_t SMEM_DEFAULT = 48 * 1024;

}  // namespace

extern "C" {

// Dynamic shared memory of knn_topk_partial, in bytes.
size_t rt_knn_topk_smem(int E) { return knn::smem_bytes(E); }

// q (B, E), x (N, E) float32 with E % 4 == 0 and 16-byte aligned rows;
// qsq (B,), xsq (N,) float32; scratch cand_d/cand_i (B, S, k); outputs
// out_d/out_i (B, k). 1 <= k <= min(32, N), 1 <= S <= 32. Both kernels
// on `stream`; returns the first cudaError_t (0 = success).
int rt_knn_topk(const float* q, const float* qsq, const float* x,
                const float* xsq, int B, int N, int E, int k, int S,
                float* cand_d, int* cand_i, float* out_d, int* out_i,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = knn::smem_bytes(E);
  cudaError_t err;
  if (sm > SMEM_DEFAULT) {
    err = cudaFuncSetAttribute(knn_topk_partial,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 g1((B + knn::ROWS - 1) / knn::ROWS, S);
  knn_topk_partial<<<g1, knn::THREADS, sm, st>>>(q, qsq, x, xsq, B, N, E,
                                                 k, S, cand_d, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_per_cta = knn::THREADS / 32;
  knn_topk_merge<<<(B + rows_per_cta - 1) / rows_per_cta, knn::THREADS, 0,
                   st>>>(cand_d, cand_i, B, S, k, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // extern "C"
