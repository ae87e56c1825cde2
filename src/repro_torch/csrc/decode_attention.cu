// GQA single-token decode attention (flash-decoding) on Hopper.
//
// Replaces src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas kernel `_kernel`, pl.pallas_call at line 87): for each batch row
// and query head, softmax(q . k / sqrt(d)) over the valid cache slots,
// applied to v, with the query heads of one kv head sharing its cache
// (no head repetition).
//
// What bounds it on an H100. One call reads the valid part of the K and
// V caches once, 2 * B * C_valid * K * d elements, and does about
// 4 * B * H * C_valid * d operations: about one operation per byte, far
// below the ~20 float32 operations per byte at which the card's CUDA
// cores, not its memory, become the limit. It is bytes-bound: at the
// serving shape (B = 8, K = 2, d = 128, bf16, ~540 valid slots) 4.4 MB,
// 1.3 us at 3.35 TB/s. chip_smoke.py computes the bound per shape.
//
// What the design does about it. The TPU kernel walks the cache in order
// on one core, carrying (m, l, acc) across grid steps; here that would be
// B * K = 16 CTAs for 132 SMs. So the cache is cut into 64-slot pieces
// and the work is two __global__ functions on the caller's stream:
//   1. decode_attention_partial: one CTA per (piece, kv head, batch row).
//      It stages the g query heads in shared memory; each warp takes a
//      slot, holds the k row in registers (lane j of 32 takes elements
//      j, j+32, ...) and reduces the g dots across the warp. Then per
//      head the piece's max m, p = exp(s - m) for valid slots (0
//      otherwise), l = sum p, and p rounded to the cache's dtype; then
//      each thread owns one element of d and sums p * v over the
//      piece's valid slots for all g heads, reading each v row once.
//      (m, l, acc) go to float32 scratch (B, K, S, g[, d]).
//   2. decode_attention_merge: one CTA per (batch row, kv head) combines
//      the S pieces: M = max m, L = sum l e^(m-M), A = sum acc e^(m-M),
//      out = A / max(L, 1e-30) in q's dtype.
// Invalid slots are skipped (their k and v rows are never read), so the
// bytes read follow the valid part of the cache.
//
// Arithmetic. Products and sums are IEEE-rounded one at a time
// (--fmad=false); only the summation order differs from the plain
// version's einsums. expf is the accurate one (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int SPLIT = 64;      // cache slots per CTA (kernels/decode_attention.py)
constexpr int MAX_G = 32;
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

__device__ __forceinline__ float warp_max(float a) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  return a;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_partial(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc,
                         const int* __restrict__ cpos, int H, int K, int C,
                         int d, int pos, int window, float scale,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  __shared__ int valid[SPLIT];
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x, g = H / K, c0 = s * SPLIT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  float* qs = smem;              // (g, d) float32
  float* ps = smem + g * d;      // (g, SPLIT): scores, then p

  const T* qrow = q + ((size_t)b * H + (size_t)kh * g) * d;
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) qs[i] = to_f(qrow[i]);
  for (int c = threadIdx.x; c < SPLIT; c += blockDim.x) {
    const int cc = c0 + c;
    bool v = false;
    if (cc < C) {
      const int cp = cpos[cc];
      v = cp >= 0 && cp <= pos && (window <= 0 || cp > pos - window);
    }
    valid[c] = v;
  }
  __syncthreads();

  // scores s = (q . k) * scale, one slot per warp at a time
  for (int c = warp; c < SPLIT; c += n_warps) {
    if (!valid[c]) {
      for (int h = lane; h < g; h += 32) ps[h * SPLIT + c] = NEG_INF;
      continue;
    }
    const T* krow = kc + (((size_t)b * C + c0 + c) * K + kh) * d;
    float kr[MAX_D / 32];
#pragma unroll
    for (int t = 0; t < MAX_D / 32; ++t) {
      const int j = lane + 32 * t;
      kr[t] = j < d ? to_f(krow[j]) : 0.f;
    }
    for (int h = 0; h < g; ++h) {
      float a = 0.f;
#pragma unroll
      for (int t = 0; t < MAX_D / 32; ++t) {
        const int j = lane + 32 * t;
        if (j < d) a = __fadd_rn(a, __fmul_rn(qs[h * d + j], kr[t]));
      }
      a = warp_sum(a);
      if (lane == 0) ps[h * SPLIT + c] = __fmul_rn(a, scale);
    }
  }
  __syncthreads();

  // per head: the piece's max, p, l; p rounded to the cache dtype
  const size_t part = (((size_t)b * K + kh) * S + s) * g;
  for (int h = warp; h < g; h += n_warps) {
    float mx = NEG_INF;
    for (int c = lane; c < SPLIT; c += 32) mx = fmaxf(mx, ps[h * SPLIT + c]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int c = lane; c < SPLIT; c += 32) {
      const float p = valid[c] ? expf(__fsub_rn(ps[h * SPLIT + c], mx)) : 0.f;
      l = __fadd_rn(l, p);
      ps[h * SPLIT + c] = to_f(from_f<T>(p));
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_m[part + h] = mx;
      part_l[part + h] = l;
    }
  }
  __syncthreads();

  // acc[h][j] = sum_c p[h][c] * v[c][j], each v row read once
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    float acc[MAX_G];
#pragma unroll
    for (int h = 0; h < MAX_G; ++h) acc[h] = 0.f;
    for (int c = 0; c < SPLIT; ++c) {
      if (!valid[c]) continue;
      const float v = to_f(vc[(((size_t)b * C + c0 + c) * K + kh) * d + j]);
#pragma unroll
      for (int h = 0; h < MAX_G; ++h)
        if (h < g) acc[h] = __fadd_rn(acc[h], __fmul_rn(ps[h * SPLIT + c], v));
    }
#pragma unroll
    for (int h = 0; h < MAX_G; ++h)
      if (h < g) part_acc[(part + h) * d + j] = acc[h];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_merge(const float* __restrict__ part_m,
                       const float* __restrict__ part_l,
                       const float* __restrict__ part_acc, int H, int K,
                       int S, int d, T* __restrict__ out) {
  const int bk = blockIdx.x, b = bk / K, kh = bk % K, g = H / K;
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    const int h = i / d, j = i % d;
    float M = NEG_INF;
    for (int s = 0; s < S; ++s)
      M = fmaxf(M, part_m[((size_t)bk * S + s) * g + h]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t ps = ((size_t)bk * S + s) * g + h;
      const float w = expf(__fsub_rn(part_m[ps], M));
      L = __fadd_rn(L, __fmul_rn(part_l[ps], w));
      A = __fadd_rn(A, __fmul_rn(part_acc[ps * d + j], w));
    }
    out[((size_t)b * H + (size_t)kh * g + h) * d + j] =
        from_f<T>(__fdiv_rn(A, fmaxf(L, 1e-30f)));
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const int* cpos,
           int B, int H, int K, int C, int d, int S, int pos, int window,
           float scale, float* part_m, float* part_l, float* part_acc,
           void* out, cudaStream_t st) {
  const int g = H / K;
  const size_t smem = (size_t)g * (d + SPLIT) * sizeof(float);
  dim3 grid(S, K, B);
  decode_attention_partial<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), cpos, H, K, C, d, pos, window, scale,
      part_m, part_l, part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_merge<T><<<B * K, THREADS, 0, st>>>(
      part_m, part_l, part_acc, H, K, S, d, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, d), caches (B, C, K, d) and out (B, H, d) in one dtype
// (0 float32, 1 bfloat16); cpos (C,) int32; scratch part_m/part_l
// (B, K, S, g) and part_acc (B, K, S, g, d) float32 with S = ceil(C/64).
// H % K == 0, H/K <= 32, d <= 256. Both kernels on `stream`; returns the
// first cudaError_t (0 = success).
int rt_decode_attention(const void* q, const void* kc, const void* vc,
                        const int* cpos, int B, int H, int K, int C, int d,
                        int S, int pos, int window, int dtype, float scale,
                        float* part_m, float* part_l, float* part_acc,
                        void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % K || H / K > MAX_G || d > MAX_D || S != (C + SPLIT - 1) / SPLIT)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, kc, vc, cpos, B, H, K, C, d, S, pos, window,
                         scale, part_m, part_l, part_acc, out, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, cpos, B, H, K, C, d, S, pos,
                                 window, scale, part_m, part_l, part_acc, out,
                                 st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
