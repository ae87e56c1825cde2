// Mamba-2 SSD chunked scan (forward) on Hopper.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_scan (the Pallas kernel
// `_kernel`, pl.pallas_call at line 87): per batch row and head, over
// chunks of Q tokens in order, the masked decayed (Q x Q) product inside
// the chunk plus the carried (P x N) float32 state, and the state's
// update; y in x's dtype and the final state in float32.
//
// What bounds it on an H100. Per (row, head, chunk) the work is the
// lower triangle of C.B^T (Q(Q+1)/2 dots of length N), its product with
// x (Q(Q+1)/2 x P), the state's read-out (Q x P x N) and its update
// (P x N x Q): at the serving shape (B = 4, S = 1,024, nh = 64, P = 64,
// N = 128, Q = 128) about 15.1 GFLOP per call in float32 (the Pallas
// kernel's precision), 0.23 ms at the CUDA cores' 67 TFLOP/s, against
// 81 MB of inputs and outputs, 0.024 ms at 3.35 TB/s: it is
// operations-bound. chip_smoke.py computes both bounds per shape.
//
// What the design does about it. The TPU grid walks (head tiles x
// chunks) with the chunk axis in order on one core; here one CTA per
// (row, head) walks the chunks in order, so the state never leaves
// shared memory (B x nh = 256 CTAs at the serving shape). A chunk's
// x (Q x P), B and C (Q x N each, rows padded to N + 1 floats so that
// threads reading different rows hit different banks) and the state
// (held transposed, N x P) are 200 KB of the 227 KB a block may use, so
// the decayed product is never stored whole: it is formed 16 query rows
// at a time (8 KB), the decay exp(cum[q] - cum[k]) computed only for
// k <= q (the Pallas body exponentiates the whole block, and its upper
// triangle can overflow before the mask), and consumed at once by those
// rows' outputs. Each thread owns one element of P across a warp, so
// x and the state are read without bank conflicts and B, C and the
// product row are broadcasts. One thread forms the running sum cum.
//
// Arithmetic. Float32 throughout, each product and sum IEEE-rounded
// (--fmad=false), in the Pallas kernel's association: M = (C.B) * L *
// dt, y = y_intra + y_inter; the state term is (B * contrib) * x, as the
// plain version forms it (the Pallas kernel leaves that order to XLA's
// three-operand einsum). Only the summation order differs from the plain
// version's einsums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROW_TILE = 16;   // kernels/ssd_scan.py ROW_TILE
constexpr size_t SMEM_DEFAULT = 48 * 1024;

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

size_t smem_bytes(int Q, int P, int N) {
  return sizeof(float) * ((size_t)N * P + (size_t)Q * P +
                          2 * (size_t)Q * (N + 1) + (size_t)ROW_TILE * Q +
                          4 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ xh, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, int S, int nh, int P, int G,
                int N, int Q, T* __restrict__ y,
                float* __restrict__ state_out) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (nh / G), NP = N + 1;
  float* stT = smem;                 // (N, P) state, transposed
  float* xs = stT + N * P;           // (Q, P)
  float* Bs = xs + Q * P;            // (Q, N + 1)
  float* Cs = Bs + Q * NP;           // (Q, N + 1)
  float* Mt = Cs + Q * NP;           // (ROW_TILE, Q)
  float* cum = Mt + ROW_TILE * Q;    // (Q,) running sum of dt * A
  float* dts = cum + Q;              // (Q,) dt
  float* dec = dts + Q;              // (Q,) exp(cum)
  float* con = dec + Q;              // (Q,) dt * exp(cum[Q-1] - cum)
  const float a = A[h];
  const int tid = threadIdx.x;

  for (int i = tid; i < N * P; i += blockDim.x) stT[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const size_t tok0 = (size_t)b * S + c0;
    for (int i = tid; i < Q * P; i += blockDim.x) {
      const int k = i / P, p = i % P;
      xs[i] = to_f(xh[((tok0 + k) * nh + h) * P + p]);
    }
    for (int i = tid; i < Q * N; i += blockDim.x) {
      const int k = i / N, n = i % N;
      const size_t src = ((tok0 + k) * G + grp) * N + n;
      Bs[k * NP + n] = Bm[src];
      Cs[k * NP + n] = Cm[src];
    }
    for (int k = tid; k < Q; k += blockDim.x) dts[k] = dt[(tok0 + k) * nh + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int k = 0; k < Q; ++k) {
        run = __fadd_rn(run, __fmul_rn(dts[k], a));
        cum[k] = run;
      }
    }
    __syncthreads();
    for (int k = tid; k < Q; k += blockDim.x) {
      dec[k] = expf(cum[k]);
      con[k] = __fmul_rn(dts[k], expf(__fsub_rn(cum[Q - 1], cum[k])));
    }
    __syncthreads();

    for (int q0 = 0; q0 < Q; q0 += ROW_TILE) {
      const int rows = min(ROW_TILE, Q - q0);
      // M[q][k] = (C[q] . B[k]) * exp(cum[q] - cum[k]) * dt[k], k <= q
      for (int i = tid; i < rows * Q; i += blockDim.x) {
        const int q = q0 + i / Q, k = i % Q;
        float m = 0.f;
        if (k <= q) {
          float sc = 0.f;
          for (int n = 0; n < N; ++n)
            sc = __fadd_rn(sc, __fmul_rn(Cs[q * NP + n], Bs[k * NP + n]));
          m = __fmul_rn(__fmul_rn(sc, expf(__fsub_rn(cum[q], cum[k]))),
                        dts[k]);
        }
        Mt[i] = m;
      }
      __syncthreads();
      for (int i = tid; i < rows * P; i += blockDim.x) {
        const int r = i / P, p = i % P, q = q0 + r;
        float yi = 0.f;
        for (int k = 0; k <= q; ++k)
          yi = __fadd_rn(yi, __fmul_rn(Mt[r * Q + k], xs[k * P + p]));
        float yo = 0.f;
        const float dq = dec[q];
        for (int n = 0; n < N; ++n)
          yo = __fadd_rn(yo, __fmul_rn(__fmul_rn(Cs[q * NP + n], dq),
                                       stT[n * P + p]));
        y[((tok0 + q) * nh + h) * P + p] = from_f<T>(__fadd_rn(yi, yo));
      }
      __syncthreads();
    }

    // state = state * exp(cum[Q-1]) + sum_k (B[k] * contrib[k]) x[k]
    const float dl = expf(cum[Q - 1]);
    for (int i = tid; i < N * P; i += blockDim.x) {
      const int n = i / P, p = i % P;
      float st = 0.f;
      for (int k = 0; k < Q; ++k)
        st = __fadd_rn(st, __fmul_rn(__fmul_rn(Bs[k * NP + n], con[k]),
                                     xs[k * P + p]));
      stT[i] = __fadd_rn(__fmul_rn(stT[i], dl), st);
    }
    __syncthreads();
  }

  float* out = state_out + ((size_t)b * nh + h) * P * N;
  for (int i = tid; i < N * P; i += blockDim.x) {
    const int p = i / N, n = i % N;
    out[i] = stT[n * P + p];
  }
}

template <typename T>
int launch(const void* xh, const float* Bm, const float* Cm, const float* dt,
           const float* A, int Bsz, int S, int nh, int P, int G, int N, int Q,
           void* y, float* state, cudaStream_t st) {
  const size_t sm = smem_bytes(Q, P, N);
  if (sm > SMEM_DEFAULT) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(nh, Bsz);
  ssd_scan_kernel<T><<<grid, THREADS, sm, st>>>(
      static_cast<const T*>(xh), Bm, Cm, dt, A, S, nh, P, G, N, Q,
      static_cast<T*>(y), state);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// xh (B, S, nh, P) and y in one dtype (0 float32, 1 bfloat16); Bm/Cm
// (B, S, G, N), dt (B, S, nh), A (nh,) and the final state (B, nh, P, N)
// float32. S % Q == 0, nh % G == 0. One kernel on `stream`; returns the
// first cudaError_t (0 = success).
int rt_ssd_scan(const void* xh, const float* Bm, const float* Cm,
                const float* dt, const float* A, int Bsz, int S, int nh,
                int P, int G, int N, int Q, int dtype, void* y, float* state,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || S % Q || G < 1 || nh % G) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(xh, Bm, Cm, dt, A, Bsz, S, nh, P, G, N, Q, y, state,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xh, Bm, Cm, dt, A, Bsz, S, nh, P, G, N, Q, y,
                                 state, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
