// Mamba-2 SSD chunked scan (forward) on Hopper, as one launch.
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
// What the design does about it. Only the carried state orders the
// chunks; everything else in a chunk is independent of it. So:
//   * One CTA per (row, head, chunk): 2,048 at the serving shape, two
//     resident per SM (106 KB of shared memory and at most 128
//     registers a thread), about eight waves.
//   * Each CTA takes its work id from an atomic counter when it starts,
//     chunk slowest: the chunk it waits on has an id B * nh lower, so it
//     drew its id first and is running or done (CUDA does not start
//     CTAs in blockIdx order, and a wait on a CTA not yet started could
//     deadlock), and it started about a wave earlier, so its state is
//     usually there when the successor asks. (Chunk fastest, the chunks
//     of a chain start together and chunk c waits about c slot round
//     trips; tools/k4_phases.py times both orders.) All heads of one
//     chunk run together and share B and C in L2. The CTA that draws
//     the last id resets the counter for the next call.
//   * In order: C.B^T over the lower triangle while x and dt arrive
//     (cp.async), then the chunk's cum (a warp scan over Q), M = the
//     scores masked and decayed, y_intra = M x, and the chunk's own
//     state term st = sum_k (B[k] contrib[k]) x[k]^T.
//     Then it waits for the state entering the chunk: one P x N slot
//     per (row, head) in device memory and a flag. Chunk c spins on the
//     flag with ld.acquire until it reads c, writes S_in * exp(cum[Q-1])
//     + st into the slot (the plain version's association), fences and
//     releases c + 1; the last chunk writes the final state instead and
//     resets the flag.
//   * Last y_inter = (C exp(cum)) S_in, added to y_intra, which stayed
//     in registers across the wait.
//   * Every product runs on FFMA register tiles: a thread owns 8 x 4
//     outputs (y, st) or 8 x 8 pairs of the scores, so each 16-byte
//     shared-memory load feeds about ten multiply-adds. C and B stream
//     through two 32-column stages with cp.async; the thread owning rows
//     q = ty + 16 i and columns k = tx + 16 j computes only the pairs
//     j <= i, which cover the lower triangle (36 of 64), and y_intra
//     skips the blocks above the diagonal the same way. (128 threads
//     with 8 x 8 tiles, at 231 registers, ran slower on an H100: half
//     the warps hide less latency.)
//
// Arithmetic. Float32 throughout, each term one __fmaf_rn (one FFMA,
// one rounding, also under --fmad=false), in the Pallas kernel's
// association: M = (C.B) * L * dt, y = y_intra + y_inter; the state
// term is (B * contrib) * x, as the plain version forms it (the Pallas
// kernel leaves that order to XLA's three-operand einsum). The decay
// exp(cum[q] - cum[k]) is taken only for k <= q: the Pallas body
// exponentiates the whole block, and its upper triangle can overflow
// before the mask. Only the summation order differs from the plain
// version's einsums and cumsum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QT = 128;              // largest chunk (kernels/ssd_scan.py)
constexpr int PT = 64;               // largest head dimension P
constexpr int NT = 128;              // largest state dimension N
constexpr int NC = 32;               // state columns per streamed stage
constexpr int CS = NC + 4;           // padded stage row (floats)
constexpr int MS = QT + 4;           // padded row of M (floats)
constexpr int STAGE = 2 * QT * CS;   // C and B columns of one stage
constexpr int MAX_DEVICES = 64;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
// The work area, reused phase by phase: two C/B stages (the scores),
// M (y_intra), B scaled by contrib (the state term), then S_in and two
// C stages (y_inter).
constexpr int W_FLOATS =
    cmax(cmax(2 * STAGE, QT * MS), cmax(QT * NT, NT * PT + 2 * QT * CS));
// x (f32), cum, dt, exp(cum), contrib, then the work area
constexpr int SMEM_FLOATS = QT * PT + 4 * QT + W_FLOATS;
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// four consecutive values of x, loaded as one 16- or 8-byte vector
template <typename T> struct alignas(4 * sizeof(T)) Vec4 { T v[4]; };
template <typename T>
__device__ __forceinline__ float4 to_f4(const Vec4<T>& a) {
  return make_float4(to_f(a.v[0]), to_f(a.v[1]), to_f(a.v[2]), to_f(a.v[3]));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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
// BYTES of 4, 8 or 16, through L1 (x and dt are read once)
template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(BYTES), "r"(src_bytes));
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// a += u.v over the four lanes of a float4, in order
__device__ __forceinline__ float dot4(float4 u, float4 v, float a) {
  a = __fmaf_rn(u.x, v.x, a);
  a = __fmaf_rn(u.y, v.y, a);
  a = __fmaf_rn(u.z, v.z, a);
  return __fmaf_rn(u.w, v.w, a);
}
// lane r of a float4 (r a compile-time constant after unrolling)
__device__ __forceinline__ float& comp(float4& v, int r) {
  return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

// Thread (ty, tx) of a 16 x 16 layout, 4 x 8 of them per warp: output
// rows q = ty + 16 i (i < 8) and columns tx + 16 j or 4 tx .. 4 tx + 3.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_chunks(const T* __restrict__ xh, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, int Bsz, int S, int nh, int P,
                int G, int N, int Q, T* __restrict__ y,
                float* __restrict__ state_out, float* __restrict__ slots,
                int* __restrict__ flags, int* __restrict__ counter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_id;
  float* xs = smem;              // (QT, PT) x in float32, zero-padded
  float* cum = xs + QT * PT;     // (QT,) running sum of dt * A
  float* dts = cum + QT;         // (QT,) dt
  float* dec = dts + QT;         // (QT,) exp(cum)
  float* con = dec + QT;         // (QT,) dt * exp(cum[Q-1] - cum)
  float* W = con + QT;           // the work area

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int nc = S / Q;
  if (tid == 0) {
    const int id = atomicAdd(counter, 1);
    if (id == Bsz * nh * nc - 1) atomicExch(counter, 0);
    s_id = id;
  }
  __syncthreads();
  const int id = s_id, c = id / (Bsz * nh), bh = id % (Bsz * nh);
  const int h = bh % nh, b = bh / nh;
  const size_t tok0 = (size_t)b * S + (size_t)c * Q;
  const size_t rs = (size_t)G * N;                    // row stride of B, C
  const float* Cg = Cm + tok0 * rs + (size_t)(h / (nh / G)) * N;
  const float* Bg = Bm + tok0 * rs + (size_t)(h / (nh / G)) * N;
  const int nN = (N + NC - 1) / NC;

  // stage `s` of C (and B): columns [s NC, s NC + NC) of all QT rows
  auto issue = [&](int s, float* cs, bool with_b) {
    for (int t = tid; t < QT * (NC / 4); t += THREADS) {
      const int q = t / (NC / 4), n = s * NC + (t % (NC / 4)) * 4;
      const bool v = q < Q && n < N;
      const size_t off = v ? q * rs + n : 0;
      float* dst = cs + q * CS + (n - s * NC);
      cp_async16(dst, Cg + off, v ? 16 : 0);
      if (with_b) cp_async16(dst + QT * CS, Bg + off, v ? 16 : 0);
    }
    cp_async_commit();
  };
  // x (float32 straight into xs; bf16 into xs's upper half, widened
  // after the scores) and dt arrive with the first C/B stage: nothing
  // before M needs them
  T* xraw = reinterpret_cast<T*>(xs + (sizeof(T) == 2 ? QT * PT / 2 : 0));
  for (int t = tid; t < QT * PT / 4; t += THREADS) {
    const int k = t / (PT / 4), p = (t % (PT / 4)) * 4;
    const bool v = k < Q && p < P;
    cp_async_ca<4 * sizeof(T)>(xraw + 4 * t,
                               v ? xh + ((tok0 + k) * nh + h) * P + p : xh,
                               v ? 4 * sizeof(T) : 0);
  }
  for (int k = tid; k < QT; k += THREADS)
    cp_async_ca<4>(dts + k, k < Q ? dt + (tok0 + k) * nh + h : dt,
                   k < Q ? 4 : 0);
  issue(0, W, true);
  if (nN > 1) issue(1, W + STAGE, true); else cp_async_commit();

  // scores C.B^T: pair (i, j <= i) of rows ty + 16 i, columns tx + 16 j
  float acc[36];
#pragma unroll
  for (int t = 0; t < 36; ++t) acc[t] = 0.f;
  for (int s = 0; s < nN; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    const float* cs = W + (s & 1) * STAGE;
    const float* bs = cs + QT * CS;
#pragma unroll 1
    for (int n4 = 0; n4 < NC; n4 += 4) {
      float4 cv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * CS + n4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * CS + n4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i >= j)
            acc[i * (i + 1) / 2 + j] = dot4(cv[i], bv, acc[i * (i + 1) / 2 + j]);
      }
    }
    __syncthreads();
    if (s + 2 < nN) issue(s + 2, W + (s & 1) * STAGE, true);
    else cp_async_commit();
  }
  cp_async_wait<0>();

  // x to float32 in place (its values read before any is written)
  constexpr int V = QT * PT / 4 / THREADS;
  Vec4<T> xv[V];
  if (sizeof(T) == 2) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      xv[v] = *reinterpret_cast<const Vec4<T>*>(xraw + 4 * (tid + v * THREADS));
  }
  if (warp == 0) {
    // cum: lane l sums tokens 4l .. 4l + 3, then a scan over the lanes
    const float a = A[h];
    float part[4], run = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float d = __fmul_rn(dts[4 * lane + r], a);
      run = r == 0 ? d : __fadd_rn(run, d);
      part[r] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = __fadd_rn(o, incl);
    }
    const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cum[4 * lane + r] = lane == 0 ? part[r] : __fadd_rn(excl, part[r]);
  }
  __syncthreads();
  if (sizeof(T) == 2) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      *reinterpret_cast<float4*>(xs + 4 * (tid + v * THREADS)) = to_f4(xv[v]);
  }
  for (int k = tid; k < QT; k += THREADS) {
    dec[k] = k < Q ? expf(cum[k]) : 0.f;
    con[k] = k < Q ? __fmul_rn(dts[k], expf(__fsub_rn(cum[Q - 1], cum[k])))
                   : 0.f;
  }

  // M[q][k] = (C[q].B[k]) exp(cum[q] - cum[k]) dt[k] for k <= q, else 0
  float* Ms = W;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = ty + 16 * i;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const int k = tx + 16 * j;
      float m = 0.f;
      if (k <= q && q < Q)
        m = __fmul_rn(__fmul_rn(acc[i * (i + 1) / 2 + j],
                                expf(__fsub_rn(cum[q], cum[k]))), dts[k]);
      Ms[q * MS + k] = m;
    }
  }
  __syncthreads();

  // y_intra = M x: rows ty + 16 i, columns 4 tx .. 4 tx + 3; the blocks
  // of 16 k above row block i are zero and skipped
  float yi[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) yi[i][r] = 0.f;
#pragma unroll
  for (int kb = 0; kb < 8; ++kb) {
    if (16 * kb >= Q) break;
#pragma unroll 2
    for (int k = 16 * kb; k < 16 * kb + 16; k += 4) {
      float4 xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xs + (k + r) * PT + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < kb) continue;
        const float4 a =
            *reinterpret_cast<const float4*>(Ms + (ty + 16 * i) * MS + k);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = yi[i][r];
          v = __fmaf_rn(a.x, comp(xv[0], r), v);
          v = __fmaf_rn(a.y, comp(xv[1], r), v);
          v = __fmaf_rn(a.z, comp(xv[2], r), v);
          yi[i][r] = __fmaf_rn(a.w, comp(xv[3], r), v);
        }
      }
    }
  }
  __syncthreads();

  // the chunk's state term st[n][p] = sum_k (B[k][n] contrib[k]) x[k][p]:
  // n = 4 ty + a and 64 + 4 ty + a (a < 4), p = 4 tx .. 4 tx + 3
  float* Bs = W;                                    // (QT, NT), then scaled
  for (int t = tid; t < QT * (NT / 4); t += THREADS) {
    const int q = t / (NT / 4), n = (t % (NT / 4)) * 4;
    const bool v = q < Q && n < N;
    cp_async16(Bs + q * NT + n, Bg + (v ? q * rs + n : 0), v ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int t = tid; t < QT * NT; t += THREADS)
    Bs[t] = __fmul_rn(Bs[t], con[t / NT]);
  __syncthreads();
  float st[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[a][r] = 0.f;
#pragma unroll 2
  for (int k = 0; k < Q; ++k) {
    float4 b0 = *reinterpret_cast<const float4*>(Bs + k * NT + 4 * ty);
    float4 b1 = *reinterpret_cast<const float4*>(Bs + k * NT + 64 + 4 * ty);
    float4 xv = *reinterpret_cast<const float4*>(xs + k * PT + 4 * tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        st[a][r] = __fmaf_rn(comp(b0, a), comp(xv, r), st[a][r]);
        st[4 + a][r] = __fmaf_rn(comp(b1, a), comp(xv, r), st[4 + a][r]);
      }
  }
  __syncthreads();

  // y_inter's first C stages load while the chunk waits for its state
  float* Ss = W;                                    // (NT, PT) S_in[n][p]
  float* Cst = W + NT * PT;                         // two C stages
  issue(0, Cst, false);
  if (nN > 1) issue(1, Cst + QT * CS, false); else cp_async_commit();

  const bool last = c == nc - 1;
  float* slot = slots + (size_t)bh * N * P;        // S_in[n][p]
  if (c > 0) {
    // a lost predecessor would hang the card: after seconds of polling
    // the kernel traps, and the launch's error reaches the caller
    if (tid == 0)
      for (long it = 0; ld_acquire(flags + bh) != c; ++it) {
        if (it > (1L << 24)) __trap();
        __nanosleep(32);
      }
    __syncthreads();
  }
  const float dl = expf(cum[Q - 1]);
  const int p0 = 4 * tx;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int n = a < 4 ? 4 * ty + a : 64 + 4 * ty + (a - 4);
    const bool v = n < N && p0 < P;
    float4 sin = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c > 0 && v)
      sin = __ldcg(reinterpret_cast<const float4*>(slot + (size_t)n * P + p0));
    *reinterpret_cast<float4*>(Ss + n * PT + p0) = sin;
    if (!v) continue;
    float4 so;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      comp(so, r) = __fadd_rn(__fmul_rn(comp(sin, r), dl), st[a][r]);
    if (!last) {
      *reinterpret_cast<float4*>(slot + (size_t)n * P + p0) = so;
    } else {
      float* out = state_out + (size_t)bh * P * N;
#pragma unroll
      for (int r = 0; r < 4; ++r) out[(size_t)(p0 + r) * N + n] = comp(so, r);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    if (!last) st_release(flags + bh, c + 1);
    else if (c > 0) atomicExch(flags + bh, 0);     // ready for the next call
  }

  // y_inter = (C exp(cum)) S_in, in the 32-column stages
  float yo[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) yo[i][r] = 0.f;
  for (int s = 0; s < nN; ++s) {
    cp_async_wait<1>();
    __syncthreads();
    float* cs = Cst + (s & 1) * QT * CS;
    for (int t = tid; t < QT * NC; t += THREADS) {
      const int q = t / NC, n = t % NC;
      cs[q * CS + n] = __fmul_rn(cs[q * CS + n], dec[q]);
    }
    __syncthreads();
#pragma unroll 2
    for (int n4 = 0; n4 < NC; n4 += 4) {
      float4 sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        sv[r] = *reinterpret_cast<const float4*>(Ss + (s * NC + n4 + r) * PT + p0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * CS + n4);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = yo[i][r];
          v = __fmaf_rn(a.x, comp(sv[0], r), v);
          v = __fmaf_rn(a.y, comp(sv[1], r), v);
          v = __fmaf_rn(a.z, comp(sv[2], r), v);
          yo[i][r] = __fmaf_rn(a.w, comp(sv[3], r), v);
        }
      }
    }
    __syncthreads();
    if (s + 2 < nN) issue(s + 2, cs, false); else cp_async_commit();
  }
  cp_async_wait<0>();

  if (p0 < P) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = ty + 16 * i;
      if (q >= Q) continue;
      T* out = y + ((tok0 + q) * nh + h) * P + p0;
#pragma unroll
      for (int r = 0; r < 4; ++r) out[r] = from_f<T>(__fadd_rn(yi[i][r], yo[i][r]));
    }
  }
}

template <typename T>
int launch(const void* xh, const float* Bm, const float* Cm, const float* dt,
           const float* A, int Bsz, int S, int nh, int P, int G, int N, int Q,
           void* y, float* state, float* slots, int* flags, int* counter,
           cudaStream_t st) {
  auto kern = ssd_scan_chunks<T>;
  // once per device: the shared memory of two CTAs per SM
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  const int grid = Bsz * nh * (S / Q);
  kern<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const T*>(xh), Bm, Cm, dt, A, Bsz, S, nh, P, G, N, Q,
      static_cast<T*>(y), state, slots, flags, counter);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of the kernel, in bytes (any shape it takes).
size_t rt_ssd_scan_smem() { return SMEM_BYTES; }

// xh (B, S, nh, P) and y in one dtype (0 float32, 1 bfloat16); Bm/Cm
// (B, S, G, N) 16-byte aligned, dt (B, S, nh), A (nh,) and the final
// state (B, nh, P, N) float32. Q <= 128, P <= 64, N <= 128, P and N
// multiples of 4, S % Q == 0, nh % G == 0. Scratch: slots (B nh N P)
// float32, flags (B nh) and counter (1) int32, zero before the first
// call and left zero by every call. One kernel on `stream`; returns the
// cudaError_t (0 = success).
int rt_ssd_scan(const void* xh, const float* Bm, const float* Cm,
                const float* dt, const float* A, int Bsz, int S, int nh,
                int P, int G, int N, int Q, int dtype, void* y, float* state,
                float* slots, int* flags, int* counter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Bsz < 1 || Q < 1 || Q > QT || S % Q || G < 1 || nh % G || P < 4 ||
      P > PT || P % 4 || N < 4 || N > NT || N % 4)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(xh, Bm, Cm, dt, A, Bsz, S, nh, P, G, N, Q, y, state,
                         slots, flags, counter, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xh, Bm, Cm, dt, A, Bsz, S, nh, P, G, N, Q, y,
                                 state, slots, flags, counter, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
