// GQA single-token decode attention (flash-decoding) on Hopper: one
// launch, the merge kept on chip in a thread-block cluster.
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
// serving shape (B = 8, K = 2, d = 128, bf16, ~540 valid slots) 4.5 MB,
// 1.3 us at 3.35 TB/s. chip_smoke.py computes the bound per shape. At
// such sizes what costs is latency: launches, dependent loads and the
// merge's serial tail.
//
// What the design does about it. The TPU kernel walks the cache in order
// on one core, carrying (m, l, acc) across grid steps; here that would be
// B * K CTAs for 132 SMs. So the cache of each (batch row, kv head) is
// cut into S "pieces" of whole 64-slot tiles, one CTA each, and the S
// CTAs form one thread-block cluster (kernels/decode_attention.py
// `pieces` chooses S <= 8 and the tiles per piece from the shape alone):
//   * A CTA stages the g query heads in shared memory and streams its
//     tiles through a ring of shared-memory buffers with 16-byte
//     cp.async, K tiles first, then V tiles, several in flight. A tile
//     whose slots are all invalid is neither loaded nor computed; an
//     invalid slot of a loaded tile is zero-filled, never read.
//   * Score pass: thread (slot, head group) forms the dots of all the
//     group's heads against the staged k row, 16 bytes at a time, as
//     eight partial sums per head (one per element of the 16-byte
//     chunk) added in order at the end; no shuffle reductions. Scores
//     stay in shared memory for the whole piece, so one softmax pass per
//     piece gives its max m, p = exp(s - m) (0 for invalid slots),
//     l = sum p and p rounded to the cache dtype.
//   * PV pass: thread (head, 8 columns[, slot group]) sums p * v over the
//     staged v rows, reading 16 bytes of v at a time, the p and v of
//     PV_U slots loaded before their products.
//   * At these sizes the two passes are latency-bound, one or two CTAs
//     to an SM: the heads a thread scores (GH) and the PV pairs it sums
//     (PPT) are template constants, so both loops unroll without
//     branches and the independent chains overlap.
//   * A piece longer than the score buffer (long caches) is walked in
//     segments of U tiles, each with its own softmax, folded in order into
//     a running (m, l, acc): M' = max(M, m), L = L e^(M-M') + l e^(m-M'),
//     A likewise. At the serving shape a piece is one segment.
//   * Merge: each CTA leaves (m, l, acc) in its shared memory; after
//     cluster.sync() every rank merges a slice of the outputs, reading
//     the other ranks' values through distributed shared memory
//     (M = max m, L = sum l e^(m-M), A = sum acc e^(m-M), out =
//     A / max(L, 1e-30)), then a second cluster.sync() keeps each CTA's
//     shared memory alive until the others have read it. On request
//     the merge also writes each head's (M, L), so a caller can merge
//     the outputs of caches held apart (the tensor-parallel plan's
//     share of the slots a rank).
// The wrapper allocates `out` (and those stats) only: no scratch in
// device memory.
//
// Arithmetic. Products and sums are IEEE-rounded one at a time
// (--fmad=false and the _rn intrinsics); only the summation order differs
// from the plain version's einsums, which spell the same pieces,
// segments and merges. expf is the accurate one (no fast math).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;        // cache slots per tile (kernels/decode_attention.py)
constexpr int HG = THREADS / TILE;   // head groups of the score pass
constexpr int MAX_G = 32;
constexpr int MAX_D = 256;
constexpr int MAX_PIECES = 8;   // the portable cluster size
constexpr int PV_U = 4;         // slots whose p and v the PV pass loads ahead
constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

// shared-memory ring depth: 4 tiles of bf16 (17 KB each at d = 128),
// 2 of float32
template <typename T>
__host__ __device__ constexpr int nbuf() { return sizeof(T) == 2 ? 4 : 2; }

__host__ __device__ inline int al16(int x) { return (x + 15) & ~15; }

// Byte offsets of the dynamic shared memory.
struct Layout {
  int acc, st, sc, meta, ring, total;
};

__host__ __device__ inline Layout layout(int g, int d, int U, int isz,
                                         int n_buf) {
  Layout L;
  int o = al16(g * d * isz);               // q (g, d) in the cache dtype
  L.acc = o;                               // the piece's acc (g, d) f32
  o = al16(o + g * d * 4);
  L.st = o;                                // M, L running; m, l segment
  o = al16(o + 4 * g * 4);
  L.sc = o;                                // scores / p (g, U * TILE) f32
  o = al16(o + g * U * TILE * 4);
  L.meta = o;                              // valid (U * TILE), tiles (U), nt
  o = al16(o + (U * TILE + U + 1) * 4);
  L.ring = o;                              // tile ring, then the PV partials
  const int P = g * (d / 8), SG = P >= THREADS ? 1 : THREADS / P;
  const int red = SG * P * 8 * 4, ring = n_buf * TILE * (d * isz + 16);
  L.total = o + (red > ring ? red : ring);
  return L;
}

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

// eight consecutive elements from shared memory, as float32
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 zero-fills
// without reading global memory
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

// Grid (S, K, B) with clusters of (S, 1, 1): blockIdx.x is the piece.
// Piece s covers tiles [s * n_per, min((s + 1) * n_per, n_tiles)),
// walked in segments of U tiles. GH = ceil(g / HG) heads a thread scores
// and PPT = ceil(g d / 8 / THREADS) PV pairs a thread sums are compile-time,
// so both loops unroll without branches.
template <typename T, int GH, int PPT>
__global__ void __launch_bounds__(THREADS)
decode_attention_cluster(const T* __restrict__ q, const T* __restrict__ kc,
                         const T* __restrict__ vc,
                         const int* __restrict__ cpos, int H, int K, int C,
                         int d, int n_per, int U, int pos, int window,
                         float scale, T* __restrict__ out,
                         float* __restrict__ stats) {
  constexpr int NBUF = nbuf<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = H / K, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (C + TILE - 1) / TILE;
  const int t_begin = s * n_per, t_end = min(n_tiles, t_begin + n_per);
  const int RS = d * (int)sizeof(T) + 16;  // padded row: no bank conflicts
  const int CH = d * (int)sizeof(T) / 16;  // 16-byte chunks per row
  const int CG = d / 8, P = g * CG;        // PV pairs (head, 8 columns)
  const int SG = P >= THREADS ? 1 : THREADS / P;
  const int UL = U * TILE;
  const Layout Ly = layout(g, d, U, (int)sizeof(T), NBUF);
  T* qs = reinterpret_cast<T*>(smem);
  float* acc_s = reinterpret_cast<float*>(smem + Ly.acc);
  float* st = reinterpret_cast<float*>(smem + Ly.st);
  float* ps = reinterpret_cast<float*>(smem + Ly.sc);
  int* valid = reinterpret_cast<int*>(smem + Ly.meta);
  int* tl = valid + UL;
  int* nt_s = tl + U;
  unsigned char* ring = smem + Ly.ring;
  float* red = reinterpret_cast<float*>(smem + Ly.ring);

  // the g query heads, asynchronously: the first tile's wait covers them
  const T* qrow = q + ((size_t)b * H + (size_t)kh * g) * d;
  for (int i = tid; i < g * CH; i += THREADS)
    cp_async16(reinterpret_cast<unsigned char*>(qs) + i * 16,
               qrow + i * (16 / (int)sizeof(T)), 16);
  cp_async_commit();
  for (int h = tid; h < g; h += THREADS) {
    st[h] = NEG_INF;
    st[g + h] = 0.f;
  }

  // PV ownership: pairs tid, tid + THREADS, ... (SG == 1), or pair
  // tid % P over the slots r with r % SG == tid / P
  const int my_sg = SG > 1 ? tid / P : 0;
  const bool pv_on = tid < SG * P;
  float A[PPT][8];
#pragma unroll
  for (int r = 0; r < PPT; ++r)
#pragma unroll
    for (int x = 0; x < 8; ++x) A[r][x] = 0.f;

  for (int u0 = t_begin; u0 < t_end; u0 += U) {
    const int nu = min(U, t_end - u0);
    __syncthreads();                     // the last segment is done
    for (int c = tid; c < UL; c += THREADS) {
      const int cc = u0 * TILE + c;
      bool v = false;
      if (c < nu * TILE && cc < C) {
        const int cp = cpos[cc];
        v = cp >= 0 && cp <= pos && (window <= 0 || cp > pos - window);
      }
      valid[c] = v;
    }
    __syncthreads();
    for (int u = warp; u < nu; u += THREADS / 32) {
      const int any = __any_sync(0xffffffffu, valid[u * TILE + lane] |
                                                  valid[u * TILE + 32 + lane]);
      if (lane == 0) tl[u] = any;
    }
    __syncthreads();
    if (tid == 0) {                      // compact: the non-empty tiles
      int n = 0;
      for (int u = 0; u < nu; ++u)
        if (tl[u]) tl[n++] = u;
      *nt_s = n;
    }
    __syncthreads();
    const int nt = *nt_s, n_items = 2 * nt;

    float a[PPT][8];
#pragma unroll
    for (int r = 0; r < PPT; ++r)
#pragma unroll
      for (int x = 0; x < 8; ++x) a[r][x] = 0.f;

    // item i < nt: K tile tl[i]; item i >= nt: V tile tl[i - nt]
    auto issue = [&](int i) {
      if (i < n_items) {
        const T* base = i < nt ? kc : vc;
        const int u = tl[i < nt ? i : i - nt];
        unsigned char* buf = ring + (i % NBUF) * TILE * RS;
        for (int x = tid; x < TILE * CH; x += THREADS) {
          const int r = x / CH, ch = x % CH, c = u * TILE + r;
          const bool v = valid[c];
          const T* src = v ? base + (((size_t)b * C + u0 * TILE + c) * K + kh) * d
                                 + ch * (16 / (int)sizeof(T))
                           : base;
          cp_async16(buf + r * RS + ch * 16, src, v ? 16 : 0);
        }
      }
      cp_async_commit();
    };
    for (int i = 0; i < NBUF; ++i) issue(i);

    for (int i = 0; i < n_items; ++i) {
      cp_async_wait<NBUF - 1>();
      __syncthreads();
      if (i == nt) {
        // the segment's softmax, one warp per head
        for (int h = warp; h < g; h += THREADS / 32) {
          float mx = NEG_INF;
          for (int c = lane; c < nu * TILE; c += 32)
            if (valid[c]) mx = fmaxf(mx, ps[h * UL + c]);
          mx = warp_max(mx);
          float l = 0.f;
          for (int c = lane; c < nu * TILE; c += 32) {
            const float p = valid[c] ? expf(__fsub_rn(ps[h * UL + c], mx))
                                     : 0.f;
            l = __fadd_rn(l, p);
            ps[h * UL + c] = to_f(from_f<T>(p));
          }
          l = warp_sum(l);
          if (lane == 0) {
            st[2 * g + h] = mx;
            st[3 * g + h] = l;
          }
        }
        __syncthreads();
      }
      const unsigned char* buf = ring + (i % NBUF) * TILE * RS;
      if (i < nt) {
        // scores of the tile's slots for this thread's GH heads, the k
        // chunk loaded once for all of them; a head past g repeats head
        // g - 1 (clamped, no branch) and is not stored
        const int r = tid % TILE, hg = tid / TILE, c = tl[i] * TILE + r;
        if (valid[c]) {
          const T* krow = reinterpret_cast<const T*>(buf + r * RS);
          // eight partial sums per head, one per place in the 16-byte
          // chunk, added in order at the end: eight independent chains
          float acc[GH][8];
#pragma unroll
          for (int j = 0; j < GH; ++j)
#pragma unroll
            for (int x = 0; x < 8; ++x) acc[j][x] = 0.f;
          for (int e = 0; e < d; e += 8) {
            float kv[8];
            load8(krow + e, kv);
#pragma unroll
            for (int j = 0; j < GH; ++j) {
              float qv[8];
              load8(qs + min(hg + HG * j, g - 1) * d + e, qv);  // broadcast
#pragma unroll
              for (int x = 0; x < 8; ++x)
                acc[j][x] = __fadd_rn(acc[j][x], __fmul_rn(qv[x], kv[x]));
            }
          }
#pragma unroll
          for (int j = 0; j < GH; ++j) {
            const int h = hg + HG * j;
            float dot = acc[j][0];
#pragma unroll
            for (int x = 1; x < 8; ++x) dot = __fadd_rn(dot, acc[j][x]);
            if (h < g) ps[h * UL + c] = __fmul_rn(dot, scale);
          }
        }
      } else if (pv_on) {
        // acc[h][cols] += p[h][c] * v[c][cols] over this thread's slots,
        // PV_U slots' p and v loaded before their products; an invalid
        // slot has p = 0 and a zero-filled row, so it adds 0
        const int u = tl[i - nt];
#pragma unroll
        for (int r = 0; r < PPT; ++r) {
          const int pair = SG > 1 ? tid % P : tid + r * THREADS;
          if (pair < P) {
            const int h = pair / CG, col = (pair % CG) * 8;
            const float* ph = ps + h * UL + u * TILE;
            for (int r0 = my_sg; r0 < TILE; r0 += SG * PV_U) {
              float p[PV_U], vv[PV_U][8];
#pragma unroll
              for (int w = 0; w < PV_U; ++w) {
                const int rr = min(r0 + SG * w, TILE - 1);
                p[w] = r0 + SG * w < TILE ? ph[rr] : 0.f;
                load8(reinterpret_cast<const T*>(buf + rr * RS) + col, vv[w]);
              }
#pragma unroll
              for (int w = 0; w < PV_U; ++w)
#pragma unroll
                for (int x = 0; x < 8; ++x)
                  a[r][x] = __fadd_rn(a[r][x], __fmul_rn(p[w], vv[w][x]));
            }
          }
        }
      }
      __syncthreads();
      issue(i + NBUF);
    }
    cp_async_wait<0>();
    if (nt == 0) {
      for (int h = tid; h < g; h += THREADS) {
        st[2 * g + h] = NEG_INF;
        st[3 * g + h] = 0.f;
      }
    }
    __syncthreads();
    // fold the segment into the running (M, L, A)
    if (pv_on) {
#pragma unroll
      for (int r = 0; r < PPT; ++r) {
        const int pair = SG > 1 ? tid % P : tid + r * THREADS;
        if (pair < P) {
          const int h = pair / CG;
          const float M = st[h], m = st[2 * g + h], M2 = fmaxf(M, m);
          const float al = expf(__fsub_rn(M, M2)), be = expf(__fsub_rn(m, M2));
#pragma unroll
          for (int x = 0; x < 8; ++x)
            A[r][x] = __fadd_rn(__fmul_rn(A[r][x], al), __fmul_rn(a[r][x], be));
        }
      }
    }
    __syncthreads();
    for (int h = tid; h < g; h += THREADS) {
      const float M = st[h], m = st[2 * g + h], M2 = fmaxf(M, m);
      const float al = expf(__fsub_rn(M, M2)), be = expf(__fsub_rn(m, M2));
      st[g + h] = __fadd_rn(__fmul_rn(st[g + h], al),
                            __fmul_rn(st[3 * g + h], be));
      st[h] = M2;
    }
  }

  // the piece's acc (g, d), summing the slot groups
  __syncthreads();
  if (SG > 1) {
    if (pv_on) {
#pragma unroll
      for (int x = 0; x < 8; ++x) red[(my_sg * P + tid % P) * 8 + x] = A[0][x];
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += THREADS) {
      const int h = i / d, j = i % d, pair = h * CG + j / 8;
      float sum = 0.f;
      for (int sg = 0; sg < SG; ++sg)
        sum = __fadd_rn(sum, red[(sg * P + pair) * 8 + j % 8]);
      acc_s[i] = sum;
    }
  } else {
#pragma unroll
    for (int r = 0; r < PPT; ++r) {
      const int pair = tid + r * THREADS;
      if (pair < P) {
        const int h = pair / CG, col = (pair % CG) * 8;
#pragma unroll
        for (int x = 0; x < 8; ++x) acc_s[h * d + col + x] = A[r][x];
      }
    }
  }

  // merge the cluster's pieces through distributed shared memory
  cluster.sync();
  for (int i = s * THREADS + tid; i < g * d; i += S * THREADS) {
    const int h = i / d;
    float m[MAX_PIECES], l[MAX_PIECES], a[MAX_PIECES];
#pragma unroll
    for (int r = 0; r < MAX_PIECES; ++r)   // all remote loads in flight
      if (r < S) {
        const float* rst = cluster.map_shared_rank(st, r);
        m[r] = rst[h];
        l[r] = rst[g + h];
        a[r] = cluster.map_shared_rank(acc_s, r)[i];
      }
    float M = NEG_INF;
#pragma unroll
    for (int r = 0; r < MAX_PIECES; ++r)
      if (r < S) M = fmaxf(M, m[r]);
    float L = 0.f, Acc = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_PIECES; ++r)
      if (r < S) {
        const float w = expf(__fsub_rn(m[r], M));
        L = __fadd_rn(L, __fmul_rn(l[r], w));
        Acc = __fadd_rn(Acc, __fmul_rn(a[r], w));
      }
    out[((size_t)b * H + (size_t)kh * g + h) * d + (i % d)] =
        from_f<T>(__fdiv_rn(Acc, fmaxf(L, 1e-30f)));
    if (stats != nullptr && i % d == 0) {  // the head's (M, L), on request
      float* sp = stats + ((size_t)b * H + (size_t)kh * g + h) * 2;
      sp[0] = M;
      sp[1] = L;
    }
  }
  cluster.sync();                        // the others have read this CTA
}

template <typename T, int GH, int PPT>
int launch(const void* q, const void* kc, const void* vc, const int* cpos,
           int B, int H, int K, int C, int d, int S, int n_per, int U,
           int pos, int window, float scale, void* out, float* stats,
           cudaStream_t st) {
  const int g = H / K;
  const Layout Ly = layout(g, d, U, (int)sizeof(T), nbuf<T>());
  auto kern = decode_attention_cluster<T, GH, PPT>;
  // once per device: allow any dynamic shared memory a layout can take
  static bool raised[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    int optin = 0;
    cudaFuncAttributes fa;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, K, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Ly.total;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), cpos, H, K, C, d, n_per, U, pos, window,
      scale, static_cast<T*>(out), stats);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation for g query heads of width d: heads a thread scores
// (1, 2, 4 or 8) and PV pairs a thread sums (1 or up to 4).
template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const int* cpos,
             int B, int H, int K, int C, int d, int S, int n_per, int U,
             int pos, int window, float scale, void* out, float* stats,
             cudaStream_t st) {
  const int g = H / K, gh = (g + HG - 1) / HG;
  const bool one_pair = g * (d / 8) <= THREADS;
#define RT_LAUNCH(GH, PPT)                                                 \
  return launch<T, GH, PPT>(q, kc, vc, cpos, B, H, K, C, d, S, n_per, U,  \
                            pos, window, scale, out, stats, st)
  if (gh <= 1) { if (one_pair) RT_LAUNCH(1, 1); RT_LAUNCH(1, 4); }
  if (gh <= 2) { if (one_pair) RT_LAUNCH(2, 1); RT_LAUNCH(2, 4); }
  if (gh <= 4) { if (one_pair) RT_LAUNCH(4, 1); RT_LAUNCH(4, 4); }
  if (one_pair) RT_LAUNCH(8, 1);
  RT_LAUNCH(8, 4);
#undef RT_LAUNCH
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA, in bytes (dtype 0 float32, 1 bf16).
int rt_decode_attention_smem(int g, int d, int U, int dtype) {
  return dtype == 1 ? layout(g, d, U, 2, nbuf<__nv_bfloat16>()).total
                    : layout(g, d, U, 4, nbuf<float>()).total;
}

// q (B, H, d), caches (B, C, K, d) and out (B, H, d) in one dtype
// (0 float32, 1 bfloat16), 16-byte aligned; cpos (C,) int32. S pieces of
// n_per 64-slot tiles (S = ceil(n_tiles / n_per) <= 8), segments of
// U <= n_per tiles. H % K == 0, H/K <= 32, d % 8 == 0, d <= 256. stats,
// null or float32 (B, H, 2), takes each head's running max of the scaled
// scores and the sum of exp(s - max) over the valid slots (-1e30 and 0
// where none is valid), for a caller that merges several caches' outputs.
// One launch on `stream`; returns the cudaError_t (0 = success).
int rt_decode_attention(const void* q, const void* kc, const void* vc,
                        const int* cpos, int B, int H, int K, int C, int d,
                        int S, int n_per, int U, int pos, int window,
                        int dtype, float scale, void* out, void* stats,
                        void* stream) {
  float* sp = static_cast<float*>(stats);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (C + TILE - 1) / TILE;
  if (K < 1 || H % K || H / K > MAX_G || d > MAX_D || d % 8 || n_per < 1 ||
      S < 1 || S > MAX_PIECES || S != (n_tiles + n_per - 1) / n_per ||
      U < 1 || U > n_per)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, kc, vc, cpos, B, H, K, C, d, S, n_per, U, pos,
                           window, scale, out, sp, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kc, vc, cpos, B, H, K, C, d, S, n_per,
                                   U, pos, window, scale, out, sp, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
