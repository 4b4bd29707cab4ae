// Fused training BatchNorm + residual + activation for Hopper (sm_90a).
//
// Replaces the five Pallas kernels of paddle_tpu/ops/fused_bn_act.py:
//   K5 bn_stats_kernel       <- _stats_kernel       (per-channel sum, sum of squares)
//   K6 bn_apply_kernel       <- _apply_kernel       (act(x*a + b [+ r | + r*ar + br]))
//   K7 bn_bwd_reduce_kernel  <- _bwd_reduce_kernel  (sum gz, sum gz*xhat [, sum gz*rhat])
//   K8 bn_bwd_dx_kernel      <- _bwd_dx_kernel      (dx = A*gz + B + Cc*x, dres)
//   K9 bn_pool_apply_kernel  <- _pool_apply_kernel  (pool(act(x*a + b)), per output)
//
// Data is the channels-last (M, C) = (N*H*W, C) view of an activation,
// row-major, f32 or bf16; per-channel vectors come in the reference's
// (8, C) f32 `coef` layout: rows a, b, mean, invstd, A, B, Cc, 0.  The
// dual form (a BatchNorm on the residual too) takes a second coef.
//
// Bound: all five are bound by bytes.  Each reads its inputs once and
// writes its outputs once (K5: x; K6: x [, r] -> y; K7: g, x [, r];
// K8: g, x [, r] -> dx [, dres]; K9: x -> the pooled y), at 3.35 TB/s.
// The design keeps every pass to that traffic:
//   - one 2-D tiling for K5-K8: a block of 256 threads owns a tile of
//     channels and a chunk of rows; neighbouring threads walk neighbouring
//     channel groups of one row with 16-byte loads (8 bf16 or 4 f32), so
//     a warp reads whole 128-byte segments, and the per-channel
//     coefficients sit in registers for the whole chunk;
//   - no sequential grid on Hopper: the column sums of K5 and K7 are
//     written per (chunk, channel) as f32 partials into scratch the
//     wrapper allocates, and bn_sum_partials adds them in a fixed order,
//     a warp per output (no atomics: results are bit-equal from run to
//     run);
//   - the wrapper picks the chunking from M and C so that both the stem
//     (M = 3.2 M rows, C = 64) and layer4 (M = 12,544, C = 2048) give the
//     card about a thousand blocks;
//   - K7/K8 recompute the pre-activation z and its mask from x (and r)
//     instead of reading a saved tensor, as the reference does;
//   - K9 does not hold an image in shared memory (a stem image is 1.6 MB):
//     one thread per output (n, ho, wo, channel group) reads its window
//     of x, applies the affine and the activation on the fly, and the
//     L1/L2 caches serve the overlap of neighbouring windows.  Padding is
//     applied after the activation (-inf for max, left out of the count
//     for avg), as the reference's _pool_windows does.
// Ragged edges (any M, any C) are masked in the kernels; 16-byte loads are
// used when C is a multiple of the vector width and every pointer is
// 16-byte aligned (the wrapper checks), scalar loads otherwise.
// Launches go on the caller's stream; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

enum { kActNone = 0, kActRelu = 1, kActRelu6 = 2 };
enum { kResNone = 0, kResPlain = 1, kResDual = 2 };
enum { kPoolMax = 0, kPoolAvg = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// values of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// n = Vec<T>::n values at p as f32: one 16-byte load when `vec`, else
// `valid` scalar loads (the rest 0)
template <typename T>
__device__ __forceinline__ void load_group(const T* __restrict__ p,
                                           float* out, bool vec,
                                           int valid) {
  constexpr int V = Vec<T>::n;
  if (vec) {
    alignas(16) T e[V];
    *reinterpret_cast<int4*>(e) = __ldg(reinterpret_cast<const int4*>(p));
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = j < valid ? to_f(p[j]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_group(T* __restrict__ p,
                                            const float* v, bool vec,
                                            int valid) {
  constexpr int V = Vec<T>::n;
  if (vec) {
    alignas(16) T e[V];
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = from_f<T>(v[j]);
    *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(e);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (j < valid) p[j] = from_f<T>(v[j]);
  }
}

// `valid` entries of row `row` of an (8, C) f32 coef, the rest 0
template <int V>
__device__ __forceinline__ void load_coef(const float* __restrict__ coef,
                                          int row, int C, int c0, int valid,
                                          float* out) {
#pragma unroll
  for (int j = 0; j < V; ++j)
    out[j] = j < valid ? __ldg(coef + (size_t)row * C + c0 + j) : 0.f;
}

// the activation as the TPU kernel's jnp.maximum / jnp.clip: NaN passes
template <int A>
__device__ __forceinline__ float act_f(float z) {
  if (A == kActRelu) return z < 0.f ? 0.f : z;
  if (A == kActRelu6) return z < 0.f ? 0.f : (z > 6.f ? 6.f : z);
  return z;
}

// x*a + b rounded after the product and after the sum, as the plain
// PyTorch version computes it (no fused multiply-add): kernel and plain
// version then agree bit for bit on z, and so on the activation's mask
__device__ __forceinline__ float affine(float x, float a, float b) {
  return __fadd_rn(__fmul_rn(x, a), b);
}

// where the activation passes its gradient
template <int A>
__device__ __forceinline__ bool act_pass(float z) {
  if (A == kActRelu) return z > 0.f;
  if (A == kActRelu6) return z > 0.f && z < 6.f;
  return true;
}

// The 2-D tiling shared by K5-K8: thread (r, l) of a block owns channel
// group blockIdx.x * tpr + l and rows m0 + r, m0 + r + rows, ... of the
// block's chunk [m0, m0 + chunk_rows).
struct Tile {
  int l, r, c0, valid, m0, m1;
  bool active;
};

template <int V>
__device__ __forceinline__ Tile tile_of(int M, int C, int tpr,
                                        int chunk_rows) {
  Tile t;
  t.l = threadIdx.x % tpr;
  t.r = threadIdx.x / tpr;
  t.c0 = (blockIdx.x * tpr + t.l) * V;
  t.active = t.c0 < C;
  t.valid = t.active ? min(V, C - t.c0) : 0;
  t.m0 = blockIdx.y * chunk_rows;
  t.m1 = min(M, t.m0 + chunk_rows);
  return t;
}

// Sum NOUT * V per-thread accumulators over the block's rows in a fixed
// order and write the block's partial sums part[(chunk * NOUT + k) * C + c].
template <int NOUT, int V>
__device__ __forceinline__ void block_partials(float (&acc)[NOUT][V],
                                               float* __restrict__ part,
                                               int C, int tpr, int rows) {
  __shared__ float red[NOUT * kThreads * V];
#pragma unroll
  for (int k = 0; k < NOUT; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j)
      red[(k * kThreads + threadIdx.x) * V + j] = acc[k][j];
  __syncthreads();
  const int width = tpr * V;                  // channels of the tile
  const int cbase = blockIdx.x * width;
  for (int col = threadIdx.x; col < NOUT * width; col += kThreads) {
    const int k = col / width;
    const int q = col % width;
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[k * kThreads * V + r * width + q];
    if (cbase + q < C)
      part[((size_t)blockIdx.y * NOUT + k) * C + cbase + q] = s;
  }
}

// ---------------------------------------------------------------- K5
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int M,
                int C, int tpr, int rows, int chunk_rows, bool vec) {
  constexpr int V = Vec<T>::n;
  const Tile t = tile_of<V>(M, C, tpr, chunk_rows);
  float acc[2][V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (t.active) {
    for (int m = t.m0 + t.r; m < t.m1; m += rows) {
      float xv[V];
      load_group(x + (size_t)m * C + t.c0, xv, vec, t.valid);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[0][j] += xv[j];
        acc[1][j] = fmaf(xv[j], xv[j], acc[1][j]);
      }
    }
  }
  block_partials<2, V>(acc, part, C, tpr, rows);
}

// ---------------------------------------------------------------- K6
template <typename T, int A, int R>
__global__ void __launch_bounds__(kThreads)
bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                const T* __restrict__ res, const float* __restrict__ coefr,
                T* __restrict__ y, int M, int C, int tpr, int rows,
                int chunk_rows, bool vec) {
  constexpr int V = Vec<T>::n;
  const Tile t = tile_of<V>(M, C, tpr, chunk_rows);
  if (!t.active) return;
  float a[V], b[V], ar[V], br[V];
  load_coef<V>(coef, 0, C, t.c0, t.valid, a);
  load_coef<V>(coef, 1, C, t.c0, t.valid, b);
  if (R == kResDual) {
    load_coef<V>(coefr, 0, C, t.c0, t.valid, ar);
    load_coef<V>(coefr, 1, C, t.c0, t.valid, br);
  }
  for (int m = t.m0 + t.r; m < t.m1; m += rows) {
    const size_t off = (size_t)m * C + t.c0;
    float z[V];
    load_group(x + off, z, vec, t.valid);
#pragma unroll
    for (int j = 0; j < V; ++j) z[j] = affine(z[j], a[j], b[j]);
    if (R != kResNone) {
      float rv[V];
      load_group(res + off, rv, vec, t.valid);
#pragma unroll
      for (int j = 0; j < V; ++j)
        z[j] = __fadd_rn(z[j], R == kResDual ? affine(rv[j], ar[j], br[j])
                                             : rv[j]);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) z[j] = act_f<A>(z[j]);
    store_group(y + off, z, vec, t.valid);
  }
}

// ---------------------------------------------------------------- K7
template <typename T, int A, int R>
__global__ void __launch_bounds__(kThreads)
bn_bwd_reduce_kernel(const T* __restrict__ g, const T* __restrict__ x,
                     const float* __restrict__ coef,
                     const T* __restrict__ res,
                     const float* __restrict__ coefr,
                     float* __restrict__ part, int M, int C, int tpr,
                     int rows, int chunk_rows, bool vec) {
  constexpr int V = Vec<T>::n;
  constexpr int NOUT = R == kResDual ? 3 : 2;
  const Tile t = tile_of<V>(M, C, tpr, chunk_rows);
  float acc[NOUT][V];
#pragma unroll
  for (int k = 0; k < NOUT; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
  if (t.active) {
    float a[V], b[V], mean[V], inv[V];
    float ar[V], br[V], meanr[V], invr[V];
    load_coef<V>(coef, 0, C, t.c0, t.valid, a);
    load_coef<V>(coef, 1, C, t.c0, t.valid, b);
    load_coef<V>(coef, 2, C, t.c0, t.valid, mean);
    load_coef<V>(coef, 3, C, t.c0, t.valid, inv);
    if (R == kResDual) {
      load_coef<V>(coefr, 0, C, t.c0, t.valid, ar);
      load_coef<V>(coefr, 1, C, t.c0, t.valid, br);
      load_coef<V>(coefr, 2, C, t.c0, t.valid, meanr);
      load_coef<V>(coefr, 3, C, t.c0, t.valid, invr);
    }
    for (int m = t.m0 + t.r; m < t.m1; m += rows) {
      const size_t off = (size_t)m * C + t.c0;
      float gz[V], xv[V], rv[V];
      load_group(g + off, gz, vec, t.valid);
      load_group(x + off, xv, vec, t.valid);
      if (R != kResNone) load_group(res + off, rv, vec, t.valid);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (A != kActNone) {
          float z = affine(xv[j], a[j], b[j]);
          if (R != kResNone)
            z = __fadd_rn(z, R == kResDual ? affine(rv[j], ar[j], br[j])
                                           : rv[j]);
          gz[j] = act_pass<A>(z) ? gz[j] : 0.f;
        }
        acc[0][j] += gz[j];
        acc[1][j] = fmaf(gz[j], __fmul_rn(__fsub_rn(xv[j], mean[j]), inv[j]),
                         acc[1][j]);
        if (R == kResDual)
          acc[NOUT - 1][j] =
              fmaf(gz[j], __fmul_rn(__fsub_rn(rv[j], meanr[j]), invr[j]),
                   acc[NOUT - 1][j]);
      }
    }
  }
  block_partials<NOUT, V>(acc, part, C, tpr, rows);
}

// ---------------------------------------------------------------- K8
template <typename T, int A, int R>
__global__ void __launch_bounds__(kThreads)
bn_bwd_dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
                 const float* __restrict__ coef, const T* __restrict__ res,
                 const float* __restrict__ coefr, T* __restrict__ dx,
                 T* __restrict__ dres, int M, int C, int tpr, int rows,
                 int chunk_rows, bool vec) {
  constexpr int V = Vec<T>::n;
  const Tile t = tile_of<V>(M, C, tpr, chunk_rows);
  if (!t.active) return;
  float a[V], b[V], cA[V], cB[V], cC[V];
  float ar[V], br[V], rA[V], rB[V], rC[V];
  load_coef<V>(coef, 0, C, t.c0, t.valid, a);
  load_coef<V>(coef, 1, C, t.c0, t.valid, b);
  load_coef<V>(coef, 4, C, t.c0, t.valid, cA);
  load_coef<V>(coef, 5, C, t.c0, t.valid, cB);
  load_coef<V>(coef, 6, C, t.c0, t.valid, cC);
  if (R == kResDual) {
    load_coef<V>(coefr, 0, C, t.c0, t.valid, ar);
    load_coef<V>(coefr, 1, C, t.c0, t.valid, br);
    load_coef<V>(coefr, 4, C, t.c0, t.valid, rA);
    load_coef<V>(coefr, 5, C, t.c0, t.valid, rB);
    load_coef<V>(coefr, 6, C, t.c0, t.valid, rC);
  }
  for (int m = t.m0 + t.r; m < t.m1; m += rows) {
    const size_t off = (size_t)m * C + t.c0;
    float gz[V], xv[V], rv[V], out[V];
    load_group(g + off, gz, vec, t.valid);
    load_group(x + off, xv, vec, t.valid);
    if (R != kResNone) load_group(res + off, rv, vec, t.valid);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (A != kActNone) {
        float z = affine(xv[j], a[j], b[j]);
        if (R != kResNone)
          z = __fadd_rn(z, R == kResDual ? affine(rv[j], ar[j], br[j])
                                         : rv[j]);
        gz[j] = act_pass<A>(z) ? gz[j] : 0.f;
      }
      out[j] = __fadd_rn(affine(cA[j], gz[j], cB[j]), __fmul_rn(cC[j], xv[j]));
    }
    store_group(dx + off, out, vec, t.valid);
    if (R != kResNone) {
      if (R == kResDual) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          out[j] = __fadd_rn(affine(rA[j], gz[j], rB[j]),
                             __fmul_rn(rC[j], rv[j]));
        store_group(dres + off, out, vec, t.valid);
      } else {
        store_group(dres + off, gz, vec, t.valid);
      }
    }
  }
}

// The column sums over chunks: out[k * C + c], one warp per output.  Lane
// l adds chunks l, l + 32, ... in order, then a fixed butterfly of
// shuffles adds the lanes, so the order, and the result, is the same on
// every run.
__global__ void bn_sum_partials(const float* __restrict__ part,
                                float* __restrict__ out, int chunks,
                                int nout, int C) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= nout * C) return;   // whole warps leave together
  const int k = i / C;
  const int c = i % C;
  float s = 0.f;
  for (int ch = lane; ch < chunks; ch += 32)
    s += part[((size_t)ch * nout + k) * C + c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[i] = s;
}

// ---------------------------------------------------------------- K9
template <typename T, int A, int KIND>
__global__ void __launch_bounds__(kThreads)
bn_pool_apply_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                     T* __restrict__ y, int N, int H, int W, int C, int Ho,
                     int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                     bool vec) {
  constexpr int V = Vec<T>::n;
  const int G = (C + V - 1) / V;
  const long long total = (long long)N * Ho * Wo * G;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int gi = (int)(idx % G);
  long long rest = idx / G;
  const int wo = (int)(rest % Wo);
  rest /= Wo;
  const int ho = (int)(rest % Ho);
  const int n = (int)(rest / Ho);
  const int c0 = gi * V;
  const int valid = min(V, C - c0);
  float a[V], b[V], acc[V];
  load_coef<V>(coef, 0, C, c0, valid, a);
  load_coef<V>(coef, 1, C, c0, valid, b);
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = KIND == kPoolMax ? -__int_as_float(0x7f800000) : 0.f;
  int count = 0;
  for (int i = 0; i < kh; ++i) {
    const int hi = ho * sh - ph + i;
    if (hi < 0 || hi >= H) continue;
    for (int jw = 0; jw < kw; ++jw) {
      const int wi = wo * sw - pw + jw;
      if (wi < 0 || wi >= W) continue;
      float v[V];
      load_group(x + (((size_t)n * H + hi) * W + wi) * C + c0, v, vec,
                 valid);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float z = act_f<A>(affine(v[j], a[j], b[j]));
        if (KIND == kPoolMax)
          acc[j] = (acc[j] != acc[j] || acc[j] > z) ? acc[j] : z;  // NaN passes
        else
          acc[j] += z;
      }
      ++count;
    }
  }
  if (KIND == kPoolAvg) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] /= (float)count;
  }
  store_group(y + (((size_t)n * Ho + ho) * Wo + wo) * C + c0, acc, vec,
              valid);
}

// ------------------------------------------------------------ dispatch
template <int I>
using IC = std::integral_constant<int, I>;

template <typename F>
void by_dtype(int dtype, F&& f) {
  if (dtype == 1)
    f(static_cast<__nv_bfloat16*>(nullptr));
  else
    f(static_cast<float*>(nullptr));
}

template <typename F>
void by_act(int act, F&& f) {
  if (act == kActRelu)
    f(IC<kActRelu>{});
  else if (act == kActRelu6)
    f(IC<kActRelu6>{});
  else
    f(IC<kActNone>{});
}

template <typename F>
void by_res(int res, F&& f) {
  if (res == kResPlain)
    f(IC<kResPlain>{});
  else if (res == kResDual)
    f(IC<kResDual>{});
  else
    f(IC<kResNone>{});
}

int sum_partials(const void* part, void* out, int chunks, int nout, int C,
                 cudaStream_t st) {
  const long long threads = 32LL * nout * C;
  bn_sum_partials<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads,
                    0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(out), chunks,
      nout, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grid = (c_tiles, chunks) of kThreads threads, for K5-K8
extern "C" int pdt_bn_stats(const void* x, void* part, void* out, int dtype,
                            int M, int C, int tpr, int rows, int c_tiles,
                            int chunks, int chunk_rows, int vec,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(c_tiles, chunks);
  by_dtype(dtype, [&](auto tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    bn_stats_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<float*>(part), M, C, tpr,
        rows, chunk_rows, vec != 0);
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(part, out, chunks, 2, C, st);
}

extern "C" int pdt_bn_apply(const void* x, const void* coef, const void* res,
                            const void* coefr, void* y, int dtype, int act,
                            int res_mode, int M, int C, int tpr, int rows,
                            int c_tiles, int chunks, int chunk_rows, int vec,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(c_tiles, chunks);
  by_dtype(dtype, [&](auto tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    by_act(act, [&](auto a) {
      by_res(res_mode, [&](auto r) {
        bn_apply_kernel<T, decltype(a)::value, decltype(r)::value>
            <<<grid, kThreads, 0, st>>>(
                static_cast<const T*>(x), static_cast<const float*>(coef),
                static_cast<const T*>(res), static_cast<const float*>(coefr),
                static_cast<T*>(y), M, C, tpr, rows, chunk_rows, vec != 0);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pdt_bn_bwd_reduce(const void* g, const void* x,
                                 const void* coef, const void* res,
                                 const void* coefr, void* part, void* out,
                                 int dtype, int act, int res_mode, int M,
                                 int C, int tpr, int rows, int c_tiles,
                                 int chunks, int chunk_rows, int vec,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(c_tiles, chunks);
  by_dtype(dtype, [&](auto tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    by_act(act, [&](auto a) {
      by_res(res_mode, [&](auto r) {
        bn_bwd_reduce_kernel<T, decltype(a)::value, decltype(r)::value>
            <<<grid, kThreads, 0, st>>>(
                static_cast<const T*>(g), static_cast<const T*>(x),
                static_cast<const float*>(coef), static_cast<const T*>(res),
                static_cast<const float*>(coefr), static_cast<float*>(part),
                M, C, tpr, rows, chunk_rows, vec != 0);
      });
    });
  });
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_partials(part, out, chunks, res_mode == kResDual ? 3 : 2, C, st);
}

extern "C" int pdt_bn_bwd_dx(const void* g, const void* x, const void* coef,
                             const void* res, const void* coefr, void* dx,
                             void* dres, int dtype, int act, int res_mode,
                             int M, int C, int tpr, int rows, int c_tiles,
                             int chunks, int chunk_rows, int vec,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(c_tiles, chunks);
  by_dtype(dtype, [&](auto tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    by_act(act, [&](auto a) {
      by_res(res_mode, [&](auto r) {
        bn_bwd_dx_kernel<T, decltype(a)::value, decltype(r)::value>
            <<<grid, kThreads, 0, st>>>(
                static_cast<const T*>(g), static_cast<const T*>(x),
                static_cast<const float*>(coef), static_cast<const T*>(res),
                static_cast<const float*>(coefr), static_cast<T*>(dx),
                static_cast<T*>(dres), M, C, tpr, rows, chunk_rows,
                vec != 0);
      });
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// one thread per output (n, ho, wo, channel group)
extern "C" int pdt_bn_pool_apply(const void* x, const void* coef, void* y,
                                 int dtype, int act, int kind, int N, int H,
                                 int W, int C, int Ho, int Wo, int kh, int kw,
                                 int sh, int sw, int ph, int pw, int vec,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  by_dtype(dtype, [&](auto tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    constexpr int V = Vec<T>::n;
    const long long total = (long long)N * Ho * Wo * ((C + V - 1) / V);
    const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
    by_act(act, [&](auto a) {
      auto launch = [&](auto k) {
        bn_pool_apply_kernel<T, decltype(a)::value, decltype(k)::value>
            <<<blocks, kThreads, 0, st>>>(
                static_cast<const T*>(x), static_cast<const float*>(coef),
                static_cast<T*>(y), N, H, W, C, Ho, Wo, kh, kw, sh, sw, ph,
                pw, vec != 0);
      };
      if (kind == kPoolAvg)
        launch(IC<kPoolAvg>{});
      else
        launch(IC<kPoolMax>{});
    });
  });
  return static_cast<int>(cudaGetLastError());
}
