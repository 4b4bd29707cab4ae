// Fused training BatchNorm + residual + activation for Hopper (sm_90a).
//
// Replaces the five Pallas kernels of paddle_tpu/ops/fused_bn_act.py:
//   K5 bn_stats_kernel       <- _stats_kernel       (per-channel sum, sum of squares)
//   K6 bn_apply_kernel       <- _apply_kernel       (act(x*a + b [+ r | + r*ar + br]))
//   K7 bn_bwd_reduce_kernel  <- _bwd_reduce_kernel  (sum gz, sum gz*xhat [, sum gz*rhat])
//   K8 bn_bwd_dx_kernel      <- _bwd_dx_kernel      (dx = A*gz + B + Cc*x, dres)
//   K9 bn_pool_ring_kernel   <- _pool_apply_kernel  (pool(act(x*a + b)), a row ring;
//      bn_pool_apply_kernel                          per output, for rows too large)
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
//   - K9 reads each input byte from device memory once (a band's one
//     halo row aside): a block streams the input rows of a band of output
//     rows of an image (one NHWC row is W*C contiguous elements,
//     14,336 bytes at the ResNet stem) through a ring of row slots in
//     shared memory by 1-D bulk copies on mbarriers, several rows ahead,
//     turns each row into act(x*a + b) once, in place, and pools every
//     output row from the slots: a thread owns a 16-byte channel group of
//     an output column, the 3x3 window unrolled.  (The window route, a
//     thread per output reading its window from device memory, fetches
//     each element 2.25 times at the stem, recomputes the affine each time
//     and issues its nine loads one after another.)  Borders come from
//     index tests, never from the copies: padding is applied after the
//     activation (-inf for max, left out of the count for avg, which sums
//     the window row by row like the plain version), as the reference's
//     _pool_windows does.  The slots hold act(x*a + b) rounded to x's
//     type: the max of rounded values is the rounded max (bit-equal to the
//     plain version).  An average would sum those rounded values, so a
//     bf16 average takes the window route, which sums in f32 and rounds
//     once, as the reference does; so do rows the ring cannot hold.
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

// ---------------------------------------------------------- K9, ring route
// One block owns a band of `band` output rows of one image at a time (a
// persistent grid walks the (image, band) items).  The band's input rows,
// each W*C contiguous elements of the NHWC input, stream through a ring of
// `ring` row slots in shared memory: thread 0 issues one 1-D bulk copy per
// row (cp.async.bulk on the slot's mbarrier), up to `ring` rows ahead of
// the rows the block still reads, across item boundaries.  Each row is
// turned into act(x*a + b) once, in place, when the first output row that
// needs it comes up, and every output row is pooled from the slots.  The
// ring must hold kh + max(kh, sh) rows (the wrapper checks): then every row
// the block waits for was issued at the previous output row's barrier, and
// the rows it writes never share a slot with the rows being pooled.  Rows
// whose address or size is not a multiple of 16 bytes are read by the
// threads themselves (element loads), with the same ring and loop.
constexpr int kPoolThreads = 256;  // threads of a ring block, two per SM
// the ring's mbarriers (8 bytes each), before the rows: a multiple of 128
// bytes
__host__ __device__ constexpr int ring_bar_bytes(int ring) {
  return (8 * ring + 127) / 128 * 128;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// generic-proxy accesses to shared memory ordered before later bulk
// copies into it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// n = Vec<T>::n values of shared memory as f32, one 16-byte load when
// `vec`, else `valid` scalar loads
template <typename T>
__device__ __forceinline__ void load_smem(const T* p, float* out, bool vec,
                                          int valid) {
  constexpr int V = Vec<T>::n;
  if (vec) {
    alignas(16) T e[V];
    *reinterpret_cast<int4*>(e) = *reinterpret_cast<const int4*>(p);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = to_f(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = j < valid ? to_f(p[j]) : 0.f;
  }
}

// 8 bf16 maxima at once (four bf16x2 max instructions), NaN passing as
// in the f32 comparison
__device__ __forceinline__ void max8(uint4& acc, const uint4& v) {
  __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(&acc);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = __hmax2_nan(a[j], b[j]);
}

// K = 3: a 3x3 window, unrolled; K = 0: kh x kw from the arguments
template <typename T, int A, int KIND, int K>
__global__ void __launch_bounds__(kPoolThreads, 2)
bn_pool_ring_kernel(const T* __restrict__ x, const float* __restrict__ coef,
                    T* __restrict__ y, int N, int H, int W, int C, int Ho,
                    int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                    int ring, int slot_elems, int band, bool tma, bool vec) {
  constexpr int V = Vec<T>::n;
  constexpr int KK = K != 0 ? K : 1;  // the unrolled window's side
  // bf16 max over 16-byte groups: packed maxima on the slots' values
  constexpr bool kPacked =
      KIND == kPoolMax && std::is_same<T, __nv_bfloat16>::value;
  if (K != 0) {
    kh = K;
    kw = K;
  }
  extern __shared__ __align__(128) unsigned char pool_smem[];
  auto* full = reinterpret_cast<unsigned long long*>(pool_smem);
  T* slots = reinterpret_cast<T*>(pool_smem + ring_bar_bytes(ring));
  float* ca = reinterpret_cast<float*>(slots + (size_t)ring * slot_elems);
  float* cb = ca + C;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int row_elems = W * C;
  const unsigned row_bytes = (unsigned)row_elems * (unsigned)sizeof(T);

  for (int c = tid; c < C; c += nthr) {
    ca[c] = __ldg(coef + c);
    cb[c] = __ldg(coef + C + c);
  }
  if (tma && tid == 0) {
    for (int r = 0; r < ring; ++r) mbar_init(full + r);
    mbar_init_fence();
  }
  __syncthreads();
  // where every 16-byte group a thread transforms has the same channels
  // (the block's stride is a multiple of C), their coefficients stay in
  // registers
  const bool fixed_c = tma && vec && (nthr * V) % C == 0;
  float ra[V], rb[V];
  if (fixed_c) {
    const int c0 = (tid * V) % C;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ra[j] = ca[c0 + j];
      rb[j] = cb[c0 + j];
    }
  }

  const int bands = (Ho + band - 1) / band;
  const int items = N * bands;
  // the input rows [lo, hi) of item `it`, image n, output rows [ho0, ho1)
  auto item_rows = [&](int it, int& n, int& ho0, int& ho1, int& lo,
                       int& hi) {
    n = it / bands;
    ho0 = (it - n * bands) * band;
    ho1 = min(Ho, ho0 + band);
    lo = max(0, ho0 * sh - ph);
    hi = min(H, (ho1 - 1) * sh - ph + kh);
  };

  // producer (thread 0): rows in this block's order, seq 0, 1, ... (a
  // block's rows number fewer than 2^31); seq g lives in slot g % ring
  int p_item = blockIdx.x, p_n = 0, p_row = 0, p_hi = 0;
  int issued = 0, p_slot = 0;
  if (tma && tid == 0 && p_item < items) {
    int a, b;
    item_rows(p_item, p_n, a, b, p_row, p_hi);
  }
  auto produce = [&](int limit) {
    while (issued < limit && p_item < items) {
      mbar_expect(full + p_slot, row_bytes);
      bulk_copy(slots + (size_t)p_slot * slot_elems,
                x + ((size_t)p_n * H + p_row) * row_elems, row_bytes,
                full + p_slot);
      ++issued;
      p_slot = p_slot + 1 == ring ? 0 : p_slot + 1;
      if (++p_row == p_hi) {
        p_item += gridDim.x;
        if (p_item < items) {
          int a, b;
          item_rows(p_item, p_n, a, b, p_row, p_hi);
        }
      }
    }
  };
  if (tma && tid == 0) produce(ring);

  // act(x*a + b) of one row, in its slot: 16-byte groups with the
  // coefficients in registers, else element by element (from global
  // memory where the row did not come by bulk copy)
  auto transform = [&](T* slot, const T* src) {
    if (fixed_c) {
#pragma unroll 4
      for (int e = tid * V; e < row_elems; e += nthr * V) {
        float v[V];
        load_smem(slot + e, v, true, V);
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = act_f<A>(affine(v[j], ra[j], rb[j]));
        store_group(slot + e, v, true, V);
      }
    } else {
      for (int e = tid; e < row_elems; e += nthr) {
        const int c = e % C;
        const float v = to_f(tma ? slot[e] : src[e]);
        slot[e] = from_f<T>(act_f<A>(affine(v, ca[c], cb[c])));
      }
    }
  };

  const int G = (C + V - 1) / V;
  // the pooling's (column, channel group) walk: idx = wo * G + g, stepping
  // by the block's threads
  const int g0 = tid % G, wo0 = tid / G, gstep = nthr % G, wstep = nthr / G;
  int seq0 = 0;   // seq of the current item's first row
  int slot0 = 0;  // its slot, seq0 % ring
  int rslot = 0;            // the slot of the next row to transform
  unsigned rphase = 0;      // and the parity of its barrier's phase
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int n, ho0, ho1, lo, hi;
    item_rows(it, n, ho0, ho1, lo, hi);
    int ready = lo;  // the next row of the image to transform
    for (int ho = ho0; ho < ho1; ++ho) {
      const int r0 = ho * sh - ph;
      const int rlo = max(r0, 0), rhi = min(r0 + kh, H);
      for (; ready < rhi; ++ready) {
        if (tma) mbar_wait(full + rslot, rphase);
        transform(slots + (size_t)rslot * slot_elems,
                  x + ((size_t)n * H + ready) * row_elems);
        if (++rslot == ring) {
          rslot = 0;
          rphase ^= 1;
        }
      }
      fence_proxy_async();
      // rows up to rhi are transformed; nothing reads rows below rlo again
      __syncthreads();
      if (tma && tid == 0) produce(seq0 + (rlo - lo) + ring);

      // the slot of image row r: (slot0 + r - lo) % ring
      auto slot_of = [&](int r) {
        const int s = slot0 + (r - lo) % ring;
        return slots + (size_t)(s >= ring ? s - ring : s) * slot_elems;
      };
      const T* rows[KK];
      if (K != 0) {
#pragma unroll
        for (int i = 0; i < KK; ++i) rows[i] = slot_of(rlo + i);
      }
      // f(pixel) for every in-bounds pixel of the window at columns
      // [w0, w0 + kw), row by row
      auto for_taps = [&](int w0, int wlo, int whi, auto&& f) {
        if (K != 0) {
#pragma unroll
          for (int i = 0; i < KK; ++i) {
            if (rlo + i >= rhi) break;
#pragma unroll
            for (int j = 0; j < KK; ++j)
              if (w0 + j >= wlo && w0 + j < whi) f(rows[i] + (w0 + j) * C);
          }
        } else {
          for (int r = rlo; r < rhi; ++r) {
            const T* row = slot_of(r);
            for (int w = wlo; w < whi; ++w) f(row + w * C);
          }
        }
      };
      T* yrow = y + ((size_t)n * Ho + ho) * Wo * C;
      int wn = wo0, gi = g0;
      for (int idx = tid; idx < Wo * G; idx += nthr) {
        const int wo = wn, c0 = gi * V;
        wn += wstep;
        gi += gstep;
        if (gi >= G) {
          gi -= G;
          ++wn;
        }
        const int w0 = wo * sw - pw;
        const int wlo = max(w0, 0), whi = min(w0 + kw, W);
        if (kPacked && vec) {
          uint4 m = make_uint4(0xFF80FF80u, 0xFF80FF80u, 0xFF80FF80u,
                               0xFF80FF80u);  // -inf
          for_taps(w0, wlo, whi, [&](const T* px) {
            max8(m, *reinterpret_cast<const uint4*>(px + c0));
          });
          *reinterpret_cast<uint4*>(yrow + (size_t)wo * C + c0) = m;
          continue;
        }
        const int valid = min(V, C - c0);
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = KIND == kPoolMax ? -__int_as_float(0x7f800000) : 0.f;
        for_taps(w0, wlo, whi, [&](const T* px) {
          float v[V];
          load_smem(px + c0, v, vec, valid);
#pragma unroll
          for (int q = 0; q < V; ++q) {
            if (KIND == kPoolMax)
              acc[q] = (acc[q] != acc[q] || acc[q] > v[q]) ? acc[q] : v[q];
            else
              acc[q] += v[q];
          }
        });
        if (KIND == kPoolAvg) {
          const float cnt = (float)((rhi - rlo) * (whi - wlo));
#pragma unroll
          for (int q = 0; q < V; ++q) acc[q] /= cnt;
        }
        store_group(yrow + (size_t)wo * C + c0, acc, vec, valid);
      }
    }
    seq0 += hi - lo;
    slot0 = (slot0 + (hi - lo)) % ring;
  }
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

// the window route: one thread per output (n, ho, wo, channel group), for
// rows the ring cannot hold
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

// the ring kernel with its dynamic shared memory cap raised once to the
// most a block may take
// grid persistent blocks of kPoolThreads threads over the (image, band)
// items; `ring` slots of slot_elems elements (a row, rounded up to
// 128 bytes); tma: rows by bulk
// copy (x 16-byte aligned, W*C*sizeof(T) % 16 == 0); vec: 16-byte groups
// (C % (16 / sizeof(T)) == 0, y 16-byte aligned)
extern "C" int pdt_bn_pool_ring(const void* x, const void* coef, void* y,
                                int dtype, int act, int kind, int N, int H,
                                int W, int C, int Ho, int Wo, int kh, int kw,
                                int sh, int sw, int ph, int pw, int ring,
                                int slot_elems, int band, int grid,
                                int tma, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  by_dtype(dtype, [&](auto tp) {
    using T = std::remove_pointer_t<decltype(tp)>;
    const size_t smem = ring_bar_bytes(ring) +
                        (size_t)ring * slot_elems * sizeof(T) +
                        2 * sizeof(float) * C;
    by_act(act, [&](auto a) {
      auto launch = [&](auto k, auto w) {
        constexpr int A = decltype(a)::value;
        constexpr int KIND = decltype(k)::value;
        constexpr int K = decltype(w)::value;
        // the plan sized the ring from the card's shared memory
        err = cudaFuncSetAttribute(bn_pool_ring_kernel<T, A, KIND, K>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return;
        bn_pool_ring_kernel<T, A, KIND, K>
            <<<grid, kPoolThreads, smem, st>>>(
            static_cast<const T*>(x), static_cast<const float*>(coef),
            static_cast<T*>(y), N, H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw,
            ring, slot_elems, band, tma != 0, vec != 0);
      };
      const bool k3 = kh == 3 && kw == 3;
      if (kind == kPoolAvg) {
        if (k3) launch(IC<kPoolAvg>{}, IC<3>{});
        else launch(IC<kPoolAvg>{}, IC<0>{});
      } else {
        if (k3) launch(IC<kPoolMax>{}, IC<3>{});
        else launch(IC<kPoolMax>{}, IC<0>{});
      }
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
