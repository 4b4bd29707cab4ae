// Int8 weight-only dequant-matmul for Hopper (sm_90a): y = x @ (w_int8 * scale),
// split-K reduced inside a thread-block cluster.
//
// Replaces the Pallas kernel paddle_tpu/ops/int8_matmul.py::_kernel
// (driven by _pallas_matmul).  x (M, K) f32, bf16 or f16, w (K, N) int8
// row-major, scale (1, N) f32 per output channel; y (M, N) in x's type.
// As in the TPU kernel the products and sums are f32: a 16-bit x is
// converted at its point of use, and only y is rounded to x's type (an f16
// y past 65504 is inf, as the reference's astype gives).
//
// Bound: at decode M is the number of slots (<= 16), so the work is
// weight bytes: K*N int8 (+ 4*N scale) over 3.35 TB/s, a few microseconds
// for one Linear, so launch, ramp and latency weigh as much as the stream.
// The design keeps the weight in int8 from device memory into registers
// and keeps everything else out of device memory:
//   - the grid is (splits, N / TN, M / MT) in clusters of (splits, 1, 1):
//     the blocks of a cluster share an MT x TN output tile and split K
//     into k_rows rows each.  128 threads = TN / 4 column threads (one
//     32-bit word, 4 int8 columns, each) x RG k-row groups;
//   - a thread walks its k-rows in chunks of 32 words (16 at MT 16, 8 at
//     MT 32) held in registers; the first two chunks are loaded at once and
//     each later one while the chunk before it is used.  At decode the plan
//     (TN 32, k_rows 512) gives every thread one full chunk: the whole
//     weight is in flight at once, in the fewest blocks;
//   - the launch allows programmatic dependent launch: a block is placed
//     and sets up while the kernel before it ends, then waits for it
//     (griddepcontrol.wait) before it reads anything, since that kernel
//     may have written x, w or scale, and before it writes y;
//   - x is staged once per block (up to 1024 k-rows at MT 8) in shared
//     memory as [m][k] in its own type, each of its rows by one bulk copy
//     (the TMA's one-dimensional form, on an mbarrier) where the row's
//     address and byte count are multiples of 16 (K and k_rows multiples
//     of 4 f32 or 8 16-bit elements), else by 4-byte cp.async (f32) or
//     2-byte loads (bf16, f16); the copies are issued after the wait for the
//     kernel before;
//   - dequantization is a byte permute and one subtraction: __byte_perm
//     puts the int8 with its sign bit flipped into the low byte of the
//     float 2^23 (0x4B000000), and subtracting 2^23 + 128 leaves the int8
//     value exactly.  The scale is applied once per output column after
//     the sum, y = (sum x * w_q) * s, not sum x * (w_q * s);
//   - the k-row groups are summed through shared memory in a fixed order
//     into the block's partial tile; after cluster.sync() the ranks add
//     the cluster's partials through distributed shared memory in rank
//     order (each rank writes a strided share of the tile) and a second
//     cluster.sync() keeps every rank's shared memory alive until then.
//     One kernel per call, no partial buffer, no atomics: bit-repeatable.
// Launches go on the caller's stream; the C entry returns the CUDA error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCluster = 8;

template <int MT> struct XTile {
  // most k-rows of x staged at once: 32 KB
  static constexpr int kRows = MT == 8 ? 1024 : MT == 16 ? 512 : 256;
  // weight words a thread holds per chunk (twice, for the next chunk)
  static constexpr int kWords = MT == 8 ? 32 : MT == 16 ? 16 : 8;
};

// elements of x in one 16-byte copy
template <typename T>
__host__ __device__ constexpr int x_vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// the stride of a staged x row: xrows rounded up to whole 16-byte chunks
template <typename T>
__host__ __device__ constexpr int x_stride(int xrows) {
  return (xrows + x_vec<T>() - 1) / x_vec<T>() * x_vec<T>();
}

// floats of shared memory: x rows, which the k-row groups' partial sums
// reuse, the partial tile, the x barrier
template <typename T>
__host__ __device__ constexpr int smem_floats(int MT, int TN, int xrows) {
  return (MT * x_stride<T>(xrows) * static_cast<int>(sizeof(T)) / 4 >
                  512 * MT
              ? MT * x_stride<T>(xrows) * static_cast<int>(sizeof(T)) / 4
              : 512 * MT) +
         MT * TN + 4;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_as(__half* p, float v) {
  *p = __float2half_rn(v);
}

// x rows that cannot go by bulk copy: 4-byte cp.async for f32, plain
// 2-byte loads for bf16 and f16 (their rows may start 2 bytes into a word)
__device__ __forceinline__ void stage_narrow(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 4);
}
__device__ __forceinline__ void stage_narrow(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src) {
  *dst = *src;
}
__device__ __forceinline__ void stage_narrow(__half* dst, const __half* src) {
  *dst = *src;
}

// A bulk asynchronous copy (the TMA's one-dimensional form) completing on
// an mbarrier in shared memory.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_u32(bar))
               : "memory");
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

__device__ __forceinline__ float dequant(unsigned u, int byte) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | byte)) -
         8388736.f;
}

// Programmatic dependent launch: nothing the kernel before this one wrote
// is visible until the wait.
__device__ __forceinline__ void wait_prior_grids() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

template <typename T, int MT, int TN>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_cluster(const T* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       T* __restrict__ y, int M, int K, int N,
                       int k_rows, int xrows) {
  constexpr int CT = TN / 4;          // column threads
  constexpr int RG = kThreads / CT;   // k-row groups
  constexpr int RPT = XTile<MT>::kWords;  // k-rows per thread and chunk
  constexpr int kChunk = RG * RPT;
  constexpr int XV = x_vec<T>();
  const int XR = x_stride<T>(xrows);
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);                 // [MT][XR]
  float* red = reinterpret_cast<float*>(smem4);        // [RG][MT][TN], after xs
  float* part =
      red + smem_floats<T>(MT, TN, xrows) - MT * TN - 4;  // [MT][TN]
  auto* xbar = reinterpret_cast<unsigned long long*>(part + MT * TN);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * TN;
  const int m0 = blockIdx.z * MT;
  const int tid = threadIdx.x;
  const int ct = tid % CT;
  const int rg = tid / CT;
  const int col = n0 + 4 * ct;
  const bool col_ok = col < N;  // N % 16 == 0: a word is all in or out
  const int k_begin = rank * k_rows;
  const int k_end = min(K, k_begin + k_rows);
  const int nch = (max(0, k_end - k_begin) + kChunk - 1) / kChunk;
  // x rows go by bulk copy where their addresses and sizes are whole
  // 16-byte chunks, else element by element
  const bool bulk = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    K % XV == 0 && k_rows % XV == 0;
  unsigned xphase = 0;
  if (tid == 0) mbar_init(xbar);
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  int wq[RPT], wn[RPT];
  auto fetch = [&](int c, int (&wv)[RPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int k = k_begin + c * kChunk + rg + i * RG;
      wv[i] = (col_ok && k < k_end)
                  ? __ldg(reinterpret_cast<const int*>(w + (size_t)k * N + col))
                  : 0;  // int8 zeros
    }
  };
  release_dependents();
  wait_prior_grids();  // x, w and scale may come from the kernel before
  if (nch > 0) fetch(0, wq);
  if (nch > 1) fetch(1, wn);

  int xb = k_begin;  // first k-row staged in xs
  for (int c = 0; c < nch; ++c) {
    const int kc = k_begin + c * kChunk;
    if (kc - xb >= xrows || c == 0) {
      xb = kc;
      const int xn = min(xrows, k_end - xb);
      __syncthreads();  // the previous rows are no longer read
      const int mrows = min(MT, M - m0);
      if (bulk) {
        if (tid == 0) {
          mbar_expect(xbar, mrows * xn * (int)sizeof(T));
          for (int m = 0; m < mrows; ++m)
            bulk_copy(xs + m * XR, x + (size_t)(m0 + m) * K + xb,
                      xn * (int)sizeof(T), xbar);
        }
        mbar_wait(xbar, xphase);
        xphase ^= 1;
      } else {
        for (int m = 0; m < mrows; ++m)
          for (int kk = tid; kk < xn; kk += kThreads)
            stage_narrow(xs + m * XR + kk,
                         x + (size_t)(m0 + m) * K + xb + kk);
        __pipeline_commit();
        __pipeline_wait_prior(0);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (kc + rg + i * RG >= k_end) continue;  // past this rank's rows
      const int kk = kc - xb + rg + i * RG;
      const unsigned u = static_cast<unsigned>(wq[i]) ^ 0x80808080u;
      const float w0 = dequant(u, 0), w1 = dequant(u, 1);
      const float w2 = dequant(u, 2), w3 = dequant(u, 3);
#pragma unroll
      for (int mm = 0; mm < MT / 4; ++mm) {
        const T* xr = xs + 4 * mm * XR + kk;  // rows m >= M: not stored
        const float xm[4] = {to_f(xr[0]), to_f(xr[XR]), to_f(xr[2 * XR]),
                             to_f(xr[3 * XR])};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* r = acc[4 * mm + a];
          r[0] = fmaf(xm[a], w0, r[0]);
          r[1] = fmaf(xm[a], w1, r[1]);
          r[2] = fmaf(xm[a], w2, r[2]);
          r[3] = fmaf(xm[a], w3, r[3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) wq[i] = wn[i];
    if (c + 2 < nch) fetch(c + 2, wn);
  }

  // the k-row groups, summed in rg order into the block's partial tile
  __syncthreads();  // red overwrites xs
  float* rr = red + (size_t)rg * MT * TN + 4 * ct;
#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(rr + m * TN) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int o = tid; o < MT * TN; o += kThreads) {
    float v = 0.f;
#pragma unroll 8
    for (int g = 0; g < RG; ++g) v += red[g * MT * TN + o];
    part[o] = v;
  }
  cluster.sync();

  for (int o = rank + ranks * tid; o < MT * TN; o += ranks * kThreads) {
    float pr[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)  // all in flight at once
      if (r < ranks) pr[r] = cluster.map_shared_rank(part, r)[o];
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < ranks) v += pr[r];
    const int m = o / TN;
    const int n = n0 + (o - m * TN);
    if (m0 + m < M && n < N)
      store_as(y + (size_t)(m0 + m) * N + n, v * __ldg(scale + n));
  }
  cluster.sync();  // no rank leaves while another reads its shared memory
}

template <typename T>
using Kernel = void (*)(const T*, const int8_t*, const float*, T*, int, int,
                        int, int, int);

// the kernel of an (MT, TN) plan with its dynamic shared memory cap raised
// once to the most it may use; nullptr for a plan it was not built for
template <typename T, int MT, int TN> Kernel<T> pick() {
  static cudaError_t err = cudaFuncSetAttribute(
      dequant_matmul_cluster<T, MT, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats<T>(MT, TN, XTile<MT>::kRows)));
  return err == cudaSuccess ? dequant_matmul_cluster<T, MT, TN> : nullptr;
}

// the (MT, TN) tiles a plan may pick: 32 columns at decode (MT 8, 16),
// 16 to 64 at prefill (MT 32)
template <typename T>
Kernel<T> kernel_for(int mt, int tn) {
  if (mt == 8 && tn == 32) return pick<T, 8, 32>();
  if (mt == 16 && tn == 32) return pick<T, 16, 32>();
  if (mt == 32 && tn == 16) return pick<T, 32, 16>();
  if (mt == 32 && tn == 32) return pick<T, 32, 32>();
  if (mt == 32 && tn == 64) return pick<T, 32, 64>();
  return nullptr;
}

int x_rows(int mt, int k_rows) {
  const int cap = mt == 8 ? XTile<8>::kRows
                          : mt == 16 ? XTile<16>::kRows : XTile<32>::kRows;
  return k_rows < cap ? k_rows : cap;
}

template <typename T>
cudaLaunchConfig_t config(int M, int N, int mt, int tn, int splits,
                          int xrows, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + tn - 1) / tn, (M + mt - 1) / mt);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats<T>(mt, tn, xrows);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* y, int M,
           int K, int N, int mt, int tn, int splits, int k_rows,
           void* stream) {
  Kernel<T> kern = kernel_for<T>(mt, tn);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int xrows = x_rows(mt, k_rows);
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config<T>(M, N, mt, tn, splits, xrows, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(y), M, K, N, k_rows,
      xrows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plan: (mt, tn) one of kernel_for's tiles, `splits` blocks per cluster
// (<= 8) of k_rows rows of K each.  dtype: x's and y's type, 0 float32,
// 1 bfloat16, 2 float16.
extern "C" int pdt_int8_matmul(const void* x, const void* w,
                               const void* scale, void* y, int dtype, int M,
                               int K, int N, int mt, int tn, int splits,
                               int k_rows, void* stream) {
  auto* f = dtype == 2   ? launch<__half>
            : dtype == 1 ? launch<__nv_bfloat16>
            : dtype == 0 ? launch<float>
                         : nullptr;
  if (f == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return f(x, w, scale, y, M, K, N, mt, tn, splits, k_rows, stream);
}
