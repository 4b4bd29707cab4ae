// Int8 weight-only dequant-matmul for Hopper (sm_90a): y = x @ (w_int8 * scale).
//
// Replaces the Pallas kernel paddle_tpu/ops/int8_matmul.py::_kernel
// (driven by _pallas_matmul).  x (M, K) f32, w (K, N) int8 row-major,
// scale (1, N) f32 per output channel; y (M, N) f32.
//
// Bound: at decode M is the number of slots (<= 16), so the work is
// weight bytes: K*N int8 (+ 4*N scale) over 3.35 TB/s.  The design keeps
// the weight in int8 all the way from device memory into registers:
//   - a block owns a 128-column tile, an 8-row tile of x and one chunk of
//     K (split-K, so that even N = 1024 gives the card a few hundred
//     blocks); 128 threads = 8 column groups x 16 row groups;
//   - each thread reads 16 consecutive int8 weights of one k-row with one
//     16-byte load (eight threads cover a 128-byte row segment), converts
//     them to f32 and multiplies by its 16 scales in registers, then
//     accumulates x[m, k] * w for the 8 rows of the tile in f32;
//   - the 16 row groups are summed with warp shuffles and one pass
//     through shared memory, and each split writes an f32 partial;
//   - a second small kernel sums the partials over splits into y.
// Launches go on the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 16;                      // one int4 of int8
constexpr int kColGroups = 8;                           // threads per k-row
constexpr int kTileN = kColGroups * kColsPerThread;     // 128 columns
constexpr int kRowGroups = kThreads / kColGroups;       // 16 k-rows per pass
constexpr int kTileM = 8;
constexpr int kWarps = kThreads / 32;

// signed byte i (0..3) of a 32-bit word, as float
__device__ __forceinline__ float sbyte(int v, int i) {
  return static_cast<float>((v << (24 - 8 * i)) >> 24);
}

__global__ void __launch_bounds__(kThreads)
dequant_matmul_partial(const float* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       float* __restrict__ part,
                       int M, int K, int N, int k_chunk) {
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * kTileM;
  const int split = blockIdx.z;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = tid / kColGroups;
  const int col = n0 + cg * kColsPerThread;
  // N % 16 == 0 (checked by the wrapper): a column group is all in or out
  const bool col_ok = col < N;

  float acc[kTileM][kColsPerThread];
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[m][j] = 0.f;

  if (col_ok) {
    float s[kColsPerThread];
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) s[j] = __ldg(scale + col + j);
    for (int k = k_begin + rg; k < k_end; k += kRowGroups) {
      const int4 packed =
          __ldg(reinterpret_cast<const int4*>(w + (size_t)k * N + col));
      const int words[4] = {packed.x, packed.y, packed.z, packed.w};
      float wf[kColsPerThread];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        wf[j] = sbyte(words[j / 4], j % 4) * s[j];
#pragma unroll
      for (int m = 0; m < kTileM; ++m) {
        if (m0 + m < M) {
          const float xv = __ldg(x + (size_t)(m0 + m) * K + k);
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[m][j] = fmaf(xv, wf[j], acc[m][j]);
        }
      }
    }
  }

  // lanes of one warp hold 4 row groups (lane bits 3 and 4): fold them
#pragma unroll
  for (int m = 0; m < kTileM; ++m)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }

  __shared__ float red[kWarps][kTileM][kTileN];
  const int warp = tid / 32;
  const int lane = tid % 32;
  if (lane < kColGroups) {
#pragma unroll
    for (int m = 0; m < kTileM; ++m)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        red[warp][m][lane * kColsPerThread + j] = acc[m][j];
  }
  __syncthreads();

  // thread tid owns column n0 + tid of the tile
  const int n = n0 + tid;
  if (n < N) {
    for (int m = 0; m < kTileM && m0 + m < M; ++m) {
      float v = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) v += red[wi][m][tid];
      part[((size_t)split * M + m0 + m) * N + n] = v;
    }
  }
}

__global__ void dequant_matmul_reduce(const float* __restrict__ part,
                                      float* __restrict__ y,
                                      long long mn, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[(size_t)s * mn + i];
  y[i] = v;
}

}  // namespace

extern "C" int pdt_int8_matmul_f32(const void* x, const void* w,
                                   const void* scale, void* y, void* part,
                                   int M, int K, int N, int k_chunk,
                                   int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kTileN - 1) / kTileN, (M + kTileM - 1) / kTileM, splits);
  dequant_matmul_partial<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(part), M, K, N,
      k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mn = (long long)M * N;
  const int threads = 256;
  dequant_matmul_reduce<<<(unsigned)((mn + threads - 1) / threads), threads,
                          0, st>>>(static_cast<const float*>(part),
                                   static_cast<float*>(y), mn, splits);
  return static_cast<int>(cudaGetLastError());
}
