// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel paddle_tpu/ops/paged_attention.py::_kernel
// (driven by _pallas_paged_attention).  One decode query per slot against
// the block pool:
//   q (S, H, D) f32; kpool, vpool (num_blocks, block_size, H, D) f32;
//   tables (S, max_blocks) int32 block ids; pos (S,) int32, the slot's
//   write position (rows > pos are masked); out (S, H, D) f32.
//
// Bound: bytes of live K/V, sum over slots of (pos + 1) * H * D * 2 * 4 B,
// over 3.35 TB/s; the arithmetic is ~1 FMA per byte.  The TPU kernel
// walks the table in a sequential grid carrying (m, l, acc) in scratch;
// here blocks run in parallel, so:
//   - one thread block per (slot, head); a loop inside it walks the
//     slot's table, and only the blocks that hold rows <= pos are read;
//   - its 4 warps take every 4th table block, so a slot's sequence is
//     read by 4 warps at once (the head dimension of a slot, H * D = 1024
//     floats at GPT-2 medium, is split across thread blocks);
//   - the block loads its own table entries and clamps each id into
//     [0, num_blocks - 1], the same contract as the gather's mode="clip";
//   - a warp stages its (block_size, D) K and V tiles for one head in
//     shared memory with 16-byte loads, then runs the online softmax row
//     by row with the running max, denominator and accumulator in f32
//     registers (lane holds D / 32 output dims);
//   - the 4 warps' partial (m, l, acc) are merged through shared memory;
//     a warp that saw no rows has m = -inf and weighs 0, the guard the
//     TPU kernel applies to all-masked blocks.
// Launches go on the caller's stream; the C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxDPerLane = 8;  // D <= 256

__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ kpool,
                       const float* __restrict__ vpool,
                       const int* __restrict__ tables,
                       const int* __restrict__ pos,
                       float* __restrict__ out,
                       int H, int D, int num_blocks, int block_size,
                       int max_blocks, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int slot = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int dpl = D / 32;
  const int tile = block_size * D;
  float* kt = smem + (size_t)warp * 2 * tile;
  float* vt = kt + tile;

  const float* qrow = q + ((size_t)slot * H + h) * D;
  float qv[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i)
    qv[i] = (i < dpl) ? qrow[lane + 32 * i] : 0.f;

  const int rows = min(pos[slot] + 1, max_blocks * block_size);
  const int nblk = (rows + block_size - 1) / block_size;
  const int* table = tables + (size_t)slot * max_blocks;
  const int row_f4 = D / 4;
  const int tile_f4 = block_size * row_f4;
  const float4* k4 = reinterpret_cast<const float4*>(kpool);
  const float4* v4 = reinterpret_cast<const float4*>(vpool);
  float4* kt4 = reinterpret_cast<float4*>(kt);
  float4* vt4 = reinterpret_cast<float4*>(vt);

  float m = -INFINITY, l = 0.f;
  float acc[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) acc[i] = 0.f;

  for (int b = warp; b < nblk; b += kWarps) {
    const int id = min(max(table[b], 0), num_blocks - 1);
    for (int e = lane; e < tile_f4; e += 32) {
      const int r = e / row_f4;
      const int c = e - r * row_f4;
      const size_t off =
          (((size_t)id * block_size + r) * H + h) * row_f4 + c;
      kt4[e] = __ldg(k4 + off);
      vt4[e] = __ldg(v4 + off);
    }
    __syncwarp();
    const int r_end = min(block_size, rows - b * block_size);
    for (int r = 0; r < r_end; ++r) {
      const float* krow = kt + r * D;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i)
        if (i < dpl) part = fmaf(qv[i], krow[lane + 32 * i], part);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      const float s = part * scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 while m is still -inf
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const float* vrow = vt + r * D;
#pragma unroll
      for (int i = 0; i < kMaxDPerLane; ++i)
        if (i < dpl) acc[i] = fmaf(p, vrow[lane + 32 * i], acc[i] * alpha);
      m = m_new;
    }
    __syncwarp();
  }

  // merge the warps' partial softmax states
  float* cm = smem + (size_t)kWarps * 2 * tile;
  float* cl = cm + kWarps;
  float* cacc = cl + kWarps;
  if (lane == 0) {
    cm[warp] = m;
    cl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i)
    if (i < dpl) cacc[warp * D + lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;
  float mx = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, cm[w]);
  float denom = 0.f;
  float o[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) o[i] = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float wt = (cm[w] == -INFINITY) ? 0.f : expf(cm[w] - mx);
    denom += cl[w] * wt;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i)
      if (i < dpl) o[i] += cacc[w * D + lane + 32 * i] * wt;
  }
  denom = fmaxf(denom, 1e-30f);
  float* orow = out + ((size_t)slot * H + h) * D;
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i)
    if (i < dpl) orow[lane + 32 * i] = o[i] / denom;
}

}  // namespace

extern "C" int pdt_paged_attention_f32(const void* q, const void* kpool,
                                       const void* vpool, const void* tables,
                                       const void* pos, void* out, int S,
                                       int H, int D, int num_blocks,
                                       int block_size, int max_blocks,
                                       float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) *
      ((size_t)kWarps * 2 * block_size * D + 2 * kWarps + (size_t)kWarps * D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(S, H);
  paged_attention_kernel<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(kpool),
      static_cast<const float*>(vpool), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<float*>(out), H, D,
      num_blocks, block_size, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}
