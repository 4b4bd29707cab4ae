// Paged decode attention for Hopper (sm_90a), split-KV reduced inside a
// thread-block cluster.
//
// Replaces the Pallas kernel paddle_tpu/ops/paged_attention.py::_kernel
// (driven by _pallas_paged_attention).  One decode query per slot against
// the block pool:
//   q (S, H, D) f32 or bf16; kpool, vpool (num_blocks, block_size, H, D),
//   both f32 or both bf16 (independently of q); tables (S, max_blocks)
//   int32 block ids; pos (S,) int32, the slot's write position (rows >
//   pos are masked); out (S, H, D) in q's type.  As in the TPU kernel,
//   everything is computed in f32 and only the output is rounded.
//
// Bound: bytes of live K/V, sum over slots of (pos + 1) * H * D * 2 * E
// (E = 4 for f32 pools, 2 for bf16), over 3.35 TB/s; the arithmetic is
// ~1 FMA per element.  The TPU kernel walks
// the table in a sequential grid carrying (m, l, acc) in scratch.  Here the
// table is cut into splits that run in parallel (flash-decoding):
//   - the grid is (splits, H / hpb, S) in clusters of (splits, 1, 1): a
//     block owns one split of one slot's live rows for hpb adjacent heads,
//     whose rows are hpb*D contiguous elements of the pool.  The split count
//     comes from the table's width (reading pos on the host would sync);
//     the rows of a split, ceil(live / splits) of them, come from pos on
//     the device, so a short slot's rows are spread over all its blocks;
//   - the block stages tiles of tile_rows rows (8 KB of K and of V: 2048
//     f32 or 4096 bf16 elements, so a bf16 tile holds twice the rows) with
//     16-byte cp.async (4 or 8 elements) into a ring of two, so the next
//     tile is in flight while one is scored (a ring of three, or of four
//     4 KB tiles, lost on the card: fewer clusters fit at once).  It loads
//     its own table entries and clamps each id into [0, num_blocks - 1]
//     (the gather's mode="clip");
//   - q is staged once as f32: by 16-byte cp.async (f32) or 16-byte loads
//     converted on the way (bf16) where q is 16-byte aligned (D % 32 == 0:
//     then so is every head's row), else 4-byte cp.async (f32) or 2-byte
//     loads (bf16);
//   - scores: a group of G lanes per (row, head), G the power of two that
//     scores the whole tile in one pass (4 at D 64 in f32, 2 in bf16),
//     16-byte reads of K (converted to f32 in registers) and the matching
//     f32 q, rotated by the row so that the groups of one shared-memory
//     phase hit disjoint banks, a log2(G)-step shuffle sum; the scores go
//     through shared memory;
//   - softmax and P.V: a thread owns 4 output columns of one head and every
//     RP-th row of the tile; it takes the tile's max once, rescales its
//     (l, acc) once per tile, and accumulates p * V from shared memory.
//     Scores carry log2(e) / sqrt(D), and x - m is taken before exp2;
//   - the block's row groups are summed in a fixed order into its partial
//     (m, l, acc) in its own shared memory; after cluster.sync() rank 0
//     reads every rank's partial through distributed shared memory in rank
//     order and writes out = sum(acc * w) / max(sum(l * w), 1e-30) with
//     w = exp2(m - max m) (0 for an empty split, m = -inf); a second
//     cluster.sync() keeps every rank's shared memory alive until then.
//     One kernel, no global scratch, no atomics: bit-repeatable.
// Launches go on the caller's stream; the C entry returns the CUDA error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCluster = 8;
constexpr int kStages = 2;       // K / V ring depth
constexpr int kTileBytes = 8192; // one K (or V) tile
constexpr int kMaxW = 512;       // hpb * D: a P.V thread owns <= 4 columns

// elements of one tile, and of one 16-byte copy
template <typename T>
struct Tile {
  static constexpr int kElems = kTileBytes / static_cast<int>(sizeof(T));
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
};

// floats of shared memory: the ring of K and V tiles, the tile's scores,
// q, per-thread (acc, l, m), the partial (acc, m, l)
template <typename TKV>
__host__ __device__ constexpr int smem_floats(int W, int hpb) {
  return 2 * kStages * (kTileBytes / 4) + Tile<TKV>::kElems / 32 + W +
         6 * kThreads + W + 2 * hpb;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 4 consecutive elements of shared memory as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void dot4(float4 a, float4 b, float& d) {
  d = fmaf(a.x, b.x, d);
  d = fmaf(a.y, b.y, d);
  d = fmaf(a.z, b.z, d);
  d = fmaf(a.w, b.w, d);
}

// q's row of the block's heads into shared memory as f32.  f32: cp.async
// riding with the first tile's copies, 16 bytes at a time where q is
// 16-byte aligned (D % 32 == 0: then so is every head's row), else 4.
// bf16: loads converted on the way, 16 bytes at a time where aligned,
// else 2 (a bf16 q may start 2 bytes into a 4-byte word).
__device__ __forceinline__ void stage_q(float* qs, const float* q,
                                        const float* qrow, int W, int tid) {
  if (reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    if (tid < W / 4) __pipeline_memcpy_async(qs + 4 * tid, qrow + 4 * tid, 16);
  } else {
    for (int i = tid; i < W; i += kThreads)
      __pipeline_memcpy_async(qs + i, qrow + i, 4);
  }
}
__device__ __forceinline__ void stage_q(float* qs, const __nv_bfloat16* q,
                                        const __nv_bfloat16* qrow, int W,
                                        int tid) {
  if (reinterpret_cast<uintptr_t>(q) % 16 == 0) {
    for (int i = tid; i < W / 8; i += kThreads) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(qrow) + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
      float4* d = reinterpret_cast<float4*>(qs + 8 * i);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      const float2 c = __bfloat1622float2(h[2]), e = __bfloat1622float2(h[3]);
      d[0] = make_float4(a.x, a.y, b.x, b.y);
      d[1] = make_float4(c.x, c.y, e.x, e.y);
    }
  } else {
    for (int i = tid; i < W; i += kThreads) qs[i] = __bfloat162float(qrow[i]);
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
paged_attention_split(const TQ* __restrict__ q,
                      const TKV* __restrict__ kpool,
                      const TKV* __restrict__ vpool,
                      const int* __restrict__ tables,
                      const int* __restrict__ pos,
                      TQ* __restrict__ out, int H, int D, int num_blocks,
                      int block_size, int max_blocks, int hpb, int tile_rows,
                      float scale_log2) {
  constexpr int kTile = Tile<TKV>::kElems;
  constexpr int EV = Tile<TKV>::kVec;  // elements of one 16-byte copy
  constexpr int kLoads = kTile / EV / kThreads;  // copies per thread per tile
  constexpr int kOwn = kTile / 256;  // most rows a P.V thread owns per tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int h0 = blockIdx.y * hpb;
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int W = hpb * D;  // elements of one row of the block's heads
  const int W4 = W / 4;
  const int WV = W / EV;
  TKV* ks = reinterpret_cast<TKV*>(smem);
  TKV* vs = reinterpret_cast<TKV*>(smem + kStages * (kTileBytes / 4));
  float* ss = smem + 2 * kStages * (kTileBytes / 4);  // scores, head-major
  float* qs = ss + kTile / 32;
  float4* red = reinterpret_cast<float4*>(qs + W);
  float* lred = reinterpret_cast<float*>(red + kThreads);
  float* mred = lred + kThreads;
  float* pacc = mred + kThreads;  // the partial read by rank 0: acc, m, l
  float* pm = pacc + W;
  float* pl = pm + hpb;

  // the slot's live rows, cut evenly over the cluster's ranks
  const int live = max(0, min(pos[slot] + 1, max_blocks * block_size));
  const int per = (live + ranks - 1) / ranks;
  const int r_begin = rank * per;
  const int nrows = max(0, min(r_begin + per, live) - r_begin);
  const int ntiles = (nrows + tile_rows - 1) / tile_rows;
  const int* table = tables + (size_t)slot * max_blocks;

  auto load_tile = [&](int t) {
    const int row0 = r_begin + t * tile_rows;
    const int nv = min(tile_rows, nrows - t * tile_rows) * WV;
    TKV* kd = ks + (t % kStages) * kTile;
    TKV* vd = vs + (t % kStages) * kTile;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = tid + i * kThreads;
      if (e < nv) {
        const int r = e / WV;
        const int row = row0 + r;
        const int tb = row / block_size;
        const int id = min(max(__ldg(table + tb), 0), num_blocks - 1);
        const size_t off =
            (((size_t)id * block_size + (row - tb * block_size)) * H + h0) *
                D +
            (size_t)(e - r * WV) * EV;
        __pipeline_memcpy_async(kd + EV * e, kpool + off, 16);
        __pipeline_memcpy_async(vd + EV * e, vpool + off, 16);
      }
    }
  };

  // P.V ownership: 4 columns (c4) of head hh, rows rp, rp + RP, ...; each
  // thread keeps its own running max over its rows
  const int RP = kThreads / W4;
  const int c4 = tid % W4;
  const int rp = tid / W4;
  const bool pv = rp < RP;
  const int hh = (4 * c4) / D;
  // scores: G lanes per (head, row), the power of two that scores the
  // whole tile in one pass where it can; a lane takes nch 16-byte chunks
  // of the row, starting at a chunk rotated by the row so that the groups
  // of one shared-memory phase hit disjoint banks
  const int nsc = tile_rows * hpb;
  int G = 1;
  while (4 * G * nsc <= 2 * kThreads && (D / EV) % (2 * G) == 0 && G < 16)
    G *= 2;
  const int nch = D / EV / G;
  const int gl = tid % G;

  float m = -INFINITY, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  stage_q(qs, q, q + ((size_t)slot * H + h0) * D, W, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s);
    __pipeline_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();  // tile t landed for all; tile t - 1 fully consumed
    if (t + kStages - 1 < ntiles) load_tile(t + kStages - 1);
    __pipeline_commit();
    const TKV* kt = ks + (t % kStages) * kTile;
    const TKV* vt = vs + (t % kStages) * kTile;
    const int nv = min(tile_rows, nrows - t * tile_rows);

    // scores of (head sh, row sr), head-major: ss[sh * tile_rows + sr]
    for (int sc0 = 0; sc0 < nsc; sc0 += kThreads / G) {
      const int sc = sc0 + tid / G;
      const int sh = sc / tile_rows;
      const int sr = sc - sh * tile_rows;
      float d0 = 0.f, d1 = 0.f;
      if (sc < nsc && sr < nv) {
        const TKV* kr = kt + (sr * hpb + sh) * D;
        const float* qr = qs + sh * D;
        int j = sr % nch;
#pragma unroll 4
        for (int i = 0; i < nch; ++i) {
          const int c = EV * (gl + G * j);
          if constexpr (EV == 4) {
            dot4(load4(kr + c), load4(qr + c), (i & 1) ? d1 : d0);
          } else {
            dot4(load4(kr + c), load4(qr + c), d0);
            dot4(load4(kr + c + 4), load4(qr + c + 4), d1);
          }
          j = j + 1 == nch ? 0 : j + 1;
        }
      }
      float dot = d0 + d1;
      for (int o = G / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (gl == 0 && sc < nsc)
        ss[sc] = sr < nv ? dot * scale_log2 : -INFINITY;
    }
    __syncthreads();

    if (pv) {
      const float* sh = ss + hh * tile_rows;
      float sv[kOwn];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const int r = rp + RP * j;
        sv[j] = r < nv ? sh[r] : -INFINITY;
        mt = fmaxf(mt, sv[j]);
      }
      if (mt != -INFINITY) {  // the thread has a live row in this tile
        const float mn = fmaxf(m, mt);
        const float alpha = exp2f(m - mn);  // 0 while m is still -inf
        l *= alpha;
        acc.x *= alpha;
        acc.y *= alpha;
        acc.z *= alpha;
        acc.w *= alpha;
#pragma unroll
        for (int j = 0; j < kOwn; ++j) {
          const int r = rp + RP * j;
          if (r < nv) {
            const float p = exp2f(sv[j] - mn);
            const float4 v = load4(vt + r * W + 4 * c4);
            l += p;
            acc.x = fmaf(p, v.x, acc.x);
            acc.y = fmaf(p, v.y, acc.y);
            acc.z = fmaf(p, v.z, acc.z);
            acc.w = fmaf(p, v.w, acc.w);
          }
        }
        m = mn;
      }
    }
  }
  __pipeline_wait_prior(0);

  // the block's row groups, merged in rp order into its partial; a group
  // that saw no row has m = -inf and weighs 0
  red[tid] = acc;
  lred[tid] = l;
  mred[tid] = m;
  __syncthreads();
  if (tid < W4) {
    float mx = -INFINITY;
    for (int p = 0; p < RP; ++p) mx = fmaxf(mx, mred[p * W4 + tid]);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
    for (int p = 0; p < RP; ++p) {
      const float mp = mred[p * W4 + tid];
      const float w = mp == -INFINITY ? 0.f : exp2f(mp - mx);
      const float4 b = red[p * W4 + tid];
      a.x = fmaf(b.x, w, a.x);
      a.y = fmaf(b.y, w, a.y);
      a.z = fmaf(b.z, w, a.z);
      a.w = fmaf(b.w, w, a.w);
      ls = fmaf(lred[p * W4 + tid], w, ls);
    }
    reinterpret_cast<float4*>(pacc)[tid] = a;
    if ((4 * tid) % D == 0) {
      pm[hh] = mx;
      pl[hh] = ls;
    }
  }
  cluster.sync();

  if (rank == 0) {
    TQ* orow = out + ((size_t)slot * H + h0) * D;
    for (int o = tid; o < W; o += kThreads) {
      const int oh = o / D;
      float mr[kMaxCluster], lr[kMaxCluster], ar[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {  // all in flight at once
        if (r < ranks) {
          mr[r] = cluster.map_shared_rank(pm, r)[oh];
          lr[r] = cluster.map_shared_rank(pl, r)[oh];
          ar[r] = cluster.map_shared_rank(pacc, r)[o];
        }
      }
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        if (r < ranks) mx = fmaxf(mx, mr[r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < ranks) {
          const float w = mr[r] == -INFINITY ? 0.f : exp2f(mr[r] - mx);
          den = fmaf(lr[r], w, den);
          num = fmaf(ar[r], w, num);
        }
      }
      store_as(orow + o, num / fmaxf(den, 1e-30f));
    }
  }
  cluster.sync();  // no rank leaves while rank 0 reads its shared memory
}

// the kernel with its dynamic shared memory cap raised once to what any
// plan may use
template <typename TQ, typename TKV>
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      paged_attention_split<TQ, TKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats<TKV>(kMaxW, 8)));
  return err;
}

template <typename TKV>
cudaLaunchConfig_t config(int S, int H, int D, int hpb, int splits,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, H / hpb, S);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * smem_floats<TKV>(hpb * D, hpb);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* tables, const void* pos, void* out, int S, int H,
           int D, int num_blocks, int block_size, int max_blocks, int hpb,
           int splits, float scale, void* stream) {
  cudaError_t err = allow_smem<TQ, TKV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<TKV>(S, H, D, hpb, splits, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(
      &cfg, paged_attention_split<TQ, TKV>, static_cast<const TQ*>(q),
      static_cast<const TKV*>(kpool), static_cast<const TKV*>(vpool),
      static_cast<const int*>(tables), static_cast<const int*>(pos),
      static_cast<TQ*>(out), H, D, num_blocks, block_size, max_blocks, hpb,
      Tile<TKV>::kElems / (hpb * D), scale * 1.4426950408889634f);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV>
int max_clusters(int H, int D, int hpb, int splits, int* out) {
  cudaError_t err = allow_smem<float, TKV>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<TKV>(1, H, D, hpb, splits, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, paged_attention_split<float, TKV>, &cfg));
}

}  // namespace

// Plan: hpb heads per block (divides H, hpb * D <= 512); `splits` blocks
// per cluster (<= 8); tiles of 8 KB / (hpb * D * element size) rows.
// q_dtype and kv_dtype: 0 float32, 1 bfloat16 (the output takes q's).
extern "C" int pdt_paged_attention(const void* q, const void* kpool,
                                   const void* vpool, const void* tables,
                                   const void* pos, void* out, int q_dtype,
                                   int kv_dtype, int S, int H, int D,
                                   int num_blocks, int block_size,
                                   int max_blocks, int hpb, int splits,
                                   float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  auto* f = q_dtype == 0
                ? (kv_dtype == 0 ? launch<float, float> : launch<float, bf16>)
                : (kv_dtype == 0 ? launch<bf16, float> : launch<bf16, bf16>);
  return f(q, kpool, vpool, tables, pos, out, S, H, D, num_blocks,
           block_size, max_blocks, hpb, splits, scale, stream);
}

// Clusters of this plan's shape that can be resident at once (0: none).
extern "C" int pdt_paged_attention_max_clusters(int H, int D, int hpb,
                                                int splits, int kv_dtype,
                                                int* out) {
  return kv_dtype == 0
             ? max_clusters<float>(H, D, hpb, splits, out)
             : max_clusters<__nv_bfloat16>(H, D, hpb, splits, out);
}
