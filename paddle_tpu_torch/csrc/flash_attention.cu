// Flash attention forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the Pallas kernels paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _fwd_impl) and ::_bwd_kernel (driven by _bwd_impl).
//   q (B, Sq, H, D), k / v (B, Sk, H, D): f32, bf16 or f16, any batch /
//   seq / head strides (the fused-QKV output's views are read in place),
//   unit stride along D; D in {64, 128, 256}; Sq, Sk multiples of 128.  The
//   16-bit kernels also need 16-byte aligned rows (base and strides multiples of 8
//   elements); the wrapper copies a view that is not.
//   Masks: causal with offset Sk - Sq, additive f32 per-key bias (B, Sk),
//   int32 q / kv segment ids; masked scores are -1e30, not -inf, as in the
//   reference.  In-kernel dropout with the reference's interpret-mode keep
//   mask, bit for bit: a murmur-style hash of the absolute (row, col), the
//   int32 seed (read from device memory) and bh = b * H + head.
//   K1 writes O (B, Sq, H, D) in the input type and the f32 logsumexp
//   (B, H, Sq); K2 writes dQ, dK, dV in the input type and, with a bias,
//   the per-head key sums of dS (B, H, Sk) that the wrapper sums over heads.
//   A row that sees no key gets O = 0 (and, on the 16-bit route, lse = +inf,
//   so that K2 gives it no gradient).
//
// Bound (GPT-2 medium training, B 4, S 1024, H 16, D 64, causal, bf16, one
// layer): K1 moves ~34 MB (q, k, v in, o and lse out: ~10 us at
// 3.35 TB/s) for ~8.6 GFLOP over the causal pairs (~8.7 us on the bf16
// tensor cores at 989 TFLOP/s), so its bytes bound it; K2 moves ~67 MB
// (q, k, v, o, dO, lse in, dQ, dK, dV out: ~20 us) for ~21.5 GFLOP (five
// products: ~22 us), so its operations do.  Both sit near the ridge.
//
// Two routes, picked by dtype in pdt_flash_fwd / pdt_flash_bwd (no
// fallback between them):
//
// bf16 and f16: tensor cores (FlashAttention-2's dataflow on mma.sync).
//   One template over the 16-bit type T, instantiated for both: the two
//   differ only in the mma.sync form (.bf16 or .f16 operands) and in the
//   pair conversions (Half<T>); tiles, swizzles and copies are the same
//   bytes.  Under f16 the -1e30 masks and the softmax state stay in f32
//   registers; P is at most 1 / (1 - dropout) and fits, and a dS past
//   65504 (a large loss scale) rounds to inf as the reference's astype
//   does, for the loss scaler to see.
//   - Every product is mma.sync.m16n8k16 (T in, f32 accumulate).
//     Operands come from shared memory by ldmatrix (.trans where the
//     stored tile is the transpose of the operand).  Tiles are stored as
//     16-bit rows of D elements with a 16-byte-chunk XOR swizzle (chunk
//     c of row r at c ^ (r % 8)), so the eight rows an ldmatrix phase
//     reads hit eight different bank groups, with no padding.
//   - Copies are 16-byte cp.async.cg into a two-stage ring: the copy of
//     tile j + 1 is in flight while tile j is computed.
//   - The accumulator layout of two adjacent n8 tiles of m16n8k16 is the
//     A layout of one k16 slice, so P (and dS) are rounded to T and
//     repacked in registers as the A operand of the next product: no
//     shared-memory round trip and no barrier between softmax and PV.
//   - K1 (flash_fwd_tc_kernel): one block of 4 warps per (64-row q tile,
//     head, batch), 64-key tiles (32 at D = 256), each warp owns 16 query
//     rows; Q is read once into A fragments and kept in registers (from
//     shared memory at D = 256, where the O accumulator leaves no room).  The k loop carries
//     (m, l, O) in registers, stops at the last tile the causal mask lets
//     the tile see (the reference's _go) and masks only the tiles that
//     cross the diagonal.  Row max and sum are over the four threads of a
//     quad; p = 2^((x - m) c) on the SFU (ex2.approx) with c = scale *
//     log2(e) folded in (x - m first, not one FMA of x c - m c: that
//     leaves the rounding of m c, about 2^-24 |m c|, in the exponent, and
//     a fully masked tile has m = -1e30); lse is written in natural-log
//     units.  The q tile is the grid's slowest index, reversed, so the
//     longest tiles of every head start first (and the dK/dV kernel's k
//     tiles in k order, its longest first).
//   - K2: a delta pre-pass (rowsum(dO O), f32, 16-byte loads), then two
//     kernels that share no scratch and use no atomics, so the gradients
//     repeat bit for bit from run to run.  Both take the scores 16 keys
//     (queries) at a time from product to product, so few are live:
//       flash_bwd_dq_tc_kernel, one block per (q tile, head, batch): walks
//       the visible k tiles in k order, recomputes S, P, dP, dS in
//       registers and accumulates dQ += dS K in f32 registers; dQ is
//       written once.
//       flash_bwd_dkdv_tc_kernel, one block per (k tile, head, batch):
//       holds K and V, walks the q tiles that see its keys and computes
//       the transposed S^T = K Q^T and dP^T = V dO^T with keys as the M
//       dimension, so P^T and dS^T are already A operands of
//       dV += P^T dO and dK += dS^T Q.  At D = 256 the block owns one
//       128-wide half of dK / dV's columns (the grid has two blocks per
//       key tile), so its accumulators fit in registers.
//     That is seven products against the algorithm's five (S and dP are
//     computed twice): far cheaper than the f32 dQ partials (one per k
//     tile, 268 MB at the training shape) a single kernel would need.
//   - What a wgmma / TMA version would add: a producer warp issuing TMA
//     tile copies (128-byte swizzle, mbarrier completion) into a deeper
//     ring, two consumer warpgroups each issuing asynchronous 64-row wgmma
//     (S from shared Q and K; PV with P from registers), the softmax of one
//     warpgroup overlapping the other's products, and persistent blocks:
//     wgmma is the only way to the tensor cores' full rate.
//
// f32: the first port's CUDA-core kernels (tensor cores would be TF32,
//   outside the f32 checks' tolerances).  f32 FMAs on tiles staged in
//   shared memory with rows padded to D + 1 words.  K1: one block per
//   (q tile, head, batch), BT x BT tiles (BT = 64, 32 at D = 256), BT * 4
//   threads, thread (rg, cg) owns rows rg*4 .. +3 and columns cg + 16 j.
//   K2: one block per (k tile, head, batch) looping over the q tiles that
//   see its keys; each block writes its per-k-tile dQ partial (f32) to
//   scratch and a second kernel sums them per q tile in k order.
//
// Rounding follows the reference on both routes: P is rounded to v's type
// before PV, dS to q's type before the dK / dQ products, softmax state
// and every sum in f32.  Launches go on the caller's stream and allocate
// nothing; each C entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;
using f16 = __half;

// The tensor-core route's two 16-bit types: a pair of them as one 32-bit
// register, its conversions, and the mma.sync form that reads it.
template <typename T> struct Half;
template <> struct Half<bf16> {
  using T2 = __nv_bfloat162;
  static constexpr bool kF16 = false;
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 f2(T2 v) {
    return __bfloat1622float2(v);
  }
};
template <> struct Half<f16> {
  using T2 = __half2;
  static constexpr bool kF16 = true;
  static __device__ __forceinline__ T2 pair(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 f2(T2 v) {
    return __half22float2(v);
  }
};

struct Strides {
  long long b, s, h;  // elements; unit stride along D
};

struct Masks {
  const float* bias;  // (B, Sk) f32 or null
  const int* qseg;    // (B, Sq) or null
  const int* kseg;    // (B, Sk) or null
  const int* seed;    // (1,) device int32, read only when dropout is on
  int causal, off;    // off = Sk - Sq
  int dropout;
  unsigned thresh;
  float inv_keep;
  float scale;
};

struct FwdArgs {
  const void *q, *k, *v;
  void* o;     // (B, Sq, H, D) contiguous
  float* lse;  // (B, H, Sq)
  Strides qs, ks, vs;
  int B, Sq, Sk, H;
  Masks mk;
};

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;  // (B, Sq | Sk, H, D) contiguous
  float* dq_part;      // f32 route only: (Sk / BT, B, H, Sq, D)
  float* dbias_part;   // (B, H, Sk) or null
  Strides qs, ks, vs, dos;
  int B, Sq, Sk, H;
  Masks mk;
};

// The reference's interpret-mode keep mask (_keep_mask), one element:
// x = (row * 0x9E3779B1) ^ (col * 0x85EBCA77) ^ sb, then the finaliser.
// `sb` is seed + bh * 0xC2B2AE35 (uint32 arithmetic).
__device__ __forceinline__ bool keep_hash(unsigned x, unsigned thresh) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

__device__ __forceinline__ bool keep_elem(unsigned row, unsigned col,
                                          unsigned sb, unsigned thresh) {
  return keep_hash((row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ sb, thresh);
}

__device__ __forceinline__ unsigned seed_bh(const Masks& mk, int b, int H,
                                            int h) {
  if (!mk.dropout) return 0u;
  return static_cast<unsigned>(*mk.seed) +
         static_cast<unsigned>(b * H + h) * 0xC2B2AE35u;
}

// ===========================================================================
// 16-bit route (bf16 and f16): tensor cores
// ===========================================================================

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's most recent copy groups are in
// flight.
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a b for one m16n8k16 tile: a four T pairs (row-major 16 x 16),
// b two (column-major 16 x 8), c four f32.
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  if constexpr (Half<T>::kF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// Two f32 rounded to T (nearest even, as astype), lo in the low half.
// float16 keeps its subnormals and turns a value past 65504 into inf.
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  typename Half<T>::T2 v = Half<T>::pair(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x by the SFU's ex2.approx (2 ulp; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Element (r, c) of a swizzled (rows, D) 16-bit tile: the 16-byte chunk
// c / 8 of row r sits at chunk (c / 8) ^ (r % 8).
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

// ldmatrix.x4 row address of this lane for the 16 x 16 block at (r0, c0):
// lanes 0-15 rows r0 .. r0 + 15 at column c0, lanes 16-31 the same rows at
// c0 + 8.  Read plainly it is an A operand; read with .trans, the B
// operands of two n8 tiles whose k index runs along the rows.
template <int D, typename T>
__device__ __forceinline__ unsigned a_addr(const T* tile, int r0, int c0,
                                           int lane) {
  return smem_u32(tile + swz<D>(r0 + (lane & 15), c0 + ((lane >> 4) << 3)));
}

// ldmatrix.x4 row address for the B operands of two n8 tiles (n index
// along rows n0 .. n0 + 15, k index along columns c0 .. c0 + 15): regs
// 0, 1 are tile n0's b0, b1 and regs 2, 3 tile n0 + 8's.
template <int D, typename T>
__device__ __forceinline__ unsigned b_addr(const T* tile, int n0, int c0,
                                           int lane) {
  return smem_u32(tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                c0 + (((lane >> 3) & 1) << 3)));
}

// Rows r0 .. r0 + R - 1 of head h, batch b into a swizzled (R, D) tile,
// 16-byte cp.async copies spread over the block's 128 threads.
template <int D, int R, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src,
                                           const Strides& st, int b, int r0,
                                           int h) {
  constexpr int CH = D / 8;
  static_assert(R * CH % 128 == 0, "whole copies per thread");
  const T* base = src + b * st.b + h * st.h + (long long)r0 * st.s;
#pragma unroll
  for (int i = 0; i < R * CH / 128; ++i) {
    const int e = threadIdx.x + i * 128, r = e / CH, c = (e % CH) * 8;
    cp_async16(smem_u32(dst + swz<D>(r, c)), base + (long long)r * st.s + c);
  }
}

// A warp's 16 x W slab of f32 accumulators (rows r0 + g and r0 + g + 8 of
// the tile, columns c0 + 8 j + 2 t), times mul0 / mul1, rounded to T
// into the warp's own rows of a swizzled (., D) tile, then copied to
// global rows (dst is row r0's column 0, row stride rs) in 16-byte stores.
template <int D, int W, typename T>
__device__ __forceinline__ void store_slab(T* tile,
                                           const float (&acc)[W / 8][4],
                                           float mul0, float mul1, int r0,
                                           int c0, T* dst, long long rs,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t;
    *reinterpret_cast<unsigned*>(tile + swz<D>(r0 + g, c)) =
        pack2<T>(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<unsigned*>(tile + swz<D>(r0 + g + 8, c)) =
        pack2<T>(acc[j][2] * mul1, acc[j][3] * mul1);
  }
  __syncwarp();
  constexpr int CH = W / 8;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int e = lane + 32 * i, r = e / CH, c = c0 + (e % CH) * 8;
    *reinterpret_cast<uint4*>(dst + r * rs + c) =
        *reinterpret_cast<const uint4*>(tile + swz<D>(r0 + r, c));
  }
}

// ---------------------------------------------------------------------------
// K2's pre-pass, 16-bit: delta[b, h, q] = sum_d dO * O in f32; D / 8 threads
// per (b, q, h) row, 16 bytes of O and of dO each, summed by shuffles
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_delta_tc_kernel(const T* __restrict__ o,
                        const T* __restrict__ dout, Strides dos,
                        float* __restrict__ delta, int B, int Sq, int H) {
  constexpr int TPR = D / 8;  // threads per row, a power of two <= 32
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx / TPR, rows = (long long)B * Sq * H;
  const int c = static_cast<int>(idx % TPR) * 8;
  const int h = static_cast<int>(row % H);
  const long long bq = row / H;
  const int qi = static_cast<int>(bq % Sq), b = static_cast<int>(bq / Sq);
  float s = 0.f;
  if (row < rows) {
    const uint4 ov = *reinterpret_cast<const uint4*>(o + row * D + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + qi * dos.s + h * dos.h + c);
    using T2 = typename Half<T>::T2;
    const T2* o2 = reinterpret_cast<const T2*>(&ov);
    const T2* g2 = reinterpret_cast<const T2*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = Half<T>::f2(o2[i]), y = Half<T>::f2(g2[i]);
      s += x.x * y.x + x.y * y.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < rows && c == 0) delta[((long long)b * H + h) * Sq + qi] = s;
}

// ---------------------------------------------------------------------------
// K1, 16-bit: one block of 4 warps per (q tile of 64 rows, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int D, int BN, bool QREG>
__global__ void __launch_bounds__(128)
flash_fwd_tc_kernel(FwdArgs a) {
  constexpr int BM = 64, KD = D / 16, NS = BN / 8, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* Qs = reinterpret_cast<T*>(smem_tc);  // BM x D
  T* Ks = Qs + BM * D;                       // 2 stages of BN x D
  T* Vs = Ks + 2 * BN * D;                   // 2 stages of BN x D

  const Masks& mk = a.mk;
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;  // the warp's first row
  const int q0 = qt * BM;
  const unsigned sb = seed_bh(mk, b, a.H, h);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  int n_kt = a.Sk / BN;
  if (mk.causal) {
    const int last = q0 + BM - 1 + mk.off;  // last key a row here may see
    n_kt = last < 0 ? 0 : min(n_kt, last / BN + 1);
  }
  tile_async<D, BM>(Qs, static_cast<const T*>(a.q), a.qs, b, q0, h);
  cp_commit();
  if (n_kt > 0) {
    tile_async<D, BN>(Ks, kp, a.ks, b, 0, h);
    tile_async<D, BN>(Vs, vp, a.vs, b, 0, h);
  }
  cp_commit();

  // x is the raw product without a bias and the scaled, biased score with
  // one; x * xs is the score in natural units and p = exp2((x - m) c)
  const float c = mk.bias ? kLog2e : mk.scale * kLog2e;
  const float xs = mk.bias ? 1.f : mk.scale;
  int qi[2], qsg[2];
  unsigned rh[2];
  float m[2], l[2], o[NO][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + wr + g + 8 * r;
    qsg[r] = mk.qseg ? mk.qseg[(long long)b * a.Sq + qi[r]] : 0;
    rh[r] = (static_cast<unsigned>(qi[r]) * 0x9E3779B1u) ^ sb;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;

  unsigned qf[QREG ? KD : 1][4];
  cp_wait<1>();
  __syncthreads();
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldsm4(qf[kd], a_addr<D>(Qs, wr, kd * 16, lane));
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    const T* Kt = Ks + (kt & 1) * BN * D;
    const T* Vt = Vs + (kt & 1) * BN * D;
    if (kt + 1 < n_kt) {  // tile kt + 1 flies while tile kt is computed
      tile_async<D, BN>(Ks + ((kt + 1) & 1) * BN * D, kp, a.ks, b, k0 + BN,
                        h);
      tile_async<D, BN>(Vs + ((kt + 1) & 1) * BN * D, vp, a.vs, b, k0 + BN,
                        h);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // S = Q K^T
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      unsigned af[4];
      if constexpr (QREG) {
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = qf[kd][i];
      } else {
        ldsm4(af, a_addr<D>(Qs, wr, kd * 16, lane));
      }
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        unsigned bk[4];
        ldsm4(bk, b_addr<D>(Kt, nn * 16, kd * 16, lane));
        mma16816<T>(s[2 * nn], af, bk[0], bk[1]);
        mma16816<T>(s[2 * nn + 1], af, bk[2], bk[3]);
      }
    }

    // bias and masks; the causal mask only on tiles crossing the diagonal
    const bool diag = mk.causal && q0 + mk.off < k0 + BN - 1;
    if (mk.bias || mk.qseg || diag) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + 8 * j + 2 * t + e;
          const float bj = mk.bias ? mk.bias[(long long)b * a.Sk + kj] : 0.f;
          const int ksg = mk.kseg ? mk.kseg[(long long)b * a.Sk + kj] : 0;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = s[j][2 * r + e];
            if (mk.bias) x = fmaf(x, mk.scale, bj);
            if (diag && qi[r] + mk.off < kj) x = kNegInf;
            if (mk.qseg && qsg[r] != ksg) x = kNegInf;
            s[j][2 * r + e] = x;
          }
        }
    }

    // online softmax over the quad that shares each row; l is this
    // thread's partial sum (the quad's are added at the end), before
    // dropout
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = quad_max(mx);
      const float alpha = ex2((m[r] - mx) * c);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // x - m first: exact where x is near m, so a row whose scores
          // are all masked (or all biased far below 0) weighs them alike,
          // as the reference does
          const float p = ex2((s[j][2 * r + e] - mx) * c);
          s[j][2 * r + e] = p;
          rs += p;
        }
      l[r] = l[r] * alpha + rs;
      m[r] = mx;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }

    // dropout, P to T, repacked as the A operand of P V
    unsigned pa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const unsigned ch0 =
          static_cast<unsigned>(k0 + 8 * j + 2 * t) * 0x85EBCA77u;
      const unsigned ch1 = ch0 + 0x85EBCA77u;
      float p0 = s[j][0], p1 = s[j][1], p2 = s[j][2], p3 = s[j][3];
      if (mk.dropout) {
        p0 = keep_hash(rh[0] ^ ch0, mk.thresh) ? p0 * mk.inv_keep : 0.f;
        p1 = keep_hash(rh[0] ^ ch1, mk.thresh) ? p1 * mk.inv_keep : 0.f;
        p2 = keep_hash(rh[1] ^ ch0, mk.thresh) ? p2 * mk.inv_keep : 0.f;
        p3 = keep_hash(rh[1] ^ ch1, mk.thresh) ? p3 * mk.inv_keep : 0.f;
      }
      pa[j >> 1][(j & 1) * 2] = pack2<T>(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack2<T>(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        unsigned bv[4];
        ldsm4_t(bv, a_addr<D>(Vt, kk * 16, dd * 16, lane));
        mma16816<T>(o[2 * dd], pa[kk], bv[0], bv[1]);
        mma16816<T>(o[2 * dd + 1], pa[kk], bv[2], bv[3]);
      }
    __syncthreads();  // every warp is done with this stage
  }
  cp_wait<0>();

  // O / l through the warp's own rows of Qs; lse in natural-log units
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lt = quad_sum(l[r]);
    const bool none = m[r] == kNegInf;  // the row saw no key
    inv[r] = none ? 0.f : 1.f / lt;
    if (t == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qi[r]] =
          none ? __int_as_float(0x7f800000) : m[r] * xs + logf(lt);
  }
  store_slab<D, D>(Qs, o, inv[0], inv[1], wr, 0,
                   static_cast<T*>(a.o) +
                       (((long long)b * a.Sq + q0 + wr) * a.H + h) * D,
                   (long long)a.H * D, lane);
}

// ---------------------------------------------------------------------------
// K2, 16-bit: dQ, one block of 4 warps per (q tile of 64 rows, head, batch)
// ---------------------------------------------------------------------------

template <typename T, int D, int BN, bool QREG>
__global__ void __launch_bounds__(128)
flash_bwd_dq_tc_kernel(BwdArgs a) {
  constexpr int BM = 64, KD = D / 16, NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* Qs = reinterpret_cast<T*>(smem_tc);  // BM x D
  T* Gs = Qs + BM * D;                       // dO, BM x D
  T* Ks = Gs + BM * D;                       // 2 stages of BN x D
  T* Vs = Ks + 2 * BN * D;                   // 2 stages of BN x D

  const Masks& mk = a.mk;
  const int h = blockIdx.x, b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int q0 = qt * BM;
  const long long bh = (long long)b * a.H + h;
  const unsigned sb = seed_bh(mk, b, a.H, h);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  int n_kt = a.Sk / BN;
  if (mk.causal) {
    const int last = q0 + BM - 1 + mk.off;
    n_kt = last < 0 ? 0 : min(n_kt, last / BN + 1);
  }
  tile_async<D, BM>(Qs, static_cast<const T*>(a.q), a.qs, b, q0, h);
  tile_async<D, BM>(Gs, static_cast<const T*>(a.dout), a.dos, b, q0, h);
  cp_commit();
  if (n_kt > 0) {
    tile_async<D, BN>(Ks, kp, a.ks, b, 0, h);
    tile_async<D, BN>(Vs, vp, a.vs, b, 0, h);
  }
  cp_commit();

  // p = exp(x xs - lse): one FMA, exact where the score is near lse
  const float xs = mk.bias ? 1.f : mk.scale;
  int qi[2], qsg[2];
  unsigned rh[2];
  float lq[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + wr + g + 8 * r;
    qsg[r] = mk.qseg ? mk.qseg[(long long)b * a.Sq + qi[r]] : 0;
    rh[r] = (static_cast<unsigned>(qi[r]) * 0x9E3779B1u) ^ sb;
    lq[r] = a.lse[bh * a.Sq + qi[r]];
    dl[r] = a.delta[bh * a.Sq + qi[r]];
  }
  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[j][i] = 0.f;

  unsigned qf[QREG ? KD : 1][4], gf[QREG ? KD : 1][4];
  cp_wait<1>();
  __syncthreads();
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      ldsm4(qf[kd], a_addr<D>(Qs, wr, kd * 16, lane));
      ldsm4(gf[kd], a_addr<D>(Gs, wr, kd * 16, lane));
    }
  }

  for (int kt = 0; kt < n_kt; ++kt) {  // in k order: dQ sums in one order
    const int k0 = kt * BN;
    const T* Kt = Ks + (kt & 1) * BN * D;
    const T* Vt = Vs + (kt & 1) * BN * D;
    if (kt + 1 < n_kt) {
      tile_async<D, BN>(Ks + ((kt + 1) & 1) * BN * D, kp, a.ks, b, k0 + BN,
                        h);
      tile_async<D, BN>(Vs + ((kt + 1) & 1) * BN * D, vp, a.vs, b, k0 + BN,
                        h);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const bool diag = mk.causal && q0 + mk.off < k0 + BN - 1;

    // 16 keys at a time, so that few scores are live at once
#pragma unroll
    for (int nn = 0; nn < BN / 16; ++nn) {
      // S = Q K^T, dP = dO V^T for keys k0 + 16 nn ..
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        unsigned aq[4], ag[4], bk[4], bv[4];
        if constexpr (QREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[kd][i];
            ag[i] = gf[kd][i];
          }
        } else {
          ldsm4(aq, a_addr<D>(Qs, wr, kd * 16, lane));
          ldsm4(ag, a_addr<D>(Gs, wr, kd * 16, lane));
        }
        ldsm4(bk, b_addr<D>(Kt, nn * 16, kd * 16, lane));
        ldsm4(bv, b_addr<D>(Vt, nn * 16, kd * 16, lane));
        mma16816<T>(s[0], aq, bk[0], bk[1]);
        mma16816<T>(s[1], aq, bk[2], bk[3]);
        mma16816<T>(dp[0], ag, bv[0], bv[1]);
        mma16816<T>(dp[1], ag, bv[2], bv[3]);
      }

      // dS = P (dP_dropped - delta), rounded to T as the A operand
      unsigned da[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = k0 + nn * 16 + 8 * j + 2 * t + e;
          const float bj = mk.bias ? mk.bias[(long long)b * a.Sk + kj] : 0.f;
          const int ksg = mk.kseg ? mk.kseg[(long long)b * a.Sk + kj] : 0;
          const unsigned ch = static_cast<unsigned>(kj) * 0x85EBCA77u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = s[j][2 * r + e];
            if (mk.bias) x = fmaf(x, mk.scale, bj);
            if (diag && qi[r] + mk.off < kj) x = kNegInf;
            if (mk.qseg && qsg[r] != ksg) x = kNegInf;
            const float p = ex2(fmaf(x, xs, -lq[r]) * kLog2e);
            float dpv = dp[j][2 * r + e];
            if (mk.dropout)
              dpv = keep_hash(rh[r] ^ ch, mk.thresh) ? dpv * mk.inv_keep
                                                    : 0.f;
            ds[2 * r + e] = p * (dpv - dl[r]);
          }
        }
        da[2 * j] = pack2<T>(ds[0], ds[1]);
        da[2 * j + 1] = pack2<T>(ds[2], ds[3]);
      }

      // dQ += dS K over these 16 keys
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        unsigned bk[4];
        ldsm4_t(bk, a_addr<D>(Kt, nn * 16, dd * 16, lane));
        mma16816<T>(dq[2 * dd], da, bk[0], bk[1]);
        mma16816<T>(dq[2 * dd + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_slab<D, D>(Qs, dq, mk.scale, mk.scale, wr, 0,
                   static_cast<T*>(a.dq) +
                       (((long long)b * a.Sq + q0 + wr) * a.H + h) * D,
                   (long long)a.H * D, lane);
}

// ---------------------------------------------------------------------------
// K2, 16-bit: dK and dV, one block of 4 warps per (k tile of 64 keys, head,
// batch, DS-wide column slab)
// ---------------------------------------------------------------------------

// Q, dO, lse and delta of the q tile at row q0 into one ring stage.
template <int D, int BMQ, typename T>
__device__ __forceinline__ void q_tile_async(T* Qs, T* Gs, float* Ls,
                                             float* Es, const BwdArgs& a,
                                             int b, int h, long long bh,
                                             int q0) {
  tile_async<D, BMQ>(Qs, static_cast<const T*>(a.q), a.qs, b, q0, h);
  tile_async<D, BMQ>(Gs, static_cast<const T*>(a.dout), a.dos, b, q0, h);
  const int i = threadIdx.x;
  const long long row = bh * a.Sq + q0;
  if (i < BMQ / 4)
    cp_async16(smem_u32(Ls + 4 * i), a.lse + row + 4 * i);
  else if (i < BMQ / 2)
    cp_async16(smem_u32(Es + 4 * (i - BMQ / 4)),
               a.delta + row + 4 * (i - BMQ / 4));
}

template <typename T, int D, int BMQ, int DS, bool KVREG>
__global__ void __launch_bounds__(128)
flash_bwd_dkdv_tc_kernel(BwdArgs a) {
  constexpr int BN = 64, KD = D / 16, NSLAB = D / DS;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  T* Ks = reinterpret_cast<T*>(smem_tc);  // BN x D
  T* Vs = Ks + BN * D;                       // BN x D
  T* Qs = Vs + BN * D;                       // 2 stages of BMQ x D
  T* Gs = Qs + 2 * BMQ * D;                  // dO, 2 stages
  float* Ls = reinterpret_cast<float*>(Gs + 2 * BMQ * D);  // lse, 2 stages
  float* Es = Ls + 2 * BMQ;                                // delta, 2 stages

  const Masks& mk = a.mk;
  const int h = blockIdx.x / NSLAB, b = blockIdx.y, kt = blockIdx.z;
  const int c0 = (blockIdx.x % NSLAB) * DS;  // this block's dK / dV columns
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int k0 = kt * BN;
  const long long bh = (long long)b * a.H + h;
  const unsigned sb = seed_bh(mk, b, a.H, h);

  const int n_qt = a.Sq / BMQ;
  int qt0 = 0;  // the first q tile that sees key k0
  if (mk.causal && k0 - mk.off > 0) qt0 = min(n_qt, (k0 - mk.off) / BMQ);
  tile_async<D, BN>(Ks, static_cast<const T*>(a.k), a.ks, b, k0, h);
  tile_async<D, BN>(Vs, static_cast<const T*>(a.v), a.vs, b, k0, h);
  cp_commit();
  if (qt0 < n_qt) q_tile_async<D, BMQ>(Qs, Gs, Ls, Es, a, b, h, bh, qt0 * BMQ);
  cp_commit();

  const float xs = mk.bias ? 1.f : mk.scale;  // p = exp(x xs - lse)
  int kr[2], ksg[2];
  float kb[2];
  unsigned kh[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kr[r] = k0 + wr + g + 8 * r;
    kb[r] = mk.bias ? mk.bias[(long long)b * a.Sk + kr[r]] : 0.f;
    ksg[r] = mk.kseg ? mk.kseg[(long long)b * a.Sk + kr[r]] : 0;
    kh[r] = static_cast<unsigned>(kr[r]) * 0x85EBCA77u;
  }
  float dk[DS / 8][4], dv[DS / 8][4], db[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DS / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[j][i] = dv[j][i] = 0.f;

  unsigned kf[KVREG ? KD : 1][4], vf[KVREG ? KD : 1][4];
  cp_wait<1>();
  __syncthreads();
  if constexpr (KVREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      ldsm4(kf[kd], a_addr<D>(Ks, wr, kd * 16, lane));
      ldsm4(vf[kd], a_addr<D>(Vs, wr, kd * 16, lane));
    }
  }

  for (int qt = qt0; qt < n_qt; ++qt) {  // in q order: dK, dV, dbias sum
    const int st = (qt - qt0) & 1, q0 = qt * BMQ;
    if (qt + 1 < n_qt)
      q_tile_async<D, BMQ>(Qs + (st ^ 1) * BMQ * D, Gs + (st ^ 1) * BMQ * D,
                           Ls + (st ^ 1) * BMQ, Es + (st ^ 1) * BMQ, a, b, h,
                           bh, q0 + BMQ);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const T* Qt = Qs + st * BMQ * D;
    const T* Gt = Gs + st * BMQ * D;
    const float* Lt = Ls + st * BMQ;
    const float* Et = Es + st * BMQ;
    const bool diag = mk.causal && q0 + mk.off < k0 + BN - 1;

    // 16 queries at a time, so that few scores are live at once (not
    // unrolled: unrolled, ptxas keeps more registers live and fewer
    // blocks fit on an SM)
#pragma unroll 1
    for (int nn = 0; nn < BMQ / 16; ++nn) {
      // S^T = K Q^T, dP^T = V dO^T (keys as rows) for queries q0 + 16 nn ..
      float sT[2][4], dpT[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) sT[j][i] = dpT[j][i] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        unsigned ak[4], av[4], bq[4], bg[4];
        if constexpr (KVREG) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kd][i];
            av[i] = vf[kd][i];
          }
        } else {
          ldsm4(ak, a_addr<D>(Ks, wr, kd * 16, lane));
          ldsm4(av, a_addr<D>(Vs, wr, kd * 16, lane));
        }
        ldsm4(bq, b_addr<D>(Qt, nn * 16, kd * 16, lane));
        ldsm4(bg, b_addr<D>(Gt, nn * 16, kd * 16, lane));
        mma16816<T>(sT[0], ak, bq[0], bq[1]);
        mma16816<T>(sT[1], ak, bq[2], bq[3]);
        mma16816<T>(dpT[0], av, bg[0], bg[1]);
        mma16816<T>(dpT[1], av, bg[2], bg[3]);
      }

      // P^T (dropped) and dS^T, rounded to T as A operands; ds uses
      // the undropped p and the dropped, scaled dp, as the reference
      unsigned pa[4], da[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = nn * 16 + 8 * j + 2 * t + e, qc = q0 + ql;
          const float lq = Lt[ql], dl = Et[ql];
          const int qsg = mk.qseg ? mk.qseg[(long long)b * a.Sq + qc] : 0;
          const unsigned qh = (static_cast<unsigned>(qc) * 0x9E3779B1u) ^ sb;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = sT[j][2 * r + e];
            if (mk.bias) x = fmaf(x, mk.scale, kb[r]);
            if (diag && qc + mk.off < kr[r]) x = kNegInf;
            if (mk.qseg && qsg != ksg[r]) x = kNegInf;
            const float p = ex2(fmaf(x, xs, -lq) * kLog2e);
            float pv = p, dpv = dpT[j][2 * r + e];
            if (mk.dropout) {
              const bool keep = keep_hash(qh ^ kh[r], mk.thresh);
              pv = keep ? p * mk.inv_keep : 0.f;
              dpv = keep ? dpv * mk.inv_keep : 0.f;
            }
            const float d = p * (dpv - dl);
            db[r] += d;
            pd[2 * r + e] = pv;
            ds[2 * r + e] = d;
          }
        }
        pa[2 * j] = pack2<T>(pd[0], pd[1]);
        pa[2 * j + 1] = pack2<T>(pd[2], pd[3]);
        da[2 * j] = pack2<T>(ds[0], ds[1]);
        da[2 * j + 1] = pack2<T>(ds[2], ds[3]);
      }

      // dV += P^T dO, dK += dS^T Q over these 16 queries and this block's
      // columns
#pragma unroll
      for (int dd = 0; dd < DS / 16; ++dd) {
        unsigned bg[4], bq[4];
        ldsm4_t(bg, a_addr<D>(Gt, nn * 16, c0 + dd * 16, lane));
        ldsm4_t(bq, a_addr<D>(Qt, nn * 16, c0 + dd * 16, lane));
        mma16816<T>(dv[2 * dd], pa, bg[0], bg[1]);
        mma16816<T>(dv[2 * dd + 1], pa, bg[2], bg[3]);
        mma16816<T>(dk[2 * dd], da, bq[0], bq[1]);
        mma16816<T>(dk[2 * dd + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  if (a.dbias_part && c0 == 0) {  // the quad's column sums, fixed order
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(db[r]);
      if (t == 0) a.dbias_part[bh * a.Sk + kr[r]] = v;
    }
  }
  __syncwarp();
  const long long row0 = ((long long)b * a.Sk + k0 + wr) * a.H + h;
  store_slab<D, DS>(Ks, dk, mk.scale, mk.scale, wr, c0,
                    static_cast<T*>(a.dk) + row0 * D, (long long)a.H * D,
                    lane);
  store_slab<D, DS>(Vs, dv, 1.f, 1.f, wr, c0,
                    static_cast<T*>(a.dv) + row0 * D, (long long)a.H * D,
                    lane);
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <typename T, int D>
int launch_fwd_tc(const FwdArgs& a, cudaStream_t st) {
  constexpr int BN = D == 256 ? 32 : 64;
  const size_t smem = sizeof(T) * (64 * D + 4 * BN * D);
  auto kern = flash_fwd_tc_kernel<T, D, BN, (D <= 128)>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<dim3(a.H, a.B, a.Sq / 64), 128, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd_tc(const BwdArgs& a, cudaStream_t st) {
  {
    const long long threads = (long long)a.B * a.Sq * a.H * (D / 8);
    flash_delta_tc_kernel<T, D><<<(unsigned)((threads + 255) / 256), 256, 0,
                                 st>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
        a.dos, const_cast<float*>(a.delta), a.B, a.Sq, a.H);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  {
    constexpr int BN = D == 256 ? 32 : 64;
    const size_t smem = sizeof(T) * (2 * 64 * D + 4 * BN * D);
    auto kern = flash_bwd_dq_tc_kernel<T, D, BN, (D == 64)>;
    if (int err = set_smem(kern, smem)) return err;
    kern<<<dim3(a.H, a.B, a.Sq / 64), 128, smem, st>>>(a);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  constexpr int BMQ = D == 256 ? 32 : 64, DS = D == 256 ? 128 : D;
  const size_t smem =
      sizeof(T) * (2 * 64 * D + 4 * BMQ * D) + sizeof(float) * 4 * BMQ;
  auto kern = flash_bwd_dkdv_tc_kernel<T, D, BMQ, DS, (D == 64)>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<dim3(a.H * (D / DS), a.B, a.Sk / 64), 128, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// f32 route: CUDA-core kernels
// ===========================================================================

// Scaled, biased, masked score of absolute (qi, kj); ql / kl index the
// tile's staged segment ids and bias.
__device__ __forceinline__ float masked_score(
    float dot, const Masks& mk, int qi, int kj, int ql, int kl,
    const float* bias_s, const int* qseg_s, const int* kseg_s) {
  float s = dot * mk.scale;
  if (mk.bias) s += bias_s[kl];
  if (mk.causal && qi + mk.off < kj) s = kNegInf;
  if (mk.qseg && qseg_s[ql] != kseg_s[kl]) s = kNegInf;
  return s;
}

// Load a (BT, D) tile of rows r0 .. r0 + BT - 1 of head h, batch b into
// shared memory with row pitch LD.
template <int D, int BT, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const Strides& st, int b, int r0,
                                          int h) {
  const float* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < BT * D; e += BT * 4) {
    const int r = e / D, d = e - (e / D) * D;
    dst[r * LD + d] = base[(long long)(r0 + r) * st.s + d];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// delta[b, h, q] = sum_d dO * O; one warp per (b, q, h) row.
__global__ void flash_delta_f32_kernel(const float* __restrict__ o,
                                       const float* __restrict__ dout,
                                       Strides dos, float* __restrict__ delta,
                                       int B, int Sq, int H, int D) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Sq * H) return;
  const int h = row % H;
  const long long t = row / H;
  const int qi = t % Sq, b = t / Sq;
  const float* orow = o + row * D;
  const float* drow = dout + b * dos.b + qi * dos.s + h * dos.h;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += orow[d] * drow[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[((long long)b * H + h) * Sq + qi] = s;
}

template <int D, int BT>
__global__ void __launch_bounds__(BT * 4)
flash_fwd_f32_kernel(FwdArgs a) {
  constexpr int NJS = BT / 16;  // score columns per thread
  constexpr int NJD = D / 16;   // output columns per thread
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Ps = Vs + BT * LD;
  float* bias_s = Ps + BT * LP;
  int* qseg_s = reinterpret_cast<int*>(bias_s + BT);
  int* kseg_s = qseg_s + BT;

  const Masks& mk = a.mk;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int q0 = qt * BT;
  const unsigned sb = seed_bh(mk, b, a.H, h);

  load_tile<D, BT, LD>(Qs, static_cast<const float*>(a.q), a.qs, b, q0, h);
  if (mk.qseg)
    for (int r = tid; r < BT; r += BT * 4)
      qseg_s[r] = mk.qseg[(long long)b * a.Sq + q0 + r];

  float m[4], l[4], acc[4][NJD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJD; ++j) acc[i][j] = 0.f;
  }

  int n_kt = a.Sk / BT;
  if (mk.causal) {
    const int last = q0 + BT - 1 + mk.off;  // last key a row here may see
    n_kt = last < 0 ? 0 : min(n_kt, last / BT + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D, BT, LD>(Ks, static_cast<const float*>(a.k), a.ks, b, k0, h);
    load_tile<D, BT, LD>(Vs, static_cast<const float*>(a.v), a.vs, b, k0, h);
    for (int r = tid; r < BT; r += BT * 4) {
      if (mk.bias) bias_s[r] = mk.bias[(long long)b * a.Sk + k0 + r];
      if (mk.kseg) kseg_s[r] = mk.kseg[(long long)b * a.Sk + k0 + r];
    }
    __syncthreads();

    float s[4][NJS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NJS];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < NJS; ++j) kv[j] = Ks[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = rg * 4 + i, qi = q0 + ql;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        const int kl = cg + 16 * j;
        s[i][j] = masked_score(s[i][j], mk, qi, k0 + kl, ql, kl, bias_s,
                               qseg_s, kseg_s);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      // the denominator sums p before dropout, as the reference does
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJD; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        const int kl = cg + 16 * j;
        float p = s[i][j];
        if (mk.dropout)
          p = keep_elem(qi, k0 + kl, sb, mk.thresh) ? p * mk.inv_keep : 0.f;
        Ps[ql * LP + kl] = p;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float pv[4], vv[NJD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJD; ++j) vv[j] = Vs[kk * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJD; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + (((long long)b * a.Sq + qi) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJD; ++j) orow[cg + 16 * j] = acc[i][j] / li;
    if (cg == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qi] = m[i] + logf(li);
  }
}

template <int D, int BT>
__global__ void __launch_bounds__(BT * 4)
flash_bwd_f32_kernel(BwdArgs a) {
  constexpr int NJS = BT / 16;
  constexpr int NJD = D / 16;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;   // dropped P
  float* dSs = Ps + BT * LP;   // dS
  float* lse_s = dSs + BT * LP;
  float* dl_s = lse_s + BT;
  float* bias_s = dl_s + BT;
  int* qseg_s = reinterpret_cast<int*>(bias_s + BT);
  int* kseg_s = qseg_s + BT;

  const Masks& mk = a.mk;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int k0 = kt * BT;
  const unsigned sb = seed_bh(mk, b, a.H, h);
  const long long bh = (long long)b * a.H + h;

  load_tile<D, BT, LD>(Ks, static_cast<const float*>(a.k), a.ks, b, k0, h);
  load_tile<D, BT, LD>(Vs, static_cast<const float*>(a.v), a.vs, b, k0, h);
  for (int r = tid; r < BT; r += BT * 4) {
    if (mk.bias) bias_s[r] = mk.bias[(long long)b * a.Sk + k0 + r];
    if (mk.kseg) kseg_s[r] = mk.kseg[(long long)b * a.Sk + k0 + r];
  }

  float dk[4][NJD], dv[4][NJD], db[NJS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJD; ++j) dk[i][j] = dv[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < NJS; ++j) db[j] = 0.f;

  const int n_qt = a.Sq / BT;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BT;
    if (mk.causal && q0 + BT - 1 + mk.off < k0) continue;  // block-uniform
    __syncthreads();  // the previous q tile's readers are done
    load_tile<D, BT, LD>(Qs, static_cast<const float*>(a.q), a.qs, b, q0, h);
    load_tile<D, BT, LD>(dOs, static_cast<const float*>(a.dout), a.dos, b,
                         q0, h);
    for (int r = tid; r < BT; r += BT * 4) {
      lse_s[r] = a.lse[bh * a.Sq + q0 + r];
      dl_s[r] = a.delta[bh * a.Sq + q0 + r];
      if (mk.qseg) qseg_s[r] = mk.qseg[(long long)b * a.Sq + q0 + r];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows rg*4+i, columns cg + 16 j
    float s[4][NJS], dp[4][NJS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[NJS], vv[NJS];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(rg * 4 + i) * LD + d];
        gv[i] = dOs[(rg * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        kv[j] = Ks[(cg + 16 * j) * LD + d];
        vv[j] = Vs[(cg + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = rg * 4 + i, qi = q0 + ql;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        const int kl = cg + 16 * j, kj = k0 + kl;
        const float sc = masked_score(s[i][j], mk, qi, kj, ql, kl, bias_s,
                                      qseg_s, kseg_s);
        const float p = expf(sc - lse_s[ql]);
        float pd = p, dpv = dp[i][j];
        if (mk.dropout) {
          const bool keep = keep_elem(qi, kj, sb, mk.thresh);
          pd = keep ? p * mk.inv_keep : 0.f;
          dpv = keep ? dpv * mk.inv_keep : 0.f;
        }
        // ds uses the undropped p and the masked, scaled dp
        const float ds = p * (dpv - dl_s[ql]);
        db[j] += ds;
        Ps[ql * LP + kl] = pd;
        dSs[ql * LP + kl] = ds;
      }
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q for key rows rg*4+i, columns cg + 16 j
#pragma unroll 4
    for (int qq = 0; qq < BT; ++qq) {
      float pv[4], sv[4], gv[NJD], qv[NJD];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * LP + rg * 4 + i];
        sv[i] = dSs[qq * LP + rg * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < NJD; ++j) {
        gv[j] = dOs[qq * LD + cg + 16 * j];
        qv[j] = Qs[qq * LD + cg + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJD; ++j) {
          dv[i][j] = fmaf(pv[i], gv[j], dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv[j], dk[i][j]);
        }
    }

    // this k tile's dQ partial: dS K for query rows rg*4+i
    float dq[4][NJD];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJD; ++j) dq[i][j] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float sv[4], kv[NJD];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(rg * 4 + i) * LP + kk];
#pragma unroll
      for (int j = 0; j < NJD; ++j) kv[j] = Ks[kk * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJD; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
    float* part = a.dq_part + (((long long)kt * a.B + b) * a.H + h) *
                                  (long long)a.Sq * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* prow = part + (long long)(q0 + rg * 4 + i) * D;
#pragma unroll
      for (int j = 0; j < NJD; ++j) prow[cg + 16 * j] = dq[i][j] * mk.scale;
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = (((long long)b * a.Sk + k0 + rg * 4 + i) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJD; ++j) {
      dkp[off + cg + 16 * j] = dk[i][j] * mk.scale;
      dvp[off + cg + 16 * j] = dv[i][j];
    }
  }
  if (a.dbias_part) {  // sum the row groups' column sums, in a fixed order
    __syncthreads();
    float* red = Ps;  // (BT / 4) x BT, fits in Ps
#pragma unroll
    for (int j = 0; j < NJS; ++j) red[rg * BT + cg + 16 * j] = db[j];
    __syncthreads();
    for (int c = tid; c < BT; c += BT * 4) {
      float t = 0.f;
      for (int r = 0; r < BT / 4; ++r) t += red[r * BT + c];
      a.dbias_part[bh * a.Sk + k0 + c] = t;
    }
  }
}

// dQ[b, q, h, :] = sum of the k tiles' partials that q's tile saw, in k
// order (the same causal predicate as the tile skip in flash_bwd_f32_kernel).
__global__ void flash_dq_reduce_f32_kernel(const float* __restrict__ part,
                                           float* __restrict__ dq, int B,
                                           int Sq, int H, int D, int n_kt,
                                           int BT, int causal, int off) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * Sq * H * D) return;
  const int d = idx % D;
  long long t = idx / D;
  const int h = t % H;
  t /= H;
  const int qi = t % Sq, b = t / Sq;
  const int q0 = (qi / BT) * BT;
  const long long step = (long long)B * H * Sq * D;
  const float* p = part + (((long long)b * H + h) * Sq + qi) * D + d;
  float acc = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    if (causal && q0 + BT - 1 + off < j * BT) break;
    acc += p[j * step];
  }
  dq[idx] = acc;
}

template <int D> constexpr int tile() { return D >= 256 ? 32 : 64; }

template <int D>
int launch_fwd_f32(const FwdArgs& a, cudaStream_t st) {
  constexpr int BT = tile<D>();
  const size_t smem =
      sizeof(float) * (3 * BT * (D + 1) + BT * (BT + 1) + BT) +
      sizeof(int) * 2 * BT;
  auto kern = flash_fwd_f32_kernel<D, BT>;
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid(a.Sq / BT, a.H, a.B);
  kern<<<grid, BT * 4, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_f32(const BwdArgs& a, cudaStream_t st) {
  constexpr int BT = tile<D>();
  {
    const long long rows = (long long)a.B * a.Sq * a.H;
    const int warps = 8;
    flash_delta_f32_kernel<<<(unsigned)((rows + warps - 1) / warps),
                             warps * 32, 0, st>>>(
        static_cast<const float*>(a.o), static_cast<const float*>(a.dout),
        a.dos, const_cast<float*>(a.delta), a.B, a.Sq, a.H, D);
    if (int err = static_cast<int>(cudaGetLastError())) return err;
  }
  const size_t smem =
      sizeof(float) * (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 3 * BT) +
      sizeof(int) * 2 * BT;
  auto kern = flash_bwd_f32_kernel<D, BT>;
  if (int err = set_smem(kern, smem)) return err;
  dim3 grid(a.Sk / BT, a.H, a.B);
  kern<<<grid, BT * 4, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)a.B * a.Sq * a.H * D;
  flash_dq_reduce_f32_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.dq_part, static_cast<float*>(a.dq), a.B, a.Sq, a.H, D, a.Sk / BT, BT,
      a.mk.causal, a.mk.off);
  return static_cast<int>(cudaGetLastError());
}

Masks make_masks(const void* bias, const void* qseg, const void* kseg,
                 const void* seed, int causal, int off, int dropout,
                 unsigned thresh, float inv_keep, float scale) {
  Masks mk;
  mk.bias = static_cast<const float*>(bias);
  mk.qseg = static_cast<const int*>(qseg);
  mk.kseg = static_cast<const int*>(kseg);
  mk.seed = static_cast<const int*>(seed);
  mk.causal = causal;
  mk.off = off;
  mk.dropout = dropout;
  mk.thresh = thresh;
  mk.inv_keep = inv_keep;
  mk.scale = scale;
  return mk;
}

}  // namespace

// Tile rows of the f32 route's kernels at head_dim D (its dQ partials
// have Sk / tile slices).
extern "C" int pdt_flash_tile(int D) {
  return D >= 256 ? 32 : 64;
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16, 2 float16 (tensor cores).
extern "C" int pdt_flash_fwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* qseg, const void* kseg, const void* seed, void* o, void* lse,
    int B, int Sq, int Sk, int H, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, float scale,
    int dropout, unsigned thresh, float inv_keep, void* stream) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.qs = {qsb, qss, qsh};
  a.ks = {ksb, kss, ksh};
  a.vs = {vsb, vss, vsh};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.mk = make_masks(bias, qseg, kseg, seed, causal, Sk - Sq, dropout, thresh,
                    inv_keep, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_fwd_tc<bf16, 64>(a, st);
      case 128: return launch_fwd_tc<bf16, 128>(a, st);
      case 256: return launch_fwd_tc<bf16, 256>(a, st);
    }
  } else if (dtype == 2) {
    switch (D) {
      case 64: return launch_fwd_tc<f16, 64>(a, st);
      case 128: return launch_fwd_tc<f16, 128>(a, st);
      case 256: return launch_fwd_tc<f16, 256>(a, st);
    }
  } else if (dtype == 0) {
    switch (D) {
      case 64: return launch_fwd_f32<64>(a, st);
      case 128: return launch_fwd_f32<128>(a, st);
      case 256: return launch_fwd_f32<256>(a, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dq_part is the f32 route's scratch; the 16-bit route takes null there.
extern "C" int pdt_flash_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* bias,
    const void* qseg, const void* kseg, const void* seed, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* dbias_part, void* dq_part, void* delta, int B, int Sq, int Sk,
    int H, int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh, int causal,
    float scale, int dropout, unsigned thresh, float inv_keep,
    void* stream) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_part = static_cast<float*>(dq_part);
  a.dbias_part = static_cast<float*>(dbias_part);
  a.qs = {qsb, qss, qsh};
  a.ks = {ksb, kss, ksh};
  a.vs = {vsb, vss, vsh};
  a.dos = {dsb, dss, dsh};
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.mk = make_masks(bias, qseg, kseg, seed, causal, Sk - Sq, dropout, thresh,
                    inv_keep, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 64: return launch_bwd_tc<bf16, 64>(a, st);
      case 128: return launch_bwd_tc<bf16, 128>(a, st);
      case 256: return launch_bwd_tc<bf16, 256>(a, st);
    }
  } else if (dtype == 2) {
    switch (D) {
      case 64: return launch_bwd_tc<f16, 64>(a, st);
      case 128: return launch_bwd_tc<f16, 128>(a, st);
      case 256: return launch_bwd_tc<f16, 256>(a, st);
    }
  } else if (dtype == 0) {
    if (!dq_part) return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 64: return launch_bwd_f32<64>(a, st);
      case 128: return launch_bwd_f32<128>(a, st);
      case 256: return launch_bwd_f32<256>(a, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
