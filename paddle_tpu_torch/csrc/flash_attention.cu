// Flash attention forward (K1) and backward (K2) for Hopper (sm_90a).
//
// Replaces the Pallas kernels paddle_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _fwd_impl) and ::_bwd_kernel (driven by _bwd_impl).
//   q (B, Sq, H, D), k / v (B, Sk, H, D): f32 or bf16, any batch / seq /
//   head strides (the fused-QKV output's views are read in place), unit
//   stride along D; D in {64, 128, 256}; Sq, Sk multiples of the tile.
//   Masks: causal with offset Sk - Sq, additive f32 per-key bias (B, Sk),
//   int32 q / kv segment ids; masked scores are -1e30, not -inf, as in the
//   reference.  In-kernel dropout with the reference's interpret-mode keep
//   mask, bit for bit: a murmur-style hash of the absolute (row, col), the
//   int32 seed (read from device memory) and bh = b * H + head.
//   K1 writes O (B, Sq, H, D) in the input type and the f32 logsumexp
//   (B, H, Sq); K2 writes dQ, dK, dV in the input type and, with a bias,
//   the per-head key sums of dS (B, H, Sk) that the wrapper sums over heads.
//
// Bound (GPT-2 medium training, B 4, S 1024, H 16, D 64, causal, bf16, one
// layer): K1 moves ~34 MB (q, k, v in, o and lse out: ~10 us at
// 3.35 TB/s) for ~8.6 GFLOP over the causal pairs (~8.7 us on the bf16
// tensor cores at 989 TFLOP/s), so its bytes bound it; K2 moves ~67 MB
// (q, k, v, o, dO, lse in, dQ, dK, dV out: ~20 us) for ~21.5 GFLOP (five
// products: ~22 us), so its operations do.  Both sit near the ridge.
// This first port is the simple, correct form: CUDA-core f32 FMAs on
// tiles staged in shared memory (no mma / wgmma / TMA yet), so it runs far
// from that bound; PERF.md has its times.
//
// Design (the TPU grid walks k blocks in order, carrying (m, l, acc) in
// VMEM scratch; here blocks run in parallel, so a loop inside the block
// takes the place of the sequential grid axis):
//   - K1: one block per (q tile, head, batch), BT x BT tiles (BT = 64, 32
//     at D = 256), BT * 4 threads.  Thread (rg, cg) owns rows rg*4 .. +3 and
//     columns cg + 16 j, so a row's 16 column owners are one half-warp and
//     the row max / sum are 4 xor-shuffles.  The k loop carries m, l and the
//     O accumulator in registers and stops at the last tile the causal mask
//     lets a row of this q tile see (the TPU kernel's _go skip).  Tiles are
//     staged in shared memory as f32 with rows padded to D + 1 words, so
//     every inner-product read is a broadcast or conflict-free.
//   - K2: one block per (k tile, head, batch); K and V stay in shared
//     memory while the block loops over the q tiles that see its keys,
//     recomputing S, P = exp(S - lse) and dS = P (dP - delta) once per tile
//     pair and accumulating dK, dV in registers.  dQ is deterministic: each
//     block writes its per-k-tile dQ partial (f32) to scratch, and a second
//     kernel sums, per q tile, the partials of exactly the k tiles the
//     causal mask let it see, in k order (no atomics, so loss curves repeat
//     from run to run).  A first small kernel computes delta = rowsum(dO O).
//   - Rounding follows the reference: P is rounded to v's type before PV,
//     dS to q's type before the dK / dQ products, softmax state and every
//     sum in f32.
// Launches go on the caller's stream and allocate nothing; each C entry
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

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
  void *dk, *dv;     // (B, Sk, H, D) contiguous
  float* dq_part;    // (Sk / BT, B, H, Sq, D)
  float* dbias_part; // (B, H, Sk) or null
  Strides qs, ks, vs, dos;
  int B, Sq, Sk, H;
  Masks mk;
};

// The reference's interpret-mode keep mask (_keep_mask), one element.
// `sb` is seed + bh * 0xC2B2AE35 (uint32 arithmetic).
__device__ __forceinline__ bool keep_elem(unsigned row, unsigned col,
                                          unsigned sb, unsigned thresh) {
  unsigned x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u);
  x ^= sb;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= thresh;
}

__device__ __forceinline__ unsigned seed_bh(const Masks& mk, int b, int H,
                                            int h) {
  if (!mk.dropout) return 0u;
  return static_cast<unsigned>(*mk.seed) +
         static_cast<unsigned>(b * H + h) * 0xC2B2AE35u;
}

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
// shared memory as f32 with row pitch LD.
template <typename T, int D, int BT, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Strides& st, int b, int r0,
                                          int h) {
  const T* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < BT * D; e += BT * 4) {
    const int r = e / D, d = e - (e / D) * D;
    dst[r * LD + d] = to_f<T>(base[(long long)(r0 + r) * st.s + d]);
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

// ---------------------------------------------------------------------------
// K1: forward
// ---------------------------------------------------------------------------

template <typename T, int D, int BT>
__global__ void __launch_bounds__(BT * 4)
flash_fwd_kernel(FwdArgs a) {
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

  load_tile<T, D, BT, LD>(Qs, static_cast<const T*>(a.q), a.qs, b, q0, h);
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
    load_tile<T, D, BT, LD>(Ks, static_cast<const T*>(a.k), a.ks, b, k0, h);
    load_tile<T, D, BT, LD>(Vs, static_cast<const T*>(a.v), a.vs, b, k0, h);
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
        Ps[ql * LP + kl] = round_to<T>(p);
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

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg * 4 + i;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * a.Sq + qi) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJD; ++j) orow[cg + 16 * j] = from_f<T>(acc[i][j] / li);
    if (cg == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qi] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// K2: backward (delta pre-pass, merged recompute kernel, dQ partial sum)
// ---------------------------------------------------------------------------

// delta[b, h, q] = sum_d dO * O in f32; one warp per (b, q, h) row.
template <typename T>
__global__ void flash_delta_kernel(const T* __restrict__ o,
                                   const T* __restrict__ dout, Strides dos,
                                   float* __restrict__ delta, int B, int Sq,
                                   int H, int D) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Sq * H) return;
  const int h = row % H;
  const long long t = row / H;
  const int qi = t % Sq, b = t / Sq;
  const T* orow = o + row * D;
  const T* drow = dout + b * dos.b + qi * dos.s + h * dos.h;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += to_f<T>(orow[d]) * to_f<T>(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[((long long)b * H + h) * Sq + qi] = s;
}

template <typename T, int D, int BT>
__global__ void __launch_bounds__(BT * 4)
flash_bwd_kernel(BwdArgs a) {
  constexpr int NJS = BT / 16;
  constexpr int NJD = D / 16;
  constexpr int LD = D + 1;
  constexpr int LP = BT + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;   // dropped P, rounded to T
  float* dSs = Ps + BT * LP;   // dS, rounded to T
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

  load_tile<T, D, BT, LD>(Ks, static_cast<const T*>(a.k), a.ks, b, k0, h);
  load_tile<T, D, BT, LD>(Vs, static_cast<const T*>(a.v), a.vs, b, k0, h);
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
    load_tile<T, D, BT, LD>(Qs, static_cast<const T*>(a.q), a.qs, b, q0, h);
    load_tile<T, D, BT, LD>(dOs, static_cast<const T*>(a.dout), a.dos, b, q0,
                            h);
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
        Ps[ql * LP + kl] = round_to<T>(pd);
        dSs[ql * LP + kl] = round_to<T>(ds);
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

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = (((long long)b * a.Sk + k0 + rg * 4 + i) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJD; ++j) {
      dkp[off + cg + 16 * j] = from_f<T>(dk[i][j] * mk.scale);
      dvp[off + cg + 16 * j] = from_f<T>(dv[i][j]);
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
// order (the same causal predicate as the tile skip in flash_bwd_kernel).
template <typename T>
__global__ void flash_dq_reduce_kernel(const float* __restrict__ part,
                                       T* __restrict__ dq, int B, int Sq,
                                       int H, int D, int n_kt, int BT,
                                       int causal, int off) {
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
  dq[idx] = from_f<T>(acc);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D> constexpr int tile() { return D >= 256 ? 32 : 64; }

template <typename T, int D>
int launch_fwd(const FwdArgs& a, cudaStream_t st) {
  constexpr int BT = tile<D>();
  const size_t smem =
      sizeof(float) * (3 * BT * (D + 1) + BT * (BT + 1) + BT) +
      sizeof(int) * 2 * BT;
  auto kern = flash_fwd_kernel<T, D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.Sq / BT, a.H, a.B);
  kern<<<grid, BT * 4, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const BwdArgs& a, void* dq, cudaStream_t st) {
  constexpr int BT = tile<D>();
  {
    const long long rows = (long long)a.B * a.Sq * a.H;
    const int warps = 8;
    flash_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps),
                            warps * 32, 0, st>>>(
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.dos,
        const_cast<float*>(a.delta), a.B, a.Sq, a.H, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem =
      sizeof(float) * (4 * BT * (D + 1) + 2 * BT * (BT + 1) + 3 * BT) +
      sizeof(int) * 2 * BT;
  auto kern = flash_bwd_kernel<T, D, BT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.Sk / BT, a.H, a.B);
  kern<<<grid, BT * 4, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)a.B * a.Sq * a.H * D;
  flash_dq_reduce_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.dq_part, static_cast<T*>(dq), a.B, a.Sq, a.H, D, a.Sk / BT, BT,
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

// Tile rows of each kernel at head_dim D (Sq and Sk must be multiples).
extern "C" int pdt_flash_tile(int D) {
  return D >= 256 ? 32 : 64;
}

extern "C" int pdt_flash_fwd(
    int bf16, const void* q, const void* k, const void* v, const void* bias,
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
  if (bf16) {
    switch (D) {
      case 64: return launch_fwd<__nv_bfloat16, 64>(a, st);
      case 128: return launch_fwd<__nv_bfloat16, 128>(a, st);
      case 256: return launch_fwd<__nv_bfloat16, 256>(a, st);
    }
  } else {
    switch (D) {
      case 64: return launch_fwd<float, 64>(a, st);
      case 128: return launch_fwd<float, 128>(a, st);
      case 256: return launch_fwd<float, 256>(a, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int pdt_flash_bwd(
    int bf16, const void* q, const void* k, const void* v, const void* bias,
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
  if (bf16) {
    switch (D) {
      case 64: return launch_bwd<__nv_bfloat16, 64>(a, dq, st);
      case 128: return launch_bwd<__nv_bfloat16, 128>(a, dq, st);
      case 256: return launch_bwd<__nv_bfloat16, 256>(a, dq, st);
    }
  } else {
    switch (D) {
      case 64: return launch_bwd<float, 64>(a, dq, st);
      case 128: return launch_bwd<float, 128>(a, dq, st);
      case 256: return launch_bwd<float, 256>(a, dq, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
