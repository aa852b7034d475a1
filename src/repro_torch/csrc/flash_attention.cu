// Flash-attention forward for Hopper (sm_90a): online-softmax GQA attention
// with causal and sliding-window masks taken from absolute positions.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _flash_kernel).  Semantics are the Pallas kernel's: scale K**-0.5, mask
// kv_pos >= 0, causal kv_pos <= q_pos, window kv_pos > q_pos - window,
// masked scores -1e30 (so a row with no visible key averages v over the T
// keys), fp32 softmax state and accumulation, output in q's type.  Beyond
// the Pallas kernel it takes any Sq and T (Sq = 1 for decode), per-row query
// positions q_pos[B, Sq] (stride 0 over B for shared positions), and
// indexes the KV head of query head h as h / (H / G) instead of copying K/V
// per query head.  A row is one (query position, query head of KV group g)
// pair, so the query heads that share a KV head share each K/V load.
//
// One entry point, three routes; the caller picks one per call (ops.py,
// _flash_route) and every call is one launch:
//
// 1. decode (Sq == 1, float32 or bfloat16).  Bound by bytes: 2*T*K*size of
//    K/V per (b, g) against a handful of operations per byte.  A tensor-core
//    tile would be 1/16 used at one query position, so this runs on CUDA
//    cores.  One block per (b, g, up to 8 query heads of the group): 16
//    warps for one head (MHA), 8 for more, whose registers are larger.  The
//    block first reads kv_pos (4 B a key) to find the first and last key
//    its rows can see (they share one position); it visits only that range,
//    or all T if no key is visible.  The warps split the range into
//    contiguous runs of keys, each with its own (m, l, acc), and read K and
//    V straight from device memory into registers, 16 bytes a lane, 2 to 8
//    loads of each in flight per lane; the rows of the group sit in
//    registers and share each load.  The warps merge through shared memory
//    with the usual rescale, in the same launch: m starts at -1e30 (never
//    -inf), so the merge never forms exp(-inf - -inf), and a warp that
//    visited no key contributes l = 0.
// 2. mma_prefill (Sq > 1, bfloat16).  Bound by bytes as well at the serving
//    shapes (prefill S = 256 with 32 heads does 5.4e8 operations, 0.5 us at
//    989 TF/s, against 2.5 us of bytes), so getting off scalar FMA matters,
//    not the last factor of wgmma.  One block per (b, g, 64 rows).  K/V
//    tiles of 64 keys are staged in bf16 in a two-stage ring with cp.async
//    (16-byte copies, the next tile in flight while the current one is
//    used), rows padded by 16 bytes so ldmatrix reads are free of bank
//    conflicts.  QK^T and PV run on tensor cores with mma.sync m16n8k16
//    (bf16 in, fp32 accumulators in registers), fragments from ldmatrix
//    (.trans for V); the online softmax runs on the accumulator fragments,
//    with masks built from q_pos of the fragment's rows and kv_pos of its
//    columns, and P is rounded to bf16 for the PV product as the JAX model
//    rounds probabilities to v's type.  Four warps take 16 rows each; when
//    the grid has no more blocks than the card has SMs, eight warps split
//    each tile's keys between two warps per 16 rows and merge at the end,
//    which hides more latency in a grid too small to fill the card.  Short
//    prefills are latency-bound, so the block copies tile 0 together with
//    its queries, before it knows whether tile 0 is the first to visit.
//    mma.sync and not wgmma: at these shapes the operation bound is about a
//    fifth of the byte bound, and wgmma's swizzled shared-memory
//    descriptors bring a layout risk that buys nothing here.
// 3. fma (Sq > 1, float32).  The first port's kernel, unchanged: one block
//    of four warps per (b, g, 16 rows), K/V tiles of 32 keys staged as
//    fp32, plain FMA.  TF32 tensor cores would break float32's tolerance,
//    and this kernel already beats PyTorch's SDPA at the float32 shapes.
//
// Head dims: 64, 80, 120 and 128 (hubert-xlarge has 80, h2o-danube-3-4b
// 120), each a build of its own.  Every route tiles the head dim in powers
// of two or in 16s, so a route computes over a padded width and stages the
// dims past K as zeros, which add nothing to q.k and give output columns
// that are never stored: fma and decode pad 80 and 120 to 128 (decode's
// lanes past K load nothing, so no byte more is read), mma_prefill rounds
// up to its 16-element mma depth (80 stays, 120 -> 128; cp.async
// zero-fills the pad).  Rows stay 16-byte aligned at both widths in both
// types (160, 240, 320, 480 bytes), and the softmax scale is the true
// K**-0.5.
//
// Skipping keys, in every route: keys are skipped only where their weight
// is exactly 0 for every row of the block.  A masked key's weight is
// exp(-1e30 - m) = 0 once its row has seen a visible key, and keys past T
// (-inf) weigh 0 always, so a row with no visible key still averages v
// over all T keys.  Route 3 skips a tile whose keys are all masked for
// every row only once every row has seen a visible key.  Route 2 visits
// the tiles from the first to the last holding a key that some row may
// see, then the others only if some row has seen no visible key by then.
// Route 1 visits the keys from the first to the last visible one, or all T
// if none is.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPastT = INT_MIN;  // kv_pos stand-in for a key past the range a block visits

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// 16 bytes of T, widened to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& a, float* f) {
    f[0] = __uint_as_float(a.x); f[1] = __uint_as_float(a.y);
    f[2] = __uint_as_float(a.z); f[3] = __uint_as_float(a.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& a, float* f) {
    const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = to_f(static_cast<unsigned short>(w[i] & 0xffffu));
      f[2 * i + 1] = to_f(static_cast<unsigned short>(w[i] >> 16));
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Route 3: fma (float32, Sq > 1)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 int64_t q_pos_bstride, const int* __restrict__ kv_pos,
                 T* __restrict__ out, int Sq, int T_len, int H, int G,
                 int causal, int has_window, int window, float sm_scale) {
  constexpr int KP = K <= 64 ? 64 : 128;  // staged width: dims past K are zeros
  constexpr int DPL = KP / 32;  // output dimensions per lane
  constexpr int VN = Vec<T>::N;
  __shared__ __align__(16) float qs[kBQ][KP];
  __shared__ __align__(16) float ks[kBK][KP + 4];  // +4: conflict-free float4 rows
  __shared__ __align__(16) float vs[kBK][KP];

  const int b = blockIdx.z, g = blockIdx.y;
  const int Hg = H / G;
  const int R = Sq * Hg;  // rows of this (b, g): (query position, head) pairs
  const int row0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Stage the block's query rows, pre-scaled, in fp32.
  for (int i = tid; i < kBQ * KP; i += kThreads) {
    const int rr = i / KP, d = i % KP, r = row0 + rr;
    float val = 0.f;
    if (r < R && d < K) {
      const int s = r / Hg, h = g * Hg + r % Hg;
      val = to_f(q[((static_cast<int64_t>(b) * Sq + s) * H + h) * K + d]) * sm_scale;
    }
    qs[rr][d] = val;
  }

  bool valid[kRowsPerWarp];
  int qp[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;
    valid[i] = r < R;
    qp[i] = valid[i] ? q_pos[b * q_pos_bstride + r / Hg] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }
  const bool warp_active = valid[0];

  for (int t0 = 0; t0 < T_len; t0 += kBK) {
    const int t = t0 + lane;
    const bool in_range = t < T_len;
    const int kp = in_range ? kv_pos[t] : -1;
    bool allow[kRowsPerWarp];
    bool any_allowed = false, all_seen = true;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok = valid[i] && kp >= 0;
      if (causal) ok = ok && kp <= qp[i];
      if (has_window) ok = ok && kp > qp[i] - window;
      allow[i] = ok;
      any_allowed |= ok;
      all_seen &= !valid[i] || m[i] > kNegInf;
    }
    // Both barriers also fence the previous tile's reads of ks/vs.
    const int any_block = __syncthreads_or(any_allowed);
    const int seen_block = __syncthreads_and(all_seen);
    if (!any_block && seen_block) continue;

    for (int i = tid; i < kBK * (KP / VN); i += kThreads) {
      const int j = i / (KP / VN), c = (i % (KP / VN)) * VN;
      float fk[VN], fv[VN];
      if (t0 + j < T_len && c < K) {
        const int64_t off = ((static_cast<int64_t>(b) * T_len + t0 + j) * G + g) * K + c;
        Vec<T>::load(k + off, fk);
        Vec<T>::load(v + off, fv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        *reinterpret_cast<float4*>(&ks[j][c + e]) = make_float4(fk[e], fk[e + 1], fk[e + 2], fk[e + 3]);
        *reinterpret_cast<float4*>(&vs[j][c + e]) = make_float4(fv[e], fv[e + 1], fv[e + 2], fv[e + 3]);
      }
    }
    __syncthreads();
    if (!warp_active) continue;

    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(&ks[lane][0]);
#pragma unroll 8
    for (int d4 = 0; d4 < K / 4; ++d4) {  // the true width: pads add nothing
      const float4 kv4 = krow[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 q4 = reinterpret_cast<const float4*>(&qs[warp * kRowsPerWarp + i][0])[d4];
        s[i] = fmaf(q4.x, kv4.x, s[i]);
        s[i] = fmaf(q4.y, kv4.y, s[i]);
        s[i] = fmaf(q4.z, kv4.z, s[i]);
        s[i] = fmaf(q4.w, kv4.w, s[i]);
      }
    }

    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      // Keys past T get -inf (weight exactly 0); masked keys get -1e30.
      const float si = !in_range ? -INFINITY : (allow[i] ? s[i] : kNegInf);
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = expf(si - m_new);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= alpha;
    }

    const int jmax = min(kBK, T_len - t0);
    for (int j = 0; j < jmax; ++j) {
      float vv[DPL];
      if constexpr (DPL == 4) {
        const float4 a = reinterpret_cast<const float4*>(&vs[j][0])[lane];
        vv[0] = a.x; vv[1] = a.y; vv[2] = a.z; vv[3] = a.w;
      } else {
        const float2 a = reinterpret_cast<const float2*>(&vs[j][0])[lane];
        vv[0] = a.x; vv[1] = a.y;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = fmaf(pj, vv[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!valid[i]) continue;
    const int r = row0 + warp * kRowsPerWarp + i;
    const int s = r / Hg, h = g * Hg + r % Hg;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<int64_t>(b) * Sq + s) * H + h) * K + lane * DPL;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd)
      if (lane * DPL + dd < K) store(acc[i][dd] / denom, o + dd);
  }
}

// ---------------------------------------------------------------------------
// Route 1: decode (Sq == 1)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// RB: query heads of the group per block (the group's Hg rows, in blocks
// of RB); U: 16-byte loads of K (and of V) in flight per lane per step;
// W: warps per block.
template <typename T, int K, int RB, int U, int W>
__global__ void __launch_bounds__(W * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    int64_t q_pos_bstride, const int* __restrict__ kv_pos,
                    T* __restrict__ out, int T_len, int H, int G, int causal,
                    int has_window, int window, float scale_log2) {
  constexpr int KP = K <= 64 ? 64 : 128;  // row width in lanes' loads: dims past K are zeros
  constexpr int VN = Vec<T>::N;   // elements per 16-byte load
  constexpr int LPK = KP / VN;    // lanes per key row
  constexpr int KPI = 32 / LPK;   // keys per warp-wide load
  constexpr int CH = KPI * U;     // keys per warp step
  __shared__ float red_m[W][RB], red_l[W][RB];
  __shared__ __align__(16) float red_acc[W][RB][KP];
  __shared__ int lo_s, hi_s;

  const int b = blockIdx.z, g = blockIdx.y, Hg = H / G;
  const int h0 = g * Hg + blockIdx.x * RB;
  const int nrows = min(RB, Hg - static_cast<int>(blockIdx.x) * RB);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qp = q_pos[b * q_pos_bstride];
  auto visible = [&](int kp) {
    return kp >= 0 && (!causal || kp <= qp) && (!has_window || kp > qp - window);
  };

  const int slot = lane % LPK, kg = lane / LPK;  // dims [slot*VN, +VN) of key kg of a load
  const bool live = slot * VN < K;  // a lane past the true width loads nothing and holds zeros
  float qv[RB][VN];  // loaded first: its latency overlaps the scan below
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r < nrows && live) {
      Vec<T>::load(q + (static_cast<int64_t>(b) * H + h0 + r) * K + slot * VN, qv[r]);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) qv[r][e] = 0.f;
    }
  }

  // 1. The keys to visit: first to last visible key, or all T if none is.
  if (tid == 0) {
    lo_s = INT_MAX;
    hi_s = -1;
  }
  __syncthreads();
  int lo = INT_MAX, hi = -1;
  for (int t = tid; t < T_len; t += W * 32) {
    if (visible(kv_pos[t])) {
      lo = min(lo, t);
      hi = max(hi, t);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    atomicMin(&lo_s, lo);
    atomicMax(&hi_s, hi);
  }
  __syncthreads();
  lo = lo_s;
  hi = hi_s + 1;
  if (hi == 0) {
    lo = 0;
    hi = T_len;
  }

  // 2. A contiguous run of CH-key steps per warp.
  const int nsteps = (hi - lo + CH - 1) / CH;
  const int per = (nsteps + W - 1) / W;
  const int s_begin = warp * per, s_end = min(nsteps, s_begin + per);

#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int e = 0; e < VN; ++e) qv[r][e] *= scale_log2;
  }
  float m[RB], l[RB], acc[RB][VN];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[r][e] = 0.f;
  }

  const int64_t key_stride = static_cast<int64_t>(G) * K;
  const T* kb = k + (static_cast<int64_t>(b) * T_len * G + g) * K + slot * VN;
  const T* vb = v + (static_cast<int64_t>(b) * T_len * G + g) * K + slot * VN;
  for (int st = s_begin; st < s_end; ++st) {
    const int base = lo + st * CH;
    uint4 kr[U], vr[U];
    int kp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * KPI + kg;
      const int tt = t < hi ? t : lo;  // an in-range address; its weight is 0
      kr[u] = live ? load16(kb + tt * key_stride) : make_uint4(0u, 0u, 0u, 0u);
      vr[u] = live ? load16(vb + tt * key_stride) : make_uint4(0u, 0u, 0u, 0u);
      kp[u] = t < hi ? kv_pos[t] : kPastT;
    }
    float s[U][RB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VN];
      Vec<T>::unpack(kr[u], kf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float acc_s = 0.f;
#pragma unroll
        for (int e = 0; e < VN; ++e) acc_s = fmaf(qv[r][e], kf[e], acc_s);
        s[u][r] = acc_s;
      }
    }
#pragma unroll
    for (int o = 1; o < LPK; o <<= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int r = 0; r < RB; ++r) s[u][r] += __shfl_xor_sync(0xffffffffu, s[u][r], o);
      }
    }
    float alpha[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // Keys past the range get -inf (weight exactly 0); masked keys -1e30.
        const float x = kp[u] == kPastT ? -INFINITY : (visible(kp[u]) ? s[u][r] : kNegInf);
        s[u][r] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha[r];
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[r][e] *= alpha[r];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VN];
      Vec<T>::unpack(vr[u], vf);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float p = exp2f(s[u][r] - m[r]);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // 3. Sum the key groups of the warp (they share m), then merge the warps.
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
    if (kg == 0) {
#pragma unroll
      for (int e = 0; e < VN; e += 4) {
        *reinterpret_cast<float4*>(&red_acc[warp][r][slot * VN + e]) =
            make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
      }
    }
    if (lane == 0) {
      red_m[warp][r] = m[r];
      red_l[warp][r] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * K; i += W * 32) {
    const int r = i / K, d = i % K;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, red_m[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = exp2f(red_m[w][r] - mx);  // both finite: m >= -1e30
      den = fmaf(red_l[w][r], c, den);
      num = fmaf(red_acc[w][r][d], c, num);
    }
    store(num / fmaxf(den, 1e-30f), out + (static_cast<int64_t>(b) * H + h0 + r) * K + d);
  }
}

// ---------------------------------------------------------------------------
// Route 2: mma_prefill (bfloat16, Sq > 1)
// ---------------------------------------------------------------------------

constexpr int kRowGroups = 4;  // warps (of each key split) per block, 16 rows each
constexpr int kBM = kRowGroups * 16;  // rows per block
constexpr int kBN = 64;               // keys per tile
constexpr int kStages = 2;            // K/V tiles in the cp.async ring

// The width the tensor-core route computes over: K rounded up to the
// 16-element depth of an mma.sync step (120 -> 128; 64, 80, 128 stay);
// the dims past K are staged as zeros.
template <int K>
__host__ __device__ constexpr int mma_width() {
  return (K + 15) / 16 * 16;
}

template <int K>
constexpr size_t mma_smem_bytes() {
  // Q [kBM][KD+8] and kStages stages of K and V [kBN][KD+8] in bf16 and of
  // kv_pos [kBN]; with a key split, at the end the K stages hold the
  // second warp's partial output of each row group, [kRowGroups][16][KD+8]
  // fp32 (KD = mma_width<K>()).
  static_assert(kRowGroups * 16 * 4 <= kStages * kBN * 2, "partials must fit in the K stages");
  return (kBM + 2 * kStages * kBN) * (mma_width<K>() + 8) * sizeof(__nv_bfloat16) +
         kStages * kBN * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout of m16n8k16 (lane = 4 * gq + tq): an accumulator holds
// rows gq (c[0], c[1]) and gq + 8 (c[2], c[3]), columns 2 tq and 2 tq + 1.
// NH = 1: four warps, warp w takes rows 16 w .. +16 of the block.  NH = 2
// (for grids too small to fill the card): eight warps, warp w takes rows
// 16 (w % 4) .. +16 and keys 32 (w / 4) .. +32 of every tile, with its own
// (m, l, o), and the two warps of a row group merge at the end.
template <int K, int NH>
__global__ void __launch_bounds__(NH * kRowGroups * 32)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
                         int64_t q_pos_bstride, const int* __restrict__ kv_pos,
                         __nv_bfloat16* __restrict__ out, int Sq, int T_len, int H, int G,
                         int causal, int has_window, int window, float scale_log2) {
  constexpr int KD = mma_width<K>();  // computed width; dims [K, KD) are zeros
  constexpr int KP = KD + 8;  // padded row: 8 rows' 16-byte chunks fall in distinct banks
  constexpr int CPR = KD / 8;  // 16-byte chunks per staged row
  constexpr int CPK = K / 8;   // of them, the chunks that hold data
  constexpr int kMmaThreads = NH * kRowGroups * 32;
  constexpr int HN = kBN / NH;  // keys per warp per tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBM][KP]
  __nv_bfloat16* ks = qs + kBM * KP;                                // [kStages][kBN][KP]
  __nv_bfloat16* vs = ks + kStages * kBN * KP;                      // [kStages][kBN][KP]
  int* kvs = reinterpret_cast<int*>(vs + kStages * kBN * KP);       // [kStages][kBN]
  __shared__ int qlo_s, qhi_s, tlo_s, thi_s;
  __shared__ int row_seen[kBM];
  __shared__ float part_m[kBM], part_l[kBM];

  const int b = blockIdx.z, g = blockIdx.y, Hg = H / G, R = Sq * Hg;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBM;  // latest rows (most keys) first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = warp % kRowGroups, half = warp / kRowGroups;  // row group, key split
  const int gq = lane >> 2, tq = lane & 3;

  // Copies key tile j (K, V and kv_pos) into stage st; past T, zeros.
  auto load_tile = [&](int j, int st) {
    for (int x = tid; x < kBN * CPR; x += kMmaThreads) {
      const int jj = x / CPR, c = x % CPR, t = j * kBN + jj;
      const bool ok = t < T_len && c < CPK;
      const int64_t off = ok ? ((static_cast<int64_t>(b) * T_len + t) * G + g) * K + c * 8 : 0;
      cp_async16(smem_u32(ks + (st * kBN + jj) * KP + c * 8), k + off, ok);
      cp_async16(smem_u32(vs + (st * kBN + jj) * KP + c * 8), v + off, ok);
    }
    if (tid < kBN) {
      const int t = j * kBN + tid;
      cp_async4(smem_u32(kvs + st * kBN + tid), t < T_len ? kv_pos + t : kv_pos, t < T_len);
    }
  };

  // The block's query rows: row r is (position r / Hg, head g*Hg + r % Hg);
  // with them, tile 0, which is the first tile to visit unless a window or
  // empty slots mask all of it (checked below).  The positions load
  // meanwhile.
  for (int i = tid; i < kBM * CPR; i += kMmaThreads) {
    const int rr = i / CPR, c = i % CPR, r = row0 + rr;
    const bool ok = r < R && c < CPK;
    const __nv_bfloat16* src =
        ok ? q + ((static_cast<int64_t>(b) * Sq + r / Hg) * H + g * Hg + r % Hg) * K + c * 8 : q;
    cp_async16(smem_u32(qs + rr * KP + c * 8), src, ok);
  }
  load_tile(0, 0);
  cp_async_commit();
  constexpr int kPre = 2;  // kv_pos entries per thread loaded with the query positions
  int kp_pre[kPre];
#pragma unroll
  for (int e = 0; e < kPre; ++e) {
    const int t = tid + e * kMmaThreads;
    kp_pre[e] = t < T_len ? kv_pos[t] : -1;
  }
  if (tid == 0) {
    qlo_s = INT_MAX;
    qhi_s = INT_MIN;
    tlo_s = INT_MAX;
    thi_s = -1;
  }
  if (tid < kBM) row_seen[tid] = 0;
  bool valid[2];
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + rg * 16 + gq + 8 * i;
    valid[i] = r < R;
    qp[i] = valid[i] ? q_pos[b * q_pos_bstride + r / Hg] : 0;
  }
  __syncthreads();
  {
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (valid[i]) {
        lo = min(lo, qp[i]);
        hi = max(hi, qp[i]);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      atomicMin(&qlo_s, lo);
      atomicMax(&qhi_s, hi);
    }
  }
  __syncthreads();

  // The keys some row may see lie in tiles [first, last]: judged against
  // the block's least and greatest position, a superset of the exact test,
  // so every tile outside holds only keys masked for every row.
  {
    const int qmin = qlo_s, qmax = qhi_s;
    auto maybe_seen = [&](int kp) {
      return kp >= 0 && (!causal || kp <= qmax) && (!has_window || kp > qmin - window);
    };
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int e = 0; e < kPre; ++e) {
      const int t = tid + e * kMmaThreads;
      if (maybe_seen(kp_pre[e])) {
        lo = min(lo, t);
        hi = max(hi, t);
      }
    }
    for (int t = tid + kPre * kMmaThreads; t < T_len; t += kMmaThreads) {
      if (maybe_seen(kv_pos[t])) {
        lo = min(lo, t);
        hi = max(hi, t);
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
      atomicMin(&tlo_s, lo);
      atomicMax(&thi_s, hi);
    }
  }
  __syncthreads();
  const int nT = (T_len + kBN - 1) / kBN;
  const int first = thi_s < 0 ? 0 : tlo_s / kBN;
  const int nmain = thi_s < 0 ? 0 : thi_s / kBN - first + 1;
  // Visit order: tiles first..last, then the others, only if some row has
  // seen no visible key by then (it averages v over all T keys; for every
  // other row their weights are exactly 0).
  auto tile_of = [&](int i) { return i < nmain ? first + i : (i - nmain < first ? i - nmain : i); };
  // Issues the copies of visit i's tile into stage i % kStages, as one group.
  auto issue = [&](int i, int n) {
    if (i < n) load_tile(tile_of(i), i % kStages);
    cp_async_commit();
  };

  uint32_t qf[KD / 16][4];
  float o[KD / 8][4];
#pragma unroll
  for (int nb = 0; nb < KD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

  int n = nmain > 0 ? nmain : nT;
  if (tile_of(0) != 0) {  // tile 0 is not the first to visit: replace it
    cp_async_wait<0>();   // each thread rewrites only what it copied itself
    issue(0, n);
  }
#pragma unroll
  for (int i = 1; i < kStages - 1; ++i) issue(i, n);
  for (int i = 0; i < n;) {
    issue(i + kStages - 1, n);
    cp_async_wait<kStages - 1>();  // visit i's group has landed
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk)
        ldsm_x4(smem_u32(qs + (rg * 16 + (lane & 15)) * KP + kk * 16 + (lane >> 4) * 8), qf[kk]);
    }
    const int st = i % kStages;
    const int t0 = tile_of(i) * kBN + half * HN;  // this warp's first key
    const __nv_bfloat16* kst = ks + (st * kBN + half * HN) * KP;
    const __nv_bfloat16* vst = vs + (st * kBN + half * HN) * KP;
    const int* kvp = kvs + st * kBN + half * HN;

    // S = Q K^T: 16 rows x 32 keys.
    float s[HN / 8][4];
#pragma unroll
    for (int nb = 0; nb < HN / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < HN / 16; ++p) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(kst + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                         ((lane >> 3) & 1) * 8),
                bf);
        mma_bf16(s[2 * p], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * p + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // Masks and the online softmax on the fragments (log2 units).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < HN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * 8 + tq * 2 + e;
        const int kp = kvp[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x;
          if (t0 + col >= T_len) {
            x = -INFINITY;  // past T: weight exactly 0
          } else {
            const bool ok = valid[r] && kp >= 0 && (!causal || kp <= qp[r]) &&
                            (!has_window || kp > qp[r] - window);
            x = ok ? s[nb][2 * r + e] * scale_log2 : kNegInf;
          }
          s[nb][2 * r + e] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    uint32_t pf[HN / 16][4];  // P as A fragments, 16 keys each
#pragma unroll
    for (int nb = 0; nb < HN / 8; ++nb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = exp2f(s[nb][2 * r] - m[r]);
        const float p1 = exp2f(s[nb][2 * r + 1] - m[r]);
        l[r] += p0 + p1;
        pf[nb / 2][(nb & 1) * 2 + r] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int nb = 0; nb < KD / 8; ++nb) {
      o[nb][0] *= alpha[0];
      o[nb][1] *= alpha[0];
      o[nb][2] *= alpha[1];
      o[nb][3] *= alpha[1];
    }

    // O += P V.
#pragma unroll
    for (int j = 0; j < HN / 16; ++j) {
#pragma unroll
      for (int dp = 0; dp < KD / 16; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(smem_u32(vst + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KP +
                               dp * 16 + (lane >> 4) * 8),
                      bf);
        mma_bf16(o[2 * dp], pf[j], bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pf[j], bf[2], bf[3]);
      }
    }
    __syncthreads();  // before a later issue overwrites this stage
    ++i;
    if (i == n && n == nmain && nmain < nT) {
      // Has every row seen a visible key, in either half?  If not, visit
      // the rest of T.
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (m[r] > kNegInf) row_seen[rg * 16 + gq + 8 * r] = 1;
      __syncthreads();
      if (!__syncthreads_and(tid >= kBM || row0 + tid >= R || row_seen[tid])) {
        n = nT;
#pragma unroll
        for (int d = 0; d < kStages - 1; ++d) issue(i + d, n);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // With a key split, merge the two halves of each row group: the second
  // writes its m, l and o into the K stages, the first combines and stores.
  float* part_o = reinterpret_cast<float*>(ks);  // [kRowGroups][16][KP]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (NH == 2 && half == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rg * 16 + gq + 8 * r;
      if (tq == 0) {
        part_m[row] = m[r];
        part_l[row] = l[r];
      }
#pragma unroll
      for (int nb = 0; nb < K / 8; ++nb)
        *reinterpret_cast<float2*>(part_o + row * KP + nb * 8 + tq * 2) =
            make_float2(o[nb][2 * r], o[nb][2 * r + 1]);
    }
  }
  if (NH == 2) {
    __syncthreads();
    if (half == 1) return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    const int row = rg * 16 + gq + 8 * r, grow = row0 + row;
    float a1 = 1.f, a2 = 0.f, l2 = 0.f;
    if (NH == 2) {
      const float m2 = part_m[row], mm = fmaxf(m[r], m2);
      a1 = exp2f(m[r] - mm);  // both finite: m >= -1e30
      a2 = exp2f(m2 - mm);
      l2 = part_l[row];
    }
    const float denom = fmaxf(l[r] * a1 + l2 * a2, 1e-30f);
    __nv_bfloat16* orow =
        out + ((static_cast<int64_t>(b) * Sq + grow / Hg) * H + g * Hg + grow % Hg) * K + tq * 2;
#pragma unroll
    for (int nb = 0; nb < K / 8; ++nb) {  // the true width: columns past K are not stored
      float2 o2 = make_float2(0.f, 0.f);
      if (NH == 2) o2 = *reinterpret_cast<const float2*>(part_o + row * KP + nb * 8 + tq * 2);
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8) = __floats2bfloat162_rn(
          (o[nb][2 * r] * a1 + o2.x * a2) / denom, (o[nb][2 * r + 1] * a1 + o2.y * a2) / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Call {
  const void *q, *k, *v;
  const int* q_pos;
  int64_t q_pos_bstride;
  const int* kv_pos;
  void* out;
  int B, Sq, T_len, H, G, causal, has_window, window;
  cudaStream_t stream;
};

template <int K>
int launch_fma(const Call& c) {
  const dim3 grid((c.Sq * (c.H / c.G) + kBQ - 1) / kBQ, c.G, c.B);
  flash_fwd_kernel<float, K><<<grid, kThreads, 0, c.stream>>>(
      static_cast<const float*>(c.q), static_cast<const float*>(c.k),
      static_cast<const float*>(c.v), c.q_pos, c.q_pos_bstride, c.kv_pos,
      static_cast<float*>(c.out), c.Sq, c.T_len, c.H, c.G, c.causal, c.has_window, c.window,
      1.0f / sqrtf(static_cast<float>(K)));
  return int(cudaGetLastError());
}

template <typename T, int K, int RB>
int launch_decode_rb(const Call& c) {
  constexpr int U = RB == 1 ? 8 : (RB == 4 ? 4 : 2);  // registers: more rows, fewer loads in flight
  constexpr int W = RB == 1 ? 16 : 8;  // more warps where each holds fewer registers
  const dim3 grid((c.H / c.G + RB - 1) / RB, c.G, c.B);
  flash_decode_kernel<T, K, RB, U, W><<<grid, W * 32, 0, c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.k), static_cast<const T*>(c.v),
      c.q_pos, c.q_pos_bstride, c.kv_pos, static_cast<T*>(c.out), c.T_len, c.H, c.G,
      c.causal, c.has_window, c.window, kLog2e / sqrtf(static_cast<float>(K)));
  return int(cudaGetLastError());
}

template <typename T, int K>
int launch_decode(const Call& c) {
  const int Hg = c.H / c.G;
  if (Hg == 1) return launch_decode_rb<T, K, 1>(c);
  if (Hg <= 4) return launch_decode_rb<T, K, 4>(c);
  return launch_decode_rb<T, K, 8>(c);
}

template <int K, int NH>
int launch_mma_nh(const Call& c, const dim3& grid) {
  auto kernel = flash_prefill_mma_kernel<K, NH>;
  constexpr size_t smem = mma_smem_bytes<K>();
  static bool opted = false;  // once per instantiation
  if (!opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    opted = true;
  }
  kernel<<<grid, NH * kRowGroups * 32, smem, c.stream>>>(
      static_cast<const __nv_bfloat16*>(c.q), static_cast<const __nv_bfloat16*>(c.k),
      static_cast<const __nv_bfloat16*>(c.v), c.q_pos, c.q_pos_bstride, c.kv_pos,
      static_cast<__nv_bfloat16*>(c.out), c.Sq, c.T_len, c.H, c.G, c.causal, c.has_window,
      c.window, kLog2e / sqrtf(static_cast<float>(K)));
  return int(cudaGetLastError());
}

// Splits each key tile between two warps when one block per SM would
// leave SMs idle: the grid is then latency-bound, and eight warps a block
// hide more of it.  Larger grids keep four warps, whose registers let two
// blocks share an SM.
template <int K>
int launch_mma(const Call& c) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
  }
  const dim3 grid((c.Sq * (c.H / c.G) + kBM - 1) / kBM, c.G, c.B);
  if (static_cast<int64_t>(grid.x) * grid.y * grid.z <= sms) return launch_mma_nh<K, 2>(c, grid);
  return launch_mma_nh<K, 1>(c, grid);
}

// Calls f with K as a compile-time constant, for the head dims the routes
// are built for; cudaErrorInvalidValue for any other.
template <typename F>
int with_head_dim(int K, F f) {
  switch (K) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 120: return f(std::integral_constant<int, 120>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Sq,H,K], k/v [B,T,G,K], out [B,Sq,H,K], all contiguous and 16-byte
// aligned; q_pos int32 with q_pos[b*q_pos_bstride + s]; kv_pos int32 [T].
// dtype: 0 = float32, 1 = bfloat16; K is 64, 80, 120 or 128.  route: 0 =
// fma (float32), 1 = decode (Sq == 1), 2 = mma_prefill (bfloat16).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* q_pos, int64_t q_pos_bstride,
                                   const int* kv_pos, void* out, int B, int Sq,
                                   int T_len, int H, int G, int K, int causal,
                                   int has_window, int window, int dtype,
                                   int route, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || T_len <= 0 || G <= 0 || G > 65535 ||
      H % G != 0)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, q_pos, q_pos_bstride, kv_pos, out, B, Sq, T_len, H, G,
               causal, has_window, window, static_cast<cudaStream_t>(stream)};
  return with_head_dim(K, [&](auto kd) {
    constexpr int KD = decltype(kd)::value;
    if (route == 0 && dtype == 0) return launch_fma<KD>(c);
    if (route == 1 && Sq == 1 && dtype == 0) return launch_decode<float, KD>(c);
    if (route == 1 && Sq == 1 && dtype == 1) return launch_decode<__nv_bfloat16, KD>(c);
    if (route == 2 && dtype == 1) return launch_mma<KD>(c);
    return (int)cudaErrorInvalidValue;
  });
}
