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
// per query head.
//
// Bound on an H100: decode (Sq = 1, long T) is memory-bound at
// 2*B*T*G*K*bytes of K/V at 3.35 TB/s; prefill is compute-bound at
// 4*B*H*K*(visible query-key pairs) flop (about half of Sq*T when causal)
// against 989 TFLOP/s bf16.
//
// Design (simple and right first; wgmma/TMA come later): one block of four
// warps per (batch b, KV head g, tile of 16 rows), where a row is one
// (query position, query head of group g) pair, so the query heads that
// share a KV head share each K/V tile and decode with GQA keeps several
// rows busy.  K/V tiles of 32 keys are staged through shared memory as
// fp32.  In the QK^T product lane j owns key j and sums over K with
// conflict-free 16-byte shared loads (rows padded by 4 floats); row max
// and sum use warp shuffles; in the PV product lane j owns K/32 output
// dimensions and receives each probability by shuffle.  Plain FMA, no
// tensor cores.  A tile that masks every row of the block is skipped
// only once every row has seen a visible key: its probabilities would be
// exp(-1e30 - m) = 0 exactly, so skipping cannot change a fully masked
// row's mean-of-v output.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // rows per block
constexpr int kBK = 32;                     // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(unsigned short bits) {
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

// Loads 16 bytes of T from global memory and widens them to fp32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = to_f(static_cast<unsigned short>(w[i] & 0xffffu));
      f[2 * i + 1] = to_f(static_cast<unsigned short>(w[i] >> 16));
    }
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 int64_t q_pos_bstride, const int* __restrict__ kv_pos,
                 T* __restrict__ out, int Sq, int T_len, int H, int G,
                 int causal, int has_window, int window, float sm_scale) {
  constexpr int DPL = K / 32;  // output dimensions per lane
  constexpr int VN = Vec<T>::N;
  __shared__ __align__(16) float qs[kBQ][K];
  __shared__ __align__(16) float ks[kBK][K + 4];  // +4: conflict-free float4 rows
  __shared__ __align__(16) float vs[kBK][K];

  const int b = blockIdx.z, g = blockIdx.y;
  const int Hg = H / G;
  const int R = Sq * Hg;  // rows of this (b, g): (query position, head) pairs
  const int row0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Stage the block's query rows, pre-scaled, in fp32.
  for (int i = tid; i < kBQ * K; i += kThreads) {
    const int rr = i / K, d = i % K, r = row0 + rr;
    float val = 0.f;
    if (r < R) {
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

    for (int i = tid; i < kBK * (K / VN); i += kThreads) {
      const int j = i / (K / VN), c = (i % (K / VN)) * VN;
      float fk[VN], fv[VN];
      if (t0 + j < T_len) {
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
    for (int d4 = 0; d4 < K / 4; ++d4) {
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
    for (int dd = 0; dd < DPL; ++dd) store(acc[i][dd] / denom, o + dd);
  }
}

template <typename T, int K>
void launch(const void* q, const void* k, const void* v, const int* q_pos,
            int64_t q_pos_bstride, const int* kv_pos, void* out, int B,
            int Sq, int T_len, int H, int G, int causal, int has_window,
            int window, cudaStream_t stream) {
  const int rows = Sq * (H / G);
  const dim3 grid((rows + kBQ - 1) / kBQ, G, B);
  flash_fwd_kernel<T, K><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, q_pos_bstride, kv_pos,
      static_cast<T*>(out), Sq, T_len, H, G, causal, has_window, window,
      1.0f / sqrtf(static_cast<float>(K)));
}

}  // namespace

// q [B,Sq,H,K], k/v [B,T,G,K], out [B,Sq,H,K], all contiguous and 16-byte
// aligned; q_pos int32 with q_pos[b*q_pos_bstride + s]; kv_pos int32 [T].
// dtype: 0 = float32, 1 = bfloat16; K is 64 or 128.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const int* q_pos, int64_t q_pos_bstride,
                                   const int* kv_pos, void* out, int B, int Sq,
                                   int T_len, int H, int G, int K, int causal,
                                   int has_window, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || T_len <= 0 || G <= 0 || G > 65535 ||
      H % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(TYPE, KDIM)                                                \
  launch<TYPE, KDIM>(q, k, v, q_pos, q_pos_bstride, kv_pos, out, B, Sq, T_len, \
                     H, G, causal, has_window, window, s)
  if (dtype == 0 && K == 128) FLASH_CASE(float, 128);
  else if (dtype == 0 && K == 64) FLASH_CASE(float, 64);
  else if (dtype == 1 && K == 128) FLASH_CASE(__nv_bfloat16, 128);
  else if (dtype == 1 && K == 64) FLASH_CASE(__nv_bfloat16, 64);
  else return (int)cudaErrorInvalidValue;
#undef FLASH_CASE
  return (int)cudaGetLastError();
}
