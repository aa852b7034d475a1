// Flash-attention backward for Hopper (sm_90a), bfloat16: the gradients of
// flash_attention.cu's attention in q, k and v, in two launches, with no
// score tensor ever written to device memory.
//
// It replaces no TPU kernel: the JAX package's backward (repro/kernels/ops.py,
// _fa_bwd) recomputes the plain attention and differentiates it, and so did
// this port before these kernels, in float32 (ops._vjp of
// ref.flash_attention_ref): six full [Sq, T] products on CUDA cores and a
// dozen [Sq, T] fp32 tensors a call, 62.9 ms on an H100 at the call of
// deepseek-7b's 8k training cell (B=2, S=4096, 32 heads of 128), most of
// its step's device time.  Here the gradient is eight products of the
// forward's size on tensor cores, masked tiles skipped (S three times, dP
// twice, dV, dQ, dK), and O(Sq + T) bytes besides the inputs: bound by
// operations, the five products a backward needs (S, dP, dV, dQ, dK) at
// 989 TF/s bf16 (chip_smoke.py's flash_bwd_bound).
//
// Semantics are ref.flash_attention_bwd_ref's, the plain version's gradient:
// scale K**-0.5, masks from q_pos / kv_pos as in the forward, a masked score
// -1e30, so a row with no visible key weighs every key of T by 1/T.  With
// P = softmax(S) and D = rowsum(dO o O) (O the forward's output):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D), 0 where the mask is false,
//   dQ = scale dS K,  dK = scale dS^T Q.
// The mask's zero matters for a row with no visible key: its P is 1/T and
// reaches dV, but its scores get no gradient, as through the plain version's
// `where`.
//
// Rows as in the forward: (query position, query head of KV group g), Hg of
// them a position, tiles of 64 rows.  Two kernels, one stream, no atomics
// (the gradient is the same bits run to run):
//
// 1. flash_bwd_dq_kernel, one block per (b, g, row tile), four warps of 16
//    rows.  First D from dO and O; then sweep 1 over the key tiles some row
//    may see (the forward's "first to last" tiles): the row max m and sum l,
//    QK^T only.  A row that saw no key keeps m = -1e30 and gets l = T, what
//    summing exp(0) over all T keys gives.  m, l and D go to a fp32 scratch
//    [3][B, G, R] (R = Sq Hg rows, in the forward's row order), and the tile's
//    least and greatest query position and whether it holds such a blind row
//    to a scratch of row tiles.  Sweep 2 over the same key tiles: S again,
//    P = exp(S - m) / l, dP = dO V^T, dS, and dQ += dS K in registers; a
//    blind row's dS is 0 everywhere, so no tile outside the sweep adds to dQ.
// 2. flash_bwd_dkdv_kernel, one block per (b, g, 64 keys), four warps of 16
//    keys, K and V of the block held in shared memory.  It visits every row
//    tile whose positions may see one of its keys (judged from the tile's
//    least and greatest position against the keys', a superset of the exact
//    test), and every tile holding a blind row (whose 1/T weights reach
//    every key's dV), in order; each visit recomputes S^T = K Q^T for 32 rows
//    at a time, P from the saved m and l, then dV += P^T dO, dP^T = V dO^T,
//    dS^T, dK += dS^T Q.  The query heads of a KV group are rows of the same
//    tiles, so GQA adds over them inside the block.
//
// Both use the forward's mma_prefill machinery (flash_mma.cuh): mma.sync
// m16n8k16 with bf16 operands and fp32 accumulators, ldmatrix fragments
// (.trans where the product runs over the tile's rows), and a two-stage
// cp.async ring of the tiles that change (K/V in kernel 1, Q/dO and the rows'
// m, l, D and positions in kernel 2), rows padded by 16 bytes.  P and dS are
// rounded to bf16 for their products, as the forward rounds P for PV.  Head
// dims 16, 64, 80, 120 and 128 at the forward's mma_width<K> (120 computed as
// 128 over zeros); per-row q_pos [B, Sq], windows, non-causal calls and
// Sq != T are all taken.  mma.sync and not wgmma: the first version is
// meant to take the fp32 plain backward off the step; wgmma is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarpsB = 4;
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kTile = 64;    // rows of a row tile, keys of a key tile
constexpr int kRingB = 2;    // stages of the cp.async ring
constexpr int kHalf = 32;    // rows of a row tile kernel 2 takes at a time

// What kernel 1 leaves of each (b, g, row tile) for kernel 2.
struct RowTile {
  int qlo, qhi;  // least and greatest query position of the tile's rows
  int blind;     // some row of the tile sees no key
  int pad;
};

// Shared memory of either kernel: six bf16 tiles [kTile][KD+8] (kernel 1: Q,
// dO and two stages of K and V; kernel 2: K, V and two stages of Q and dO),
// then kernel 2's per-row floats and positions, two stages of four arrays
// (kernel 1 uses the first stage's worth for its kv_pos stages).
template <int K>
constexpr size_t bwd_smem_bytes() {
  return 6 * kTile * (mma_width<K>() + 8) * sizeof(bf16) + kRingB * 4 * kTile * sizeof(float);
}

__device__ __forceinline__ void unpack8(const uint4& a, float* f) {
  const unsigned int w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ bool visible(int kp, int qp, int causal, int has_window, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (!has_window || kp > qp - window);
}

// ---------------------------------------------------------------------------
// Kernel 1: D, m, l and dQ
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(kThreadsB)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout, const int* __restrict__ q_pos,
                    int64_t q_pos_bstride, const int* __restrict__ kv_pos,
                    bf16* __restrict__ dq, float* __restrict__ stats,
                    RowTile* __restrict__ tiles, int Sq, int T_len, int H, int G, int causal,
                    int has_window, int window, float scale_log2, float scale) {
  constexpr int KD = mma_width<K>();
  constexpr int KP = KD + 8;  // padded row: 8 rows' 16-byte chunks fall in distinct banks
  constexpr int CPR = KD / 8;  // 16-byte chunks per staged row
  constexpr int CPK = K / 8;   // of them, the chunks that hold data
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTile][KP]
  bf16* dos = qs + kTile * KP;                    // [kTile][KP]
  bf16* ks = dos + kTile * KP;                    // [kRingB][kTile][KP]
  bf16* vs = ks + kRingB * kTile * KP;            // [kRingB][kTile][KP]
  int* kvs = reinterpret_cast<int*>(vs + kRingB * kTile * KP);  // [kRingB][kTile]
  __shared__ int qlo_s, qhi_s, tlo_s, thi_s, blind_s;
  __shared__ float d_s[kTile];

  const int b = blockIdx.z, g = blockIdx.y, Hg = H / G, R = Sq * Hg;
  const int tile = gridDim.x - 1 - blockIdx.x;  // latest rows (most keys) first
  const int row0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t bg = static_cast<int64_t>(b) * G + g;
  const int64_t nstat = static_cast<int64_t>(gridDim.z) * gridDim.y * R;
  auto row_off = [&](int r) {  // element offset of row r in q, o, dout, dq
    return ((static_cast<int64_t>(b) * Sq + r / Hg) * H + g * Hg + r % Hg) * K;
  };

  // The tile's Q and dO rows, as one cp.async group.
  for (int i = tid; i < kTile * CPR; i += kThreadsB) {
    const int rr = i / CPR, c = i % CPR, r = row0 + rr;
    const bool ok = r < R && c < CPK;
    const int64_t off = ok ? row_off(r) + c * 8 : 0;
    cp_async16(smem_u32(qs + rr * KP + c * 8), q + off, ok);
    cp_async16(smem_u32(dos + rr * KP + c * 8), dout + off, ok);
  }
  cp_async_commit();

  if (tid == 0) {
    qlo_s = INT_MAX;
    qhi_s = INT_MIN;
    tlo_s = INT_MAX;
    thi_s = -1;
    blind_s = 0;
  }
  // D = rowsum(dO o O) in fp32: two threads a row, 16-byte loads.
  {
    const int rr = tid >> 1, part = tid & 1, r = row0 + rr;
    float acc = 0.f;
    if (r < R) {
      const int64_t base = row_off(r);
      for (int c = part; c < CPK; c += 2) {
        float fo[8], fd[8];
        unpack8(*reinterpret_cast<const uint4*>(o + base + c * 8), fo);
        unpack8(*reinterpret_cast<const uint4*>(dout + base + c * 8), fd);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(fo[e], fd[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) d_s[rr] = acc;
  }
  bool valid[2];
  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + warp * 16 + gq + 8 * i;
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
  // The key tiles [first, first + n) hold every key some row may see (judged
  // against the tile's least and greatest position, a superset of the exact
  // test, as in the forward).
  {
    const int qmin = qlo_s, qmax = qhi_s;
    int lo = INT_MAX, hi = -1;
    for (int t = tid; t < T_len; t += kThreadsB) {
      const int kp = kv_pos[t];
      if (kp >= 0 && (!causal || kp <= qmax) && (!has_window || kp > qmin - window)) {
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
  const int first = thi_s < 0 ? 0 : tlo_s / kTile;
  const int n = thi_s < 0 ? 0 : thi_s / kTile - first + 1;
  const float d_row[2] = {d_s[warp * 16 + gq], d_s[warp * 16 + gq + 8]};

  // Copies key tile j (K, V if with_v, and kv_pos) into stage st; past T, zeros.
  auto load_tile = [&](int j, int st, bool with_v) {
    for (int x = tid; x < kTile * CPR; x += kThreadsB) {
      const int jj = x / CPR, c = x % CPR, t = j * kTile + jj;
      const bool ok = t < T_len && c < CPK;
      const int64_t off = ok ? ((static_cast<int64_t>(b) * T_len + t) * G + g) * K + c * 8 : 0;
      cp_async16(smem_u32(ks + (st * kTile + jj) * KP + c * 8), k + off, ok);
      if (with_v) cp_async16(smem_u32(vs + (st * kTile + jj) * KP + c * 8), v + off, ok);
    }
    if (tid < kTile) {
      const int t = j * kTile + tid;
      cp_async4(smem_u32(kvs + st * kTile + tid), t < T_len ? kv_pos + t : kv_pos, t < T_len);
    }
  };

  uint32_t qf[KD / 16][4];
  // S = Q K^T of this warp's 16 rows and the 64 keys in stage st, in log2
  // units, masked: -1e30 where the mask is false, -inf past T.  Bit
  // 4 nb + 2 r + e of the result: accumulator element (nb, 2 r + e) visible.
  auto scores = [&](int st, int t0, float (&s)[kTile / 8][4]) {
    const bf16* kst = ks + st * kTile * KP;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < kTile / 16; ++p) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(kst + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                         ((lane >> 3) & 1) * 8),
                bf);
        mma_bf16(s[2 * p], qf[kk], bf[0], bf[1]);
        mma_bf16(s[2 * p + 1], qf[kk], bf[2], bf[3]);
      }
    }
    uint32_t bits = 0;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nb * 8 + tq * 2 + e;
        const int kp = kvs[st * kTile + col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x;
          if (t0 + col >= T_len) {
            x = -INFINITY;  // past T: weight exactly 0
          } else {
            const bool ok = valid[r] && visible(kp, qp[r], causal, has_window, window);
            x = ok ? s[nb][2 * r + e] * scale_log2 : kNegInf;
            bits |= static_cast<uint32_t>(ok) << (4 * nb + 2 * r + e);
          }
          s[nb][2 * r + e] = x;
        }
      }
    }
    return bits;
  };

  // Sweep 1: m and l over tiles [first, first + n), K only.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only
  if (n > 0) load_tile(first, 0, false);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_tile(first + i + 1, (i + 1) % kRingB, false);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and tile i have landed
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk)
        ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * KP + kk * 16 + (lane >> 4) * 8), qf[kk]);
    }
    float s[kTile / 8][4];
    scores(i % kRingB, (first + i) * kTile, s);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb)
        sum += exp2f(s[nb][2 * r] - mx[r]) + exp2f(s[nb][2 * r + 1] - mx[r]);
      l[r] = l[r] * exp2f(m[r] - mx[r]) + sum;
      m[r] = mx[r];
    }
    __syncthreads();  // before a later load overwrites this stage
  }
  cp_async_wait<0>();
  __syncthreads();
  float linv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const bool blind = valid[r] && m[r] == kNegInf;
    if (blind) {
      l[r] = static_cast<float>(T_len);  // exp(-1e30 - -1e30) = 1 for each of the T keys
      blind_s = 1;
    }
    linv[r] = valid[r] ? 1.f / l[r] : 0.f;
    const int r_abs = row0 + warp * 16 + gq + 8 * r;
    if (valid[r] && tq == 0) {
      const int64_t at = bg * R + r_abs;
      stats[at] = m[r];
      stats[nstat + at] = l[r];
      stats[2 * nstat + at] = d_row[r];
    }
  }
  __syncthreads();
  if (tid == 0) tiles[bg * gridDim.x + tile] = RowTile{qlo_s, qhi_s, blind_s, 0};

  // Sweep 2: dQ over the same tiles, K and V.
  float acc[KD / 8][4];
#pragma unroll
  for (int nb = 0; nb < KD / 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
  if (n > 0) load_tile(first, 0, true);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_tile(first + i + 1, (i + 1) % kRingB, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = i % kRingB;
    float s[kTile / 8][4];
    const uint32_t bits = scores(st, (first + i) * kTile, s);
    // dP = dO V^T
    float dp[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
    const bf16* vst = vs + st * kTile * KP;
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(smem_u32(dos + (warp * 16 + (lane & 15)) * KP + kk * 16 + (lane >> 4) * 8), af);
#pragma unroll
      for (int p = 0; p < kTile / 16; ++p) {
        uint32_t bf[4];
        ldsm_x4(smem_u32(vst + (p * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                         ((lane >> 3) & 1) * 8),
                bf);
        mma_bf16(dp[2 * p], af, bf[0], bf[1]);
        mma_bf16(dp[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    // dS = P o (dP - D), 0 where masked, as A fragments of 16 keys each
    uint32_t dsf[kTile / 16][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[nb][2 * r + e] - m[r]) * linv[r];
          ds[e] = (bits >> (4 * nb + 2 * r + e)) & 1u ? p * (dp[nb][2 * r + e] - d_row[r]) : 0.f;
        }
        dsf[nb / 2][(nb & 1) * 2 + r] = pack_bf16(ds[0], ds[1]);
      }
    }
    // dQ += dS K
    const bf16* kst = ks + st * kTile * KP;
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
#pragma unroll
      for (int dpi = 0; dpi < KD / 16; ++dpi) {
        uint32_t bf[4];
        ldsm_x4_trans(smem_u32(kst + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KP +
                               dpi * 16 + (lane >> 4) * 8),
                      bf);
        mma_bf16(acc[2 * dpi], dsf[j], bf[0], bf[1]);
        mma_bf16(acc[2 * dpi + 1], dsf[j], bf[2], bf[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!valid[r]) continue;
    bf16* row = dq + row_off(row0 + warp * 16 + gq + 8 * r) + tq * 2;
#pragma unroll
    for (int nb = 0; nb < K / 8; ++nb)  // the true width: columns past K are not stored
      *reinterpret_cast<__nv_bfloat162*>(row + nb * 8) =
          __floats2bfloat162_rn(acc[nb][2 * r] * scale, acc[nb][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: dK and dV
// ---------------------------------------------------------------------------

template <int K>
__global__ void __launch_bounds__(kThreadsB)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const int* __restrict__ q_pos, int64_t q_pos_bstride,
                      const int* __restrict__ kv_pos, const float* __restrict__ stats,
                      const RowTile* __restrict__ tiles, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int Sq, int T_len, int H, int G, int causal,
                      int has_window, int window, float scale_log2, float scale) {
  constexpr int KD = mma_width<K>();
  constexpr int KP = KD + 8;
  constexpr int CPR = KD / 8;
  constexpr int CPK = K / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kTile][KP]
  bf16* vs = ks + kTile * KP;                     // [kTile][KP]
  bf16* qs = vs + kTile * KP;                     // [kRingB][kTile][KP]
  bf16* dos = qs + kRingB * kTile * KP;           // [kRingB][kTile][KP]
  float* rows = reinterpret_cast<float*>(dos + kRingB * kTile * KP);  // [kRingB][4][kTile]
  __shared__ int kmin_s, kmax_s;

  const int b = blockIdx.z, g = blockIdx.y, Hg = H / G, R = Sq * Hg;
  const int nRT = (R + kTile - 1) / kTile;
  const int key0 = blockIdx.x * kTile;  // earliest keys (most rows) first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int64_t bg = static_cast<int64_t>(b) * G + g;
  const int64_t nstat = static_cast<int64_t>(gridDim.z) * gridDim.y * R;

  // The block's K and V, as one cp.async group.
  for (int x = tid; x < kTile * CPR; x += kThreadsB) {
    const int jj = x / CPR, c = x % CPR, t = key0 + jj;
    const bool ok = t < T_len && c < CPK;
    const int64_t off = ok ? ((static_cast<int64_t>(b) * T_len + t) * G + g) * K + c * 8 : 0;
    cp_async16(smem_u32(ks + jj * KP + c * 8), k + off, ok);
    cp_async16(smem_u32(vs + jj * KP + c * 8), v + off, ok);
  }
  cp_async_commit();
  if (tid == 0) {
    kmin_s = INT_MAX;
    kmax_s = -1;
  }
  // The positions of this thread's accumulator rows: keys 16 warp + gq + 8 i.
  bool kin[2];
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = key0 + warp * 16 + gq + 8 * i;
    kin[i] = t < T_len;
    kp[i] = kin[i] ? kv_pos[t] : -1;
  }
  __syncthreads();
  {
    const int t = key0 + tid;
    const int p = tid < kTile && t < T_len ? kv_pos[t] : -1;
    const int lo = __reduce_min_sync(0xffffffffu, p >= 0 ? p : INT_MAX);
    const int hi = __reduce_max_sync(0xffffffffu, p);
    if (lane == 0) {
      atomicMin(&kmin_s, lo);
      atomicMax(&kmax_s, hi);
    }
  }
  __syncthreads();
  const int kmin = kmin_s, kmax = kmax_s;  // over the block's keys with kv_pos >= 0

  // Row tile i is visited if some row of it may see a key of the block, or
  // if it holds a row that sees no key at all.
  auto visit = [&](int i) {
    const RowTile rt = tiles[bg * nRT + i];
    return rt.blind ||
           (kmax >= 0 && (!causal || kmin <= rt.qhi) && (!has_window || kmax > rt.qlo - window));
  };
  auto next_visit = [&](int i) {
    while (i < nRT && !visit(i)) ++i;
    return i;
  };
  // Copies row tile i's Q, dO, m, l, D and positions into stage st; rows past
  // R as zeros.
  auto load_rows = [&](int i, int st) {
    const int row0 = i * kTile;
    for (int x = tid; x < kTile * CPR; x += kThreadsB) {
      const int rr = x / CPR, c = x % CPR, r = row0 + rr;
      const bool ok = r < R && c < CPK;
      const int64_t off =
          ok ? ((static_cast<int64_t>(b) * Sq + r / Hg) * H + g * Hg + r % Hg) * K + c * 8 : 0;
      cp_async16(smem_u32(qs + (st * kTile + rr) * KP + c * 8), q + off, ok);
      cp_async16(smem_u32(dos + (st * kTile + rr) * KP + c * 8), dout + off, ok);
    }
    if (tid < kTile) {
      const int r = row0 + tid;
      const bool ok = r < R;
      const int64_t at = ok ? bg * R + r : 0;
      float* rs = rows + st * 4 * kTile + tid;
      cp_async4(smem_u32(rs), stats + at, ok);                           // m
      cp_async4(smem_u32(rs + kTile), stats + nstat + at, ok);           // l
      cp_async4(smem_u32(rs + 2 * kTile), stats + 2 * nstat + at, ok);   // D
      cp_async4(smem_u32(rs + 3 * kTile), ok ? q_pos + b * q_pos_bstride + r / Hg : q_pos, ok);
    }
  };

  float dka[KD / 8][4], dva[KD / 8][4];
#pragma unroll
  for (int nb = 0; nb < KD / 8; ++nb) {
    dka[nb][0] = dka[nb][1] = dka[nb][2] = dka[nb][3] = 0.f;
    dva[nb][0] = dva[nb][1] = dva[nb][2] = dva[nb][3] = 0.f;
  }
  const bf16* kw = ks + warp * 16 * KP;  // this warp's 16 keys
  const bf16* vw = vs + warp * 16 * KP;

  int cur = next_visit(0);
  if (cur < nRT) load_rows(cur, 0);
  cp_async_commit();
  for (int it = 0; cur < nRT; ++it) {
    const int st = it % kRingB;
    const int nxt = next_visit(cur + 1);
    if (nxt < nRT) load_rows(nxt, (it + 1) % kRingB);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this visit's rows have landed
    __syncthreads();
    const bf16* qst = qs + st * kTile * KP;
    const bf16* dost = dos + st * kTile * KP;
    const float* rm = rows + st * 4 * kTile;
    const float* rl = rm + kTile;
    const float* rd = rm + 2 * kTile;
    const int* rqp = reinterpret_cast<const int*>(rm + 3 * kTile);
    const int row0 = cur * kTile;
#pragma unroll 1
    for (int h0 = 0; h0 < kTile; h0 += kHalf) {
      // S^T = K Q^T: this warp's 16 keys x 32 rows
      float s[kHalf / 8][4];
#pragma unroll
      for (int nb = 0; nb < kHalf / 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(smem_u32(kw + (lane & 15) * KP + kk * 16 + (lane >> 4) * 8), af);
#pragma unroll
        for (int p = 0; p < kHalf / 16; ++p) {
          uint32_t bf[4];
          ldsm_x4(smem_u32(qst + (h0 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  bf);
          mma_bf16(s[2 * p], af, bf[0], bf[1]);
          mma_bf16(s[2 * p + 1], af, bf[2], bf[3]);
        }
      }
      // P^T from the rows' m and l; the mask bits as in kernel 1
      uint32_t bits = 0;
#pragma unroll
      for (int nb = 0; nb < kHalf / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = h0 + nb * 8 + tq * 2 + e;
          const bool rvalid = row0 + col < R;
          const int qpc = rqp[col];
          const float mc = rm[col], li = rvalid ? 1.f / rl[col] : 0.f;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool ok = rvalid && kin[i] && visible(kp[i], qpc, causal, has_window, window);
            const float x = !kin[i] ? -INFINITY : (ok ? s[nb][2 * i + e] * scale_log2 : kNegInf);
            s[nb][2 * i + e] = exp2f(x - mc) * li;
            bits |= static_cast<uint32_t>(ok) << (4 * nb + 2 * i + e);
          }
        }
      }
      // dV += P^T dO
      {
        uint32_t pf[kHalf / 16][4];
#pragma unroll
        for (int nb = 0; nb < kHalf / 8; ++nb) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            pf[nb / 2][(nb & 1) * 2 + i] = pack_bf16(s[nb][2 * i], s[nb][2 * i + 1]);
        }
#pragma unroll
        for (int j = 0; j < kHalf / 16; ++j) {
#pragma unroll
          for (int dpi = 0; dpi < KD / 16; ++dpi) {
            uint32_t bf[4];
            ldsm_x4_trans(smem_u32(dost + (h0 + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KP +
                                   dpi * 16 + (lane >> 4) * 8),
                          bf);
            mma_bf16(dva[2 * dpi], pf[j], bf[0], bf[1]);
            mma_bf16(dva[2 * dpi + 1], pf[j], bf[2], bf[3]);
          }
        }
      }
      // dP^T = V dO^T
      float dp[kHalf / 8][4];
#pragma unroll
      for (int nb = 0; nb < kHalf / 8; ++nb) dp[nb][0] = dp[nb][1] = dp[nb][2] = dp[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(smem_u32(vw + (lane & 15) * KP + kk * 16 + (lane >> 4) * 8), af);
#pragma unroll
        for (int p = 0; p < kHalf / 16; ++p) {
          uint32_t bf[4];
          ldsm_x4(smem_u32(dost + (h0 + p * 16 + (lane & 7) + ((lane >> 4) << 3)) * KP + kk * 16 +
                           ((lane >> 3) & 1) * 8),
                  bf);
          mma_bf16(dp[2 * p], af, bf[0], bf[1]);
          mma_bf16(dp[2 * p + 1], af, bf[2], bf[3]);
        }
      }
      // dS^T = P^T o (dP^T - D), 0 where masked; dK += dS^T Q
      uint32_t dsf[kHalf / 16][4];
#pragma unroll
      for (int nb = 0; nb < kHalf / 8; ++nb) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = h0 + nb * 8 + tq * 2 + e;
            const bool ok = (bits >> (4 * nb + 2 * i + e)) & 1u;
            ds[e] = ok ? s[nb][2 * i + e] * (dp[nb][2 * i + e] - rd[col]) : 0.f;
          }
          dsf[nb / 2][(nb & 1) * 2 + i] = pack_bf16(ds[0], ds[1]);
        }
      }
#pragma unroll
      for (int j = 0; j < kHalf / 16; ++j) {
#pragma unroll
        for (int dpi = 0; dpi < KD / 16; ++dpi) {
          uint32_t bf[4];
          ldsm_x4_trans(smem_u32(qst + (h0 + j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * KP +
                                 dpi * 16 + (lane >> 4) * 8),
                        bf);
          mma_bf16(dka[2 * dpi], dsf[j], bf[0], bf[1]);
          mma_bf16(dka[2 * dpi + 1], dsf[j], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // before a later load overwrites this stage
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!kin[i]) continue;
    const int t = key0 + warp * 16 + gq + 8 * i;
    const int64_t at = ((static_cast<int64_t>(b) * T_len + t) * G + g) * K + tq * 2;
#pragma unroll
    for (int nb = 0; nb < K / 8; ++nb) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + nb * 8) =
          __floats2bfloat162_rn(dka[nb][2 * i] * scale, dka[nb][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + nb * 8) =
          __floats2bfloat162_rn(dva[nb][2 * i], dva[nb][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launcher
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& opted) {
  if (opted) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  opted = e == cudaSuccess;
  return e;
}

struct BwdCall {
  const bf16 *q, *k, *v, *out, *dout;
  const int* q_pos;
  int64_t q_pos_bstride;
  const int* kv_pos;
  bf16 *dq, *dk, *dv;
  float* stats;
  RowTile* tiles;
  int B, Sq, T_len, H, G, causal, has_window, window;
  cudaStream_t stream;
};

template <int K>
int launch_bwd(const BwdCall& c) {
  constexpr size_t smem = bwd_smem_bytes<K>();
  static bool opted_dq = false, opted_dkdv = false;  // once per instantiation
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<K>, smem, opted_dq);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkdv_kernel<K>, smem, opted_dkdv);
  if (e != cudaSuccess) return int(e);
  const float scale = 1.0f / sqrtf(static_cast<float>(K));
  const int R = c.Sq * (c.H / c.G);
  const dim3 grid_dq((R + kTile - 1) / kTile, c.G, c.B);
  flash_bwd_dq_kernel<K><<<grid_dq, kThreadsB, smem, c.stream>>>(
      c.q, c.k, c.v, c.out, c.dout, c.q_pos, c.q_pos_bstride, c.kv_pos, c.dq, c.stats, c.tiles,
      c.Sq, c.T_len, c.H, c.G, c.causal, c.has_window, c.window, kLog2e * scale, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const dim3 grid_kv((c.T_len + kTile - 1) / kTile, c.G, c.B);
  flash_bwd_dkdv_kernel<K><<<grid_kv, kThreadsB, smem, c.stream>>>(
      c.q, c.k, c.v, c.dout, c.q_pos, c.q_pos_bstride, c.kv_pos, c.stats, c.tiles, c.dk, c.dv,
      c.Sq, c.T_len, c.H, c.G, c.causal, c.has_window, c.window, kLog2e * scale, scale);
  return int(cudaGetLastError());
}

}  // namespace

// q, out, dout, dq [B,Sq,H,K]; k, v, dk, dv [B,T,G,K]; all bfloat16,
// contiguous and 16-byte aligned; q_pos int32 with q_pos[b*q_pos_bstride +
// s]; kv_pos int32 [T].  Scratch from the caller: stats fp32 [3*B*Sq*H],
// tiles int32 [4*B*G*ceil(Sq*(H/G)/64)].  K is 16, 64, 80, 120 or 128.  Two
// launches on the stream; returns cudaGetLastError() after them (0 on
// success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* out,
                                   const void* dout, const int* q_pos, int64_t q_pos_bstride,
                                   const int* kv_pos, void* dq, void* dk, void* dv, void* stats,
                                   void* tiles, int B, int Sq, int T_len, int H, int G, int K,
                                   int causal, int has_window, int window, void* stream) {
  if (B <= 0 || B > 65535 || Sq <= 0 || T_len <= 0 || G <= 0 || G > 65535 || H % G != 0)
    return (int)cudaErrorInvalidValue;
  const BwdCall c{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(out),
                  static_cast<const bf16*>(dout), q_pos, q_pos_bstride, kv_pos,
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                  static_cast<float*>(stats), static_cast<RowTile*>(tiles), B, Sq, T_len, H, G,
                  causal, has_window, window, static_cast<cudaStream_t>(stream)};
  return with_head_dim(K, [&](auto kd) { return launch_bwd<decltype(kd)::value>(c); });
}
