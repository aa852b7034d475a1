// Mamba2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (body _ssd_kernel).  Per (batch b, head h) it walks the chunks of Q
// positions in order, carrying the [N, P] state h:
//   cum   = cumsum(dt * A) within the chunk
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . h
//   h    <- exp(cum_Q) h + sum_j exp(cum_Q - cum_j) dt_j B_j (x) x_j
// and returns y [B, S, H, P] in the caller's type and the final state
// [B, H, N, P] in fp32.  Beyond the Pallas kernel it takes an initial
// state, reads x, B and C with the caller's batch and sequence strides (so
// slices of the Mamba block's xBC tensor need no copy and the single B/C
// group is read by index, never broadcast over heads), and bounds the tail
// chunk itself: positions >= S act as dt = 0 with zero x, B, C, so the
// final state is the state after S tokens and no padding copy is made.
//
// Bound on an H100: memory, at bf16 tensor-core rates.  Per (b, h,
// chunk) the function does 2Q^2 N + 2Q^2 P + 4QNP operations; the
// mamba2-370m prefill call (B = 1, S = 512, H = 32, P = 64, N = 128,
// chunk 128, bf16 in, fp32 y) does 1.34 GFLOP (1.4 us at 989 TFLOP/s) and
// moves 7.7 MB (2.3 us at 3.35 TB/s).
//
// Design (simple and right first; a chunk-parallel, tensor-core kernel is
// later work): one block of 256 threads per (16-column slice of P, h, b),
// since the P columns of the state are independent; the block recomputes
// C B^T for its slice.  Per chunk it stages B and C transposed ([N][Q+1],
// fp32), its x slice [Q][16] and dt in shared memory; warp 0 scans cum;
// each thread computes a (Q/16 x Q/16) tile of W = C B^T with the causal
// mask applied by selection before exp (never by multiplication: exp of a
// masked cum_i - cum_j > 0 can be inf, and inf * 0 is NaN); then y and the
// state update are FMA loops over shared memory, one state column per
// thread.  Shared memory at Q = N = 128 is 216 KB, above the 48 KB default,
// so each instantiation opts in once.  Everything is fp32 FMA; no tensor
// cores.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;       // state columns (of P) per block
constexpr int kMaxNRows = 8;  // N / 16 for N <= 128

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

struct Args {
  const void* x;
  int64_t x_bstride, x_sstride;  // elements; head stride P, column stride 1
  const float* dt;               // [B, S, H], contiguous
  const float* A;                // [H]
  const void* Bm;
  int64_t b_bstride, b_sstride;  // elements; state stride 1
  const void* Cm;
  int64_t c_bstride, c_sstride;
  const float* init_state;  // [B, H, N, P] or null
  void* y;                  // [B, S, H, P], contiguous
  float* state;             // [B, H, N, P]
  int S, H, P, N;
};

size_t smem_bytes(int Q, int N) {
  const int ld = Q + 1;
  return sizeof(float) *
         (size_t(2 * N + Q) * ld + size_t(Q + N) * kPT + 3 * size_t(Q));
}

template <typename T, typename TO, int Q>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Args a) {
  constexpr int TQ = Q / 16;  // rows (and W columns) per thread
  constexpr int LD = Q + 1;   // padded row of the [.][Q] tiles
  extern __shared__ float smem[];
  const int N = a.N, S = a.S, H = a.H, P = a.P;
  float* Bt = smem;             // [N][LD]  B of the chunk, transposed
  float* Ct = Bt + N * LD;      // [N][LD]  C of the chunk, transposed
  float* W = Ct + N * LD;       // [Q][LD]  masked C B^T * decay * dt
  float* xs = W + Q * LD;       // [Q][kPT] x slice of the chunk
  float* hs = xs + Q * kPT;     // [N][kPT] carried state slice
  float* dts = hs + N * kPT;    // [Q] dt (0 past S)
  float* cum = dts + Q;         // [Q] inclusive cumsum of dt * A
  float* wdec = cum + Q;        // [Q] exp(cum_Q - cum_j) dt_j

  const int p0 = blockIdx.x * kPT, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, hi = t / 16, lo = t % 16;
  const float A = a.A[h];
  const T* x = static_cast<const T*>(a.x) + b * a.x_bstride + int64_t(h) * P + p0;
  const T* Bm = static_cast<const T*>(a.Bm) + b * a.b_bstride;
  const T* Cm = static_cast<const T*>(a.Cm) + b * a.c_bstride;
  const float* dt = a.dt + int64_t(b) * S * H + h;
  TO* y = static_cast<TO*>(a.y) + (int64_t(b) * S * H + h) * P + p0;
  const int64_t state_off = (int64_t(b) * H + h) * N * P + p0;

  for (int idx = t; idx < N * kPT; idx += kThreads) {
    const int n = idx / kPT, p = idx % kPT;
    hs[idx] = a.init_state ? a.init_state[state_off + int64_t(n) * P + p] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += Q) {
    __syncthreads();  // the previous chunk is done with every tile
    // ---- stage the chunk; positions past S read as zero ----------------
    for (int i = t; i < Q; i += kThreads) {
      dts[i] = s0 + i < S ? dt[int64_t(s0 + i) * H] : 0.f;
    }
#pragma unroll 4
    for (int idx = t; idx < Q * N; idx += kThreads) {
      const int i = idx / N, n = idx % N;
      float bv = 0.f, cv = 0.f;
      if (s0 + i < S) {
        bv = to_f(Bm[int64_t(s0 + i) * a.b_sstride + n]);
        cv = to_f(Cm[int64_t(s0 + i) * a.c_sstride + n]);
      }
      Bt[n * LD + i] = bv;
      Ct[n * LD + i] = cv;
    }
#pragma unroll 4
    for (int idx = t; idx < Q * kPT; idx += kThreads) {
      const int i = idx / kPT, p = idx % kPT;
      xs[idx] = s0 + i < S ? to_f(x[int64_t(s0 + i) * a.x_sstride + p]) : 0.f;
    }
    __syncthreads();

    // ---- cum: inclusive scan of dt * A by warp 0 ----------------------
    if (t < 32) {
      constexpr int E = Q >= 32 ? Q / 32 : 1;  // consecutive entries per lane
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = t * E + e;
        run += i < Q ? dts[i] * A : 0.f;
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (t >= o) incl += up;
      }
      const float excl = incl - run;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = t * E + e;
        if (i < Q) cum[i] = v[e] + excl;
      }
    }
    __syncthreads();

    // ---- W[i][j], rows i = hi + 16a, columns j = lo + 16c --------------
    {
      float acc[TQ][TQ];
#pragma unroll
      for (int r = 0; r < TQ; ++r)
#pragma unroll
        for (int c = 0; c < TQ; ++c) acc[r][c] = 0.f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        float cr[TQ], br[TQ];
#pragma unroll
        for (int r = 0; r < TQ; ++r) cr[r] = Ct[n * LD + hi + 16 * r];
#pragma unroll
        for (int c = 0; c < TQ; ++c) br[c] = Bt[n * LD + lo + 16 * c];
#pragma unroll
        for (int r = 0; r < TQ; ++r)
#pragma unroll
          for (int c = 0; c < TQ; ++c) acc[r][c] = fmaf(cr[r], br[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        const int i = hi + 16 * r;
#pragma unroll
        for (int c = 0; c < TQ; ++c) {
          const int j = lo + 16 * c;
          // select, then exp: the masked difference is positive
          W[i * LD + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
    }
    for (int j = t; j < Q; j += kThreads) wdec[j] = expf(cum[Q - 1] - cum[j]) * dts[j];
    __syncthreads();

    // ---- y: rows i = hi + 16a of column lo ------------------------------
    {
      float yd[TQ], yo[TQ];
#pragma unroll
      for (int r = 0; r < TQ; ++r) yd[r] = yo[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float xv = xs[j * kPT + lo];
#pragma unroll
        for (int r = 0; r < TQ; ++r) yd[r] = fmaf(W[(hi + 16 * r) * LD + j], xv, yd[r]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        const float hv = hs[n * kPT + lo];
#pragma unroll
        for (int r = 0; r < TQ; ++r) yo[r] = fmaf(Ct[n * LD + hi + 16 * r], hv, yo[r]);
      }
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        const int i = hi + 16 * r;
        if (s0 + i < S) store(yd[r] + expf(cum[i]) * yo[r], &y[int64_t(s0 + i) * H * P + lo]);
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- state update: rows n = hi + 16a of column lo -------------------
    {
      const int nrows = N / 16;
      float acc[kMaxNRows];
#pragma unroll
      for (int r = 0; r < kMaxNRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = 0; j < Q; ++j) {
        const float xv = xs[j * kPT + lo] * wdec[j];
#pragma unroll
        for (int r = 0; r < kMaxNRows; ++r) {
          if (r < nrows) acc[r] = fmaf(Bt[(hi + 16 * r) * LD + j], xv, acc[r]);
        }
      }
      const float dec = expf(cum[Q - 1]);
#pragma unroll
      for (int r = 0; r < kMaxNRows; ++r) {
        if (r < nrows) {
          float* hp = &hs[(hi + 16 * r) * kPT + lo];
          *hp = fmaf(dec, *hp, acc[r]);
        }
      }
    }
  }
  __syncthreads();
  for (int idx = t; idx < N * kPT; idx += kThreads) {
    const int n = idx / kPT, p = idx % kPT;
    a.state[state_off + int64_t(n) * P + p] = hs[idx];
  }
}

template <typename T, typename TO, int Q>
int launch_q(const Args& a, int B, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, TO, Q>;
  const size_t smem = smem_bytes(Q, a.N);
  // Opt in to the largest size once per instantiation; a launch asks for
  // what its N needs.
  static bool opted = false;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_bytes(Q, 128)));
    if (e != cudaSuccess) return int(e);
    opted = true;
  }
  const dim3 grid(a.P / kPT, a.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, typename TO>
int launch(const Args& a, int B, int Q, cudaStream_t stream) {
  switch (Q) {
    case 16: return launch_q<T, TO, 16>(a, B, stream);
    case 32: return launch_q<T, TO, 32>(a, B, stream);
    case 64: return launch_q<T, TO, 64>(a, B, stream);
    case 128: return launch_q<T, TO, 128>(a, B, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

bool supported(int v) { return v == 16 || v == 32 || v == 64 || v == 128; }

}  // namespace

// dtype / out_dtype: 0 = float32, 1 = bfloat16.  init_state may be null
// (a zero state).  Returns cudaGetLastError() after the launch (0 on
// success); the Python wrapper raises on anything else.
extern "C" int ssd_scan_fwd(const void* x, int64_t x_bstride, int64_t x_sstride,
                            const float* dt, const float* A,
                            const void* Bm, int64_t b_bstride, int64_t b_sstride,
                            const void* Cm, int64_t c_bstride, int64_t c_sstride,
                            const float* init_state, void* y, float* state,
                            int B, int S, int H, int P, int N, int chunk,
                            int dtype, int out_dtype, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || !supported(P) ||
      !supported(N) || !supported(chunk)) {
    return int(cudaErrorInvalidValue);
  }
  const Args a{x, x_bstride, x_sstride, dt, A, Bm, b_bstride, b_sstride, Cm,
               c_bstride, c_sstride, init_state, y, state, S, H, P, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(a, B, chunk, s);
  if (dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(a, B, chunk, s);
  if (dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(a, B, chunk, s);
  if (dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, B, chunk, s);
  return int(cudaErrorInvalidValue);
}
