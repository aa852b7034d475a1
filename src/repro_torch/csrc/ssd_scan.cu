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
// Two kernels behind one entry point, chosen by the caller (route):
//
// fma (route 0, the port's first kernel; any type and size the wrapper
// takes): one block of 256 threads per (16-column slice of P, h, b), since the P
// columns of the state are independent; the block recomputes C B^T for
// its slice.  Per chunk it stages B and C transposed ([N][Q+1], fp32), its
// x slice [Q][16] and dt in shared memory; warp 0 scans cum; each thread
// computes a (Q/16 x Q/16) tile of W = C B^T with the causal mask applied
// by selection before exp (never by multiplication: exp of a masked
// cum_i - cum_j > 0 can be inf, and inf * 0 is NaN); then y and the state
// update are FMA loops over shared memory, one state column per thread.
// Shared memory at Q = N = 128 is 216 KB, above the 48 KB default, so
// each instantiation opts in once.  Everything is fp32 FMA.
//
// mma (route 1; bf16 x, B, C with chunk and N each 64 or 128 and P a
// multiple of 32): chunk-parallel on tensor cores.  One block per (chunk
// c, head h, batch b, 32 or 64 columns of P), warps of 16 rows.  Within a
// chunk the SSD is attention without a softmax: C the queries, B the
// keys, x the values, a causal mask carrying exp(cum_i - cum_j) dt_j.
//   1. C, B [Q x N] and x [Q x PT] are copied to shared memory with
//      16-byte cp.async at the caller's strides; warp 0 scans cum.
//   2. S = C B^T (mma.sync m16n8k16, fp32 accumulators), 16 keys at a time;
//      W = S exp(cum_i - cum_j) dt_j, selected before exp, in registers.
//   3. y_diag = W x, x through ldmatrix.trans.
//   4. The chunk's own state S_c = B^T (exp(cum_Q - cum) dt x), [N x PT],
//      with the scaled x split once per block into shared memory.
//   5. Look-back in groups of kGroup chunks: each chunk publishes its
//      aggregate (S_c, exp(cum_Q)) to a workspace; chunk c waits for the
//      aggregates of the earlier chunks of its group and for the state
//      after the previous group, and forms h_{c-1} from them by the same
//      fmaf chain a sequential pass would run (h <- exp(cum_Q) h + S_k).
//      The last chunk of a group publishes h_c for the next group; the
//      last chunk writes the final state.  So all chunks of a group run
//      their heavy work at once and wait only for a few loads.
//   6. y = y_diag + exp(cum_i) C_i h_{c-1}.
// Precision: x, B and C are exact in bf16, but W, the scaled x and h are
// fp32.  Each is split into hi = bf16(v) and lo = bf16(v - hi), and two
// products go into one fp32 accumulator (about 16 bits of mantissa), so
// y keeps the fp32 tolerance of the plain version.
// Forward progress: a block takes its work from an atomic ticket, chunks
// in order, so every block it waits on has already started, whatever
// order the hardware dispatches blocks in.  The flags and the ticket are
// zeroed by a memset on the stream inside the same C call.  A wait that
// never ends traps (the launch fails) instead of hanging.
// Results are bit-identical from call to call: no atomics touch data.
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
  // the mma route only
  int B, nc, ngroups;       // batch, chunks, groups of kGroup chunks
  void* ws;                 // the workspace; the pointers below are carved from it
  unsigned* agg_flags;      // [nc-1][blocks a chunk]: aggregate of chunk c published
  unsigned* inc_flags;      // [ngroups-1][blocks a chunk]: state after group g published
  unsigned* ticket;
  float* decs;              // [nc-1][blocks a chunk] exp(cum_Q) of chunk c
  float* agg;               // [B, nc-1, H, N, P] S_c
  float* inc;               // [B, ngroups-1, H, N, P] the state after each group
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

// ---------------------------------------------------------------------------
// Route 1: mma (bfloat16 x, B, C)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte global -> shared copy; zero-fills the destination when !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
// (v0, v1) = hi + lo with hi = bf16(v), lo = bf16(v - hi): about 16
// mantissa bits in two bf16 operands.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}
__device__ __forceinline__ void store2(float v0, float v1, float* out) {
  *reinterpret_cast<float2*>(out) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(float v0, float v1, __nv_bfloat16* out) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Warps: one per 16 rows of the chunk and one per 16 rows of the state,
// whichever is more.
template <int Q, int N>
__host__ __device__ constexpr int mma_threads() {
  return (Q > N ? Q : N) / 16 * 32;
}
template <int Q, int N, int PT>
constexpr size_t mma_smem_bytes() {
  // C and B [Q][N+8], x [Q][PT+8], and hi and lo [max(Q, N)][PT+8] of
  // wdec x (then of h_{c-1}) in bf16 (rows padded by 16 bytes: the eight
  // rows of an ldmatrix fall in distinct banks); dt, cum, wdec [Q] in fp32.
  return (size_t(2 * Q) * (N + 8) + size_t(Q + 2 * (Q > N ? Q : N)) * (PT + 8)) * 2 +
         3 * size_t(Q) * 4;
}

// Chunks a group: h_{c-1} is formed from the state after the previous group
// and at most kGroup - 1 aggregates, so only one chunk in kGroup waits on
// another group.
constexpr int kGroup = 8;

// Fragment layout of m16n8k16 (lane = 4 * gq + tq): an accumulator holds
// rows gq (c[0], c[1]) and gq + 8 (c[2], c[3]), columns 2 tq and 2 tq + 1;
// an A operand rows gq and gq + 8, columns 2 tq, 2 tq + 1 (a[0], a[1])
// and 8 more (a[2], a[3]); a B operand rows 2 tq, 2 tq + 1 (b0) and 8
// more (b1) of column gq.
template <typename TO, int Q, int N, int PT>
__global__ void __launch_bounds__(mma_threads<Q, N>(), PT <= 32 ? 2 : 1)
ssd_mma_kernel(Args a) {
  constexpr int NT = mma_threads<Q, N>();
  constexpr int CP = N + 8, XP = PT + 8, HR = Q > N ? Q : N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Q][CP]
  __nv_bfloat16* Bs = Cs + Q * CP;                                  // [Q][CP]
  __nv_bfloat16* Xs = Bs + Q * CP;                                  // [Q][XP]
  __nv_bfloat16* XWhi = Xs + Q * XP;  // [Q][XP] wdec x, hi; later h_{c-1} [N][XP], hi
  __nv_bfloat16* XWlo = XWhi + HR * XP;                             // the same, lo
  __nv_bfloat16* Hhi = XWhi;
  __nv_bfloat16* Hlo = XWlo;
  float* dts = reinterpret_cast<float*>(XWlo + HR * XP);            // [Q] dt, 0 past S
  float* cum = dts + Q;                                             // [Q] inclusive cumsum of dt A
  float* wdec = cum + Q;                                            // [Q] exp(cum_Q - cum_j) dt_j
  __shared__ int work_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int S = a.S, H = a.H, P = a.P, PS = P / PT;
  const int per_c = a.B * H * PS;  // blocks a chunk
  if (tid == 0) work_s = int(atomicAdd(a.ticket, 1u));
  __syncthreads();
  // Tickets run chunk by chunk: a block waits only on a smaller ticket,
  // taken by a block that is already running.
  const int c = work_s / per_c, rem = work_s % per_c;
  const int ps = rem % PS, h = (rem / PS) % H, b = rem / (PS * H);
  const int p0 = ps * PT, s0 = c * Q;
  const int nv = min(Q, S - s0);  // positions of the chunk within S
  const int nt = (nv + 15) / 16;  // 16-row tiles that hold any of them

  // ---- 1. stage C, B, x (rows past S zero) and dt; scan cum -------------
  {
    const __nv_bfloat16* xg =
        static_cast<const __nv_bfloat16*>(a.x) + b * a.x_bstride + int64_t(h) * P + p0;
    const __nv_bfloat16* Bg = static_cast<const __nv_bfloat16*>(a.Bm) + b * a.b_bstride;
    const __nv_bfloat16* Cg = static_cast<const __nv_bfloat16*>(a.Cm) + b * a.c_bstride;
    constexpr int NCH = N / 8, XCH = PT / 8;  // 16-byte pieces of a row
    for (int i = tid; i < nt * 16 * NCH; i += NT) {
      const int r = i / NCH, k = i % NCH;
      const bool ok = r < nv;
      const int64_t sr = ok ? s0 + r : 0;
      cp_async16(smem_u32(Cs + r * CP + k * 8), Cg + sr * a.c_sstride + k * 8, ok);
      cp_async16(smem_u32(Bs + r * CP + k * 8), Bg + sr * a.b_sstride + k * 8, ok);
    }
    for (int i = tid; i < nt * 16 * XCH; i += NT) {
      const int r = i / XCH, k = i % XCH;
      const bool ok = r < nv;
      cp_async16(smem_u32(Xs + r * XP + k * 8), xg + (ok ? s0 + r : 0) * a.x_sstride + k * 8, ok);
    }
  }
  if (tid < Q) dts[tid] = tid < nv ? a.dt[(int64_t(b) * S + s0 + tid) * H + h] : 0.f;
  __syncthreads();
  if (warp == 0) {
    constexpr int E = Q / 32;  // consecutive entries per lane
    const float A = a.A[h];
    float v[E];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      run += dts[lane * E + e] * A;
      v[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const float excl = incl - run, total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = lane * E + e;
      cum[i] = v[e] + excl;
      wdec[i] = expf(total - (v[e] + excl)) * dts[i];
    }
  }
  cp_async_wait_all();
  __syncthreads();
  // Xw = wdec x split into hi and lo, once for the block: the state's operand.
  for (int i = tid; i < nt * 16 * (PT / 2); i += NT) {
    const int j = i / (PT / 2), p = i % (PT / 2) * 2;
    const float2 f = unpack_bf16(*reinterpret_cast<const uint32_t*>(Xs + j * XP + p));
    uint32_t hi, lo;
    split_bf16(f.x * wdec[j], f.y * wdec[j], hi, lo);
    *reinterpret_cast<uint32_t*>(XWhi + j * XP + p) = hi;
    *reinterpret_cast<uint32_t*>(XWlo + j * XP + p) = lo;
  }
  __syncthreads();

  // ---- 2-3. y_diag = W x for this warp's 16 rows ------------------------
  const bool row_warp = warp < nt;
  uint32_t cf[N / 16][4];  // C rows as A operands
  float yd[PT / 8][4];
#pragma unroll
  for (int nb = 0; nb < PT / 8; ++nb) yd[nb][0] = yd[nb][1] = yd[nb][2] = yd[nb][3] = 0.f;
  if (row_warp) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      ldsm_x4(smem_u32(Cs + (warp * 16 + (lane & 15)) * CP + kk * 16 + (lane >> 4) * 8), cf[kk]);
    const int i0 = warp * 16 + gq;
    const float ci[2] = {cum[i0], cum[i0 + 8]};
    // Two key blocks at a time: four independent accumulator chains.
    for (int kb0 = 0; kb0 <= warp; kb0 += 2) {
      const bool two = kb0 < warp;  // warp-uniform
      float s2[2][2][4];            // [key block][8 keys][fragment]
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) s2[q][nb][0] = s2[q][nb][1] = s2[q][nb][2] = s2[q][nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !two) break;
          uint32_t bf[4];
          ldsm_x4(smem_u32(Bs + ((kb0 + q) * 16 + (lane & 7) + ((lane >> 4) << 3)) * CP +
                           kk * 16 + ((lane >> 3) & 1) * 8),
                  bf);
          mma_bf16(s2[q][0], cf[kk], bf[0], bf[1]);
          mma_bf16(s2[q][1], cf[kk], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) break;
        const int kb = kb0 + q;
        uint32_t whi[4], wlo[4];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float w[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = i0 + 8 * r, j = kb * 16 + nb * 8 + 2 * tq + e;
              // select, then exp: the masked difference is positive
              w[e] = j <= i ? s2[q][nb][2 * r + e] * expf(ci[r] - cum[j]) * dts[j] : 0.f;
            }
            split_bf16(w[0], w[1], whi[nb * 2 + r], wlo[nb * 2 + r]);
          }
        }
#pragma unroll
        for (int dp = 0; dp < PT / 16; ++dp) {
          uint32_t xb[4];
          ldsm_x4_trans(smem_u32(Xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP +
                                 dp * 16 + (lane >> 4) * 8),
                        xb);
          mma_bf16(yd[2 * dp], whi, xb[0], xb[1]);
          mma_bf16(yd[2 * dp], wlo, xb[0], xb[1]);
          mma_bf16(yd[2 * dp + 1], whi, xb[2], xb[3]);
          mma_bf16(yd[2 * dp + 1], wlo, xb[2], xb[3]);
        }
      }
    }
  }

  // ---- 4. the chunk's own state S_c = B^T Xw, rows n of this warp -------
  const bool state_warp = warp < N / 16;
  float st[PT / 8][4];
#pragma unroll
  for (int nb = 0; nb < PT / 8; ++nb) st[nb][0] = st[nb][1] = st[nb][2] = st[nb][3] = 0.f;
  if (state_warp) {
    for (int kb = 0; kb < nt; ++kb) {
      uint32_t bt[4];  // B^T rows n, columns j, from B stored [j][n]
      ldsm_x4_trans(smem_u32(Bs + (kb * 16 + (lane & 7) + ((lane >> 4) & 1) * 8) * CP +
                             warp * 16 + ((lane >> 3) & 1) * 8),
                    bt);
#pragma unroll
      for (int dp = 0; dp < PT / 16; ++dp) {
        const int off = (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP + dp * 16 + (lane >> 4) * 8;
        uint32_t hi[4], lo[4];
        ldsm_x4_trans(smem_u32(XWhi + off), hi);
        ldsm_x4_trans(smem_u32(XWlo + off), lo);
        mma_bf16(st[2 * dp], bt, hi[0], hi[1]);
        mma_bf16(st[2 * dp], bt, lo[0], lo[1]);
        mma_bf16(st[2 * dp + 1], bt, hi[2], hi[3]);
        mma_bf16(st[2 * dp + 1], bt, lo[2], lo[3]);
      }
    }
  }

  // ---- 5. h_{c-1}, and h_c where a later group needs it ---------------------
  // Publish the aggregate (S_c, exp(cum_Q)) for the later chunks of the group.
  const float dec = expf(cum[Q - 1]);
  const int64_t head = int64_t(b) * H + h;
  if (c < a.nc - 1 && c % kGroup != kGroup - 1) {
    if (state_warp) {
      float* agg = a.agg + ((int64_t(b) * (a.nc - 1) + c) * H + h) * N * P;
#pragma unroll
      for (int nb = 0; nb < PT / 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store2(st[nb][2 * r], st[nb][2 * r + 1],
                 agg + (warp * 16 + gq + 8 * r) * P + p0 + nb * 8 + 2 * tq);
    }
    if (tid == 0) a.decs[c * per_c + rem] = dec;
    __threadfence();
  }
  __syncthreads();  // also: every read of Xw is done, its space becomes h_{c-1}
  if (tid == 0 && c < a.nc - 1 && c % kGroup != kGroup - 1)
    st_release(a.agg_flags + c * per_c + rem, 1u);
  // Wait for the group's earlier aggregates and the state it starts from (a
  // lane each); all are smaller tickets.
  const int g = c / kGroup, g0 = g * kGroup;
  if (warp == 0 && (lane < c - g0 || (lane == 31 && g > 0))) {
    const unsigned* f = lane == 31 ? a.inc_flags + (g - 1) * per_c + rem
                                   : a.agg_flags + (g0 + lane) * per_c + rem;
    for (unsigned it = 0; ld_acquire(f) == 0; ++it) {
      if (it > (1u << 26)) __trap();  // never: the publisher is running
      __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
  // h_{c-1} by Horner from the group's incoming state: the same fmaf chain
  // for every block, so the bits do not depend on timing.
  const float* h_in = g > 0 ? a.inc + ((int64_t(b) * (a.ngroups - 1) + g - 1) * H + h) * N * P
                            : (a.init_state ? a.init_state + head * N * P : nullptr);
  const bool has_prev = h_in || c > 0;
  const bool publish_inc = c % kGroup == kGroup - 1 && c < a.nc - 1;
  if (state_warp) {
    float2 hp[PT / 8][2];
#pragma unroll
    for (int nb = 0; nb < PT / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = warp * 16 + gq + 8 * r, col = p0 + nb * 8 + 2 * tq;
        hp[nb][r] = h_in ? __ldcg(reinterpret_cast<const float2*>(h_in + n * P + col))
                         : make_float2(0.f, 0.f);
      }
    for (int k = g0; k < c; ++k) {
      const float d = __ldcg(a.decs + k * per_c + rem);
      const float* agg = a.agg + ((int64_t(b) * (a.nc - 1) + k) * H + h) * N * P;
#pragma unroll
      for (int nb = 0; nb < PT / 8; ++nb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = warp * 16 + gq + 8 * r, col = p0 + nb * 8 + 2 * tq;
          const float2 sk = __ldcg(reinterpret_cast<const float2*>(agg + n * P + col));
          hp[nb][r] = make_float2(fmaf(d, hp[nb][r].x, sk.x), fmaf(d, hp[nb][r].y, sk.y));
        }
    }
    float* out = c == a.nc - 1 ? a.state + head * N * P
               : publish_inc  ? a.inc + ((int64_t(b) * (a.ngroups - 1) + g) * H + h) * N * P
                              : nullptr;
#pragma unroll
    for (int nb = 0; nb < PT / 8; ++nb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = warp * 16 + gq + 8 * r, col = nb * 8 + 2 * tq;
        if (out)
          store2(fmaf(dec, hp[nb][r].x, st[nb][2 * r]), fmaf(dec, hp[nb][r].y, st[nb][2 * r + 1]),
                 out + n * P + p0 + col);
        uint32_t hi, lo;
        split_bf16(hp[nb][r].x, hp[nb][r].y, hi, lo);
        *reinterpret_cast<uint32_t*>(Hhi + n * XP + col) = hi;
        *reinterpret_cast<uint32_t*>(Hlo + n * XP + col) = lo;
      }
  }
  if (publish_inc) __threadfence();
  __syncthreads();
  if (tid == 0 && publish_inc) st_release(a.inc_flags + g * per_c + rem, 1u);

  // ---- 6. y = y_diag + exp(cum_i) C_i h_{c-1} ------------------------------
  if (row_warp) {
    float yo[PT / 8][4];
#pragma unroll
    for (int nb = 0; nb < PT / 8; ++nb) yo[nb][0] = yo[nb][1] = yo[nb][2] = yo[nb][3] = 0.f;
    if (has_prev) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int dp = 0; dp < PT / 16; ++dp) {
          const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP + dp * 16 + (lane >> 4) * 8;
          uint32_t hb[4], lb[4];
          ldsm_x4_trans(smem_u32(Hhi + off), hb);
          ldsm_x4_trans(smem_u32(Hlo + off), lb);
          mma_bf16(yo[2 * dp], cf[kk], hb[0], hb[1]);
          mma_bf16(yo[2 * dp], cf[kk], lb[0], lb[1]);
          mma_bf16(yo[2 * dp + 1], cf[kk], hb[2], hb[3]);
          mma_bf16(yo[2 * dp + 1], cf[kk], lb[2], lb[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = warp * 16 + gq + 8 * r;
      if (i >= nv) continue;
      const float e = expf(cum[i]);
      TO* yr = static_cast<TO*>(a.y) + ((int64_t(b) * S + s0 + i) * H + h) * P + p0 + 2 * tq;
#pragma unroll
      for (int nb = 0; nb < PT / 8; ++nb)
        store2(yd[nb][2 * r] + e * yo[nb][2 * r], yd[nb][2 * r + 1] + e * yo[nb][2 * r + 1],
               yr + nb * 8);
    }
  }
}

// Bytes of the workspace before the states: two flags and a decay per
// (chunk, block of 32 columns), a flag per (group, block), the ticket.
size_t mma_header_bytes(int B, int H, int P, int nc, int ngroups) {
  const size_t blocks32 = size_t(B) * H * (P / 32);
  return (sizeof(unsigned) * (2 * size_t(nc - 1) * blocks32 + size_t(ngroups - 1) * blocks32 + 1) +
          15) / 16 * 16;
}

// Columns of P a block takes.  The block's C B^T costs the same at any
// width, so 64 columns halve that work and the staging of B and C; 32
// double the grid and let two blocks share an SM.  Timed side by side on
// an H100 (PERF.md), 64 won from three quarters of the SMs' worth
// of 64-column blocks up and 32 below.
int mma_cols(int P, int64_t blocks_at_64, int sms) {
  return P % 64 == 0 && 4 * blocks_at_64 >= 3 * int64_t(sms) ? 64 : 32;
}

template <typename TO, int Q, int N, int PT>
int launch_mma_pt(const Args& a, cudaStream_t stream) {
  auto kernel = ssd_mma_kernel<TO, Q, N, PT>;
  constexpr size_t smem = mma_smem_bytes<Q, N, PT>();
  static bool opted = false;  // once per instantiation
  if (!opted) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    opted = true;
  }
  const int64_t per_c = int64_t(a.B) * a.H * (a.P / PT), blocks = per_c * a.nc;
  if (blocks > 2147483647LL) return int(cudaErrorInvalidValue);
  // The workspace (sized for 32 columns a block, the most blocks): flags,
  // ticket and decays, then, at mma_header_bytes, the fp32 states.
  Args k = a;
  k.agg_flags = static_cast<unsigned*>(a.ws);
  k.inc_flags = k.agg_flags + (a.nc - 1) * per_c;
  k.ticket = k.inc_flags + (a.ngroups - 1) * per_c;
  k.decs = reinterpret_cast<float*>(k.ticket + 1);
  k.agg = reinterpret_cast<float*>(static_cast<char*>(a.ws) +
                                   mma_header_bytes(a.B, a.H, a.P, a.nc, a.ngroups));
  k.inc = k.agg + int64_t(a.B) * (a.nc - 1) * a.H * a.N * a.P;
  const cudaError_t e = cudaMemsetAsync(
      a.ws, 0, sizeof(unsigned) * size_t((a.nc - 1 + a.ngroups - 1) * per_c + 1), stream);
  if (e != cudaSuccess) return int(e);
  kernel<<<static_cast<unsigned int>(blocks), mma_threads<Q, N>(), smem, stream>>>(k);
  return int(cudaGetLastError());
}

template <typename TO, int Q, int N>
int launch_mma_qn(const Args& a, cudaStream_t stream) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
  }
  const int64_t blocks_at_64 = int64_t(a.B) * a.H * (a.P / 64) * a.nc;
  if (mma_cols(a.P, blocks_at_64, sms) == 64) return launch_mma_pt<TO, Q, N, 64>(a, stream);
  return launch_mma_pt<TO, Q, N, 32>(a, stream);
}

template <typename TO>
int launch_mma(const Args& a, int Q, cudaStream_t stream) {
  if (Q == 64 && a.N == 64) return launch_mma_qn<TO, 64, 64>(a, stream);
  if (Q == 64 && a.N == 128) return launch_mma_qn<TO, 64, 128>(a, stream);
  if (Q == 128 && a.N == 64) return launch_mma_qn<TO, 128, 64>(a, stream);
  if (Q == 128 && a.N == 128) return launch_mma_qn<TO, 128, 128>(a, stream);
  return int(cudaErrorInvalidValue);
}

bool aligned16(const void* p, int64_t s0, int64_t s1) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s0 % 8 == 0 && s1 % 8 == 0;
}

}  // namespace

// dtype / out_dtype: 0 = float32, 1 = bfloat16.  init_state may be null
// (a zero state).  route: 0 = fma; 1 = mma, which takes bf16 x, B and C
// with chunk and N each 64 or 128, P a multiple of 32, 16-byte aligned
// bases and batch and sequence strides a multiple of 8 elements, and a
// workspace ws of mma_header_bytes plus 4 B H N P (nc - 1 + ngroups - 1)
// bytes (ops._ssd_workspace_bytes).  Returns cudaGetLastError() after
// the launch (0 on success); the Python wrapper raises on anything else.
extern "C" int ssd_scan_fwd(const void* x, int64_t x_bstride, int64_t x_sstride,
                            const float* dt, const float* A,
                            const void* Bm, int64_t b_bstride, int64_t b_sstride,
                            const void* Cm, int64_t c_bstride, int64_t c_sstride,
                            const float* init_state, void* y, float* state,
                            int B, int S, int H, int P, int N, int chunk,
                            int dtype, int out_dtype, int route, void* ws, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || H > 65535 || !supported(P) ||
      !supported(N) || !supported(chunk)) {
    return int(cudaErrorInvalidValue);
  }
  const int nc = (S + chunk - 1) / chunk;
  Args a{x, x_bstride, x_sstride, dt, A, Bm, b_bstride, b_sstride, Cm,
         c_bstride, c_sstride, init_state, y, state, S, H, P, N,
         B, nc, (nc + kGroup - 1) / kGroup, ws};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || (chunk != 64 && chunk != 128) || (N != 64 && N != 128) || P % 32 ||
        !ws || !aligned16(x, x_bstride, x_sstride) || !aligned16(Bm, b_bstride, b_sstride) ||
        !aligned16(Cm, c_bstride, c_sstride)) {
      return int(cudaErrorInvalidValue);
    }
    return out_dtype == 0 ? launch_mma<float>(a, chunk, s) : launch_mma<__nv_bfloat16>(a, chunk, s);
  }
  if (route != 0) return int(cudaErrorInvalidValue);
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(a, B, chunk, s);
  if (dtype == 0 && out_dtype == 1) return launch<float, __nv_bfloat16>(a, B, chunk, s);
  if (dtype == 1 && out_dtype == 0) return launch<__nv_bfloat16, float>(a, B, chunk, s);
  if (dtype == 1 && out_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, B, chunk, s);
  return int(cudaErrorInvalidValue);
}
