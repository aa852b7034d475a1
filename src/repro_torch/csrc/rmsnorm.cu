// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _rmsnorm_kernel), which normalises 256-row blocks held in VMEM.
//
// Bound on an H100: memory.  The function must read R*D elements of x and
// D floats of scale and write R*D elements of y, at 3.35 TB/s; its
// 4*R*D flops are far below the card's fp32 rate.  At decode (R = batch
// rows <= 128) one launch moves well under a megabyte and is bound by the
// launch itself.
//
// Two kernels; the caller names the one to run (ops._rmsnorm_route, by a
// plain rule on D and alignment), and rmsnorm_fwd refuses a row-kernel call
// it cannot serve:
//
// rmsnorm_row_kernel, for the widths the port runs (128: qk-norm; 1024
// and 2048: mamba2-370m's d_model and gated norm; 4096: deepseek-7b) with
// 16-byte aligned x, y and scale.  A row is held in registers: TPR
// threads share it, each with NV 16-byte vectors, all loaded before any
// arithmetic, so every SM keeps several KB in flight, and y is written
// from the same registers (x is read once).  A row of at most 32 lanes
// reduces with shuffles alone, several rows to a 256-thread block; a
// wider row (128 threads) adds one shared-memory step.  Each thread reads
// its columns of scale once, as 16-byte vectors, and keeps them in
// registers over a grid-stride loop on rows, the grid being as many
// blocks as fit on the card at once.
//
// rmsnorm_kernel, for any other D or unaligned pointers: one block per
// row, 16-byte vectors where D and the pointers allow it, else scalars;
// warp shuffles and one shared-memory pass reduce the row, and a second
// pass re-reads the row, which the first left in L1/L2, to write y.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) { *out = __float2bfloat16(v); }

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// kVec: 16-byte accesses (VEC elements each); otherwise one element at a time.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int D, float eps) {
  constexpr int VEC = kVec ? 16 / sizeof(T) : 1;
  __shared__ float red[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  const int nvec = D / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    alignas(16) T buf[VEC];
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(buf) = reinterpret_cast<const uint4*>(xr)[i];
    } else {
      buf[0] = xr[i];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(buf[j]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss, red) / D + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    alignas(16) T buf[VEC];
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(buf) = reinterpret_cast<const uint4*>(xr)[i];
    } else {
      buf[0] = xr[i];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      from_f(to_f(buf[j]) * inv * scale[i * VEC + j], &buf[j]);
    }
    if constexpr (kVec) {
      reinterpret_cast<uint4*>(yr)[i] = *reinterpret_cast<uint4*>(buf);
    } else {
      yr[i] = buf[0];
    }
  }
}

// One row to TPR threads (a power of two), NV 16-byte vectors a thread;
// vector v of a thread is the row's vector v * TPR + (its lane in the row).
template <typename T, int TPR, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int64_t rows, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int D = TPR * NV * VEC;
  constexpr int RPB = kThreads / TPR;  // rows per block
  constexpr int WPR = TPR > 32 ? TPR / 32 : 1;  // warps per row
  static_assert(kThreads % TPR == 0 && (TPR & (TPR - 1)) == 0, "TPR: a power of two");
  __shared__ float red[2][kThreads / 32];  // two buffers: one barrier a row
  const int lr = threadIdx.x / TPR, lt = threadIdx.x % TPR;

  float sc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const float4* sp = reinterpret_cast<const float4*>(scale + (v * TPR + lt) * VEC);
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 f = sp[q];
      sc[v][4 * q] = f.x;
      sc[v][4 * q + 1] = f.y;
      sc[v][4 * q + 2] = f.z;
      sc[v][4 * q + 3] = f.w;
    }
  }

  int parity = 0;
  for (int64_t r0 = int64_t(blockIdx.x) * RPB; r0 < rows; r0 += int64_t(gridDim.x) * RPB) {
    const int64_t row = r0 + lr;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
    uint4 buf[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) buf[v] = live ? xr[v * TPR + lt] : make_uint4(0, 0, 0, 0);
    float ss = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const T* e = reinterpret_cast<const T*>(&buf[v]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f(e[j]);
        ss += f * f;
      }
    }
#pragma unroll
    for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (TPR > 32) {
      const int warp = threadIdx.x / 32;
      if (threadIdx.x % 32 == 0) red[parity][warp] = ss;
      __syncthreads();  // the other buffer was last read before this barrier
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += red[parity][lr * WPR + w];
      parity ^= 1;
    }
    const float inv = rsqrtf(ss / D + eps);
    if (live) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        alignas(16) T out[VEC];
        const T* e = reinterpret_cast<const T*>(&buf[v]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) from_f(to_f(e[j]) * inv * sc[v][j], &out[j]);
        yr[v * TPR + lt] = *reinterpret_cast<const uint4*>(out);
      }
    }
  }
}

template <typename T, int TPR, int NV>
int launch_row(const void* x, const float* scale, void* y, int64_t rows, float eps,
               cudaStream_t stream) {
  auto kernel = rmsnorm_row_kernel<T, TPR, NV>;
  static int max_blocks = 0;  // blocks resident on the card at once, per instantiation
  if (!max_blocks) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (e != cudaSuccess) return int(e);
    max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int RPB = kThreads / TPR;
  const int64_t want = (rows + RPB - 1) / RPB;
  const unsigned int grid = static_cast<unsigned int>(want < max_blocks ? want : max_blocks);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), scale, static_cast<T*>(y),
                                        rows, eps);
  return int(cudaGetLastError());
}

// The row kernel for the widths it is specialised for, as (threads a row,
// 16-byte vectors a thread); false for any other D.
template <typename T>
bool launch_fast(const void* x, const float* scale, void* y, int64_t rows, int D, float eps,
                 cudaStream_t stream, int* err) {
  if constexpr (sizeof(T) == 2) {  // 8 bf16 a vector
    switch (D) {
      case 128: *err = launch_row<T, 16, 1>(x, scale, y, rows, eps, stream); return true;
      case 1024: *err = launch_row<T, 32, 4>(x, scale, y, rows, eps, stream); return true;
      case 2048: *err = launch_row<T, 32, 8>(x, scale, y, rows, eps, stream); return true;
      case 4096: *err = launch_row<T, 128, 4>(x, scale, y, rows, eps, stream); return true;
    }
  } else {  // 4 floats a vector
    switch (D) {
      case 128: *err = launch_row<T, 32, 1>(x, scale, y, rows, eps, stream); return true;
      case 1024: *err = launch_row<T, 32, 8>(x, scale, y, rows, eps, stream); return true;
      case 2048: *err = launch_row<T, 64, 8>(x, scale, y, rows, eps, stream); return true;
      case 4096: *err = launch_row<T, 128, 8>(x, scale, y, rows, eps, stream); return true;
    }
  }
  return false;
}

template <typename T>
void launch(const void* x, const float* scale, void* y, int64_t rows, int D,
            float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = D % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) {
    rmsnorm_kernel<T, true><<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), D, eps);
  } else {
    rmsnorm_kernel<T, false><<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), D, eps);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int run(const void* x, const float* scale, void* y, int64_t rows, int D, float eps,
        int route, cudaStream_t stream) {
  if (route == 1) {  // the row kernel, or nothing
    int err = 0;
    if (aligned16(x) && aligned16(y) && aligned16(scale) &&
        launch_fast<T>(x, scale, y, rows, D, eps, stream, &err)) {
      return err;
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  launch<T>(x, scale, y, rows, D, eps, stream);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  route: 0 = the general kernel, any D;
// 1 = the row kernel, which takes D in {128, 1024, 2048, 4096} with x, y
// and scale 16-byte aligned (any other call on it is refused).  Returns
// cudaGetLastError() after the launch (0 on success); the Python wrapper
// raises on anything else.
extern "C" int rmsnorm_fwd(const void* x, const float* scale, void* y,
                           int64_t rows, int D, float eps, int dtype, int route,
                           void* stream) {
  if (rows <= 0 || rows > 2147483647LL || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, scale, y, rows, D, eps, route, s);
  if (dtype == 1) return run<__nv_bfloat16>(x, scale, y, rows, D, eps, route, s);
  return (int)cudaErrorInvalidValue;
}
