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
// Design: one block per row, so any row count runs with no padding copy
// (the Pallas wrapper's 256-row padding is a TPU artefact).  Each thread
// reads 16-byte vectors where D and the pointers allow it (8 bf16 or
// 4 floats), else scalars, and sums x^2 in fp32; warp shuffles and one
// shared-memory pass reduce the row.  A second pass re-reads the row,
// which the first pass left in L1/L2, scales it and writes y in x's type.
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success); the Python wrapper raises on anything else.
extern "C" int rmsnorm_fwd(const void* x, const float* scale, void* y,
                           int64_t rows, int D, float eps, int dtype,
                           void* stream) {
  if (rows <= 0 || rows > 2147483647LL || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, scale, y, rows, D, eps, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, scale, y, rows, D, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
