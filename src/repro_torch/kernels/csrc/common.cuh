// Helpers shared by the attention kernels: 16-byte tile loads that widen
// to f32, warp reductions, output stores and the C error interface.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;   // masked score, as NEG_INF in kernels/common.py

enum DType { kF32 = 0, kBF16 = 1 };

// Elements of T in one 16-byte load.
template <typename T> struct Vec16;
template <> struct Vec16<float> { static constexpr int N = 4; };
template <> struct Vec16<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    float2 f = __bfloat1622float2(h);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);   // round to nearest even, as torch's .to()
}

// Copy `rows` rows of D elements into shared f32 rows of stride `ld`,
// multiplied by `mul`.  Row r starts at src + r * row_stride elements;
// rows at or past `valid` are written as zeros (never read from memory).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t row_stride, int rows,
                                          int valid, float mul) {
  constexpr int N = Vec16<T>::N;
  constexpr int CPR = D / N;            // 16-byte chunks per row
  for (int c = threadIdx.x; c < rows * CPR; c += blockDim.x) {
    const int r = c / CPR;
    const int col = (c % CPR) * N;
    float v[N];
    if (r < valid) {
      load16(src + r * row_stride + col, v);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[r * ld + col + i] = v[i] * mul;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dot product of a shared f32 row (16-byte aligned, broadcast to the warp)
// with a row held in registers.
template <int D>
__device__ __forceinline__ float dot_row(const float* q, const float* k) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 a = *reinterpret_cast<const float4*>(q + d);
    s = fmaf(a.x, k[d], s);
    s = fmaf(a.y, k[d + 1], s);
    s = fmaf(a.z, k[d + 2], s);
    s = fmaf(a.w, k[d + 3], s);
  }
  return s;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device.  `limit` holds one slot per device, owned by the caller's template
// instance: it remembers the largest limit set so far, so the runtime is
// asked again only when a launch needs more than any earlier one, not on
// every call of the decode loop.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t raise_smem_limit(Kernel kernel, int bytes, int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (bytes <= limit[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) limit[dev] = bytes;
  return err;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
