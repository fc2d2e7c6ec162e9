// State-push kernels K1-K4: the fused two-tier state push's wire codec on
// (R, 128) f32 rows.
//
// Replaces the Pallas kernels of src/repro/kernels/state_push/kernel.py:
//   K1 quantize_delta_pallas  -> quantize_kernel<false>  (int8 / int4 codes)
//   K4 quantize_fp8_pallas    -> quantize_kernel<true>   (e4m3fn codes)
//   K2 apply_delta_pallas     -> apply_kernel<int8_t | fp8 storage>
//   K3 push_pallas            -> push_kernel
//
// Bound: device-memory bytes.  Each element is read once per input and
// written once per output, with a handful of flops: nothing here comes
// near the arithmetic rate.  The design is a plain streaming pass: one warp
// per 128-lane row (the wire format's row, which carries one scale), four
// f32 per lane with one 16-byte load, the row absmax by a warp shuffle, and
// eight rows (warps) per 256-thread block.  The TPU's block_rows tiling and
// its divisibility rule are gone; a row past the last one exits.
//
// Numerics, so that the codes, scales and residual equal the port's numpy
// host codec (kernels/state_push/hostcodec.py) bitwise on the same input:
//   * absmax / qmax and delta / scale are IEEE divisions (nvcc's default
//     -prec-div=true; this file must never be built with --use_fast_math);
//   * codes round half to even (rintf), as np.rint and torch.round do;
//   * the residual delta - q*s is computed with explicit round-to-nearest
//     intrinsics, so nvcc cannot contract it into an FMA;
//   * fp8 codes are clipped to +-448 first, then converted with
//     __nv_cvt_float_to_fp8(..., __NV_SATFINITE, __NV_E4M3), round to
//     nearest even, as torch's .to(torch.float8_e4m3fn) and ml_dtypes do.

#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kLanes = 128;          // wire row width: 32 lanes x 4 f32
constexpr int kRowsPerBlock = 8;     // one warp per row
constexpr int kThreads = 32 * kRowsPerBlock;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float fp8_to_float(uint32_t byte) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(byte & 0xffu), __NV_E4M3);
  return __half2float(__half(h));   // every e4m3 value is exact in half
}

// K1 / K4.  delta = local - base (base == nullptr: zero base); per-row
// scale = max(absmax / qmax, 1e-12); codes to q (int8, or e4m3 storage when
// kFp8); residual = delta - code * scale when `residual` is not null.
template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ local, const float* __restrict__ base,
                uint8_t* __restrict__ q, float* __restrict__ scales,
                float* __restrict__ residual, int rows, float qmax) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t off = static_cast<int64_t>(row) * kLanes + lane * 4;
  const float4 l = load4(local + off);
  float d[4] = {l.x, l.y, l.z, l.w};
  if (base != nullptr) {
    const float4 b = load4(base + off);
    d[0] = __fsub_rn(l.x, b.x);
    d[1] = __fsub_rn(l.y, b.y);
    d[2] = __fsub_rn(l.z, b.z);
    d[3] = __fsub_rn(l.w, b.w);
  }
  float m = fmaxf(fmaxf(fabsf(d[0]), fabsf(d[1])), fmaxf(fabsf(d[2]), fabsf(d[3])));
  m = warp_max(m);
  const float s = fmaxf(m / qmax, 1e-12f);
  uint32_t packed = 0;
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float c, back;
    uint32_t byte;
    if constexpr (kFp8) {
      c = fminf(fmaxf(d[i] / s, -qmax), qmax);
      byte = __nv_cvt_float_to_fp8(c, __NV_SATFINITE, __NV_E4M3);
      back = fp8_to_float(byte);
    } else {
      c = fminf(fmaxf(rintf(d[i] / s), -qmax), qmax);
      byte = static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(c)));
      back = c;
    }
    packed |= byte << (8 * i);
    r[i] = __fsub_rn(d[i], __fmul_rn(back, s));
  }
  *reinterpret_cast<uint32_t*>(q + off) = packed;
  if (lane == 0) scales[row] = s;
  if (residual != nullptr) {
    *reinterpret_cast<float4*>(residual + off) = make_float4(r[0], r[1], r[2], r[3]);
  }
}

// K2.  out = global + f32(code) * scale (int8 or e4m3 codes).
template <bool kFp8>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ global, const uint8_t* __restrict__ q,
             const float* __restrict__ scales, float* __restrict__ out, int rows) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int64_t off = static_cast<int64_t>(row) * kLanes + lane * 4;
  const float4 g = load4(global + off);
  const uint32_t packed = *reinterpret_cast<const uint32_t*>(q + off);
  const float s = scales[row];
  const float gv[4] = {g.x, g.y, g.z, g.w};
  float o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t byte = (packed >> (8 * i)) & 0xffu;
    const float c = kFp8 ? fp8_to_float(byte)
                         : static_cast<float>(static_cast<int8_t>(byte));
    o[i] = __fadd_rn(gv[i], __fmul_rn(c, s));
  }
  *reinterpret_cast<float4*>(out + off) = make_float4(o[0], o[1], o[2], o[3]);
}

// K3.  out = global + (local - base), the exact fused push.
__global__ void __launch_bounds__(kThreads)
push_kernel(const float* __restrict__ local, const float* __restrict__ base,
            const float* __restrict__ global, float* __restrict__ out, int rows) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int64_t off = static_cast<int64_t>(row) * kLanes + (threadIdx.x % 32) * 4;
  const float4 l = load4(local + off);
  const float4 b = load4(base + off);
  const float4 g = load4(global + off);
  *reinterpret_cast<float4*>(out + off) = make_float4(
      __fadd_rn(g.x, __fsub_rn(l.x, b.x)), __fadd_rn(g.y, __fsub_rn(l.y, b.y)),
      __fadd_rn(g.z, __fsub_rn(l.z, b.z)), __fadd_rn(g.w, __fsub_rn(l.w, b.w)));
}

inline dim3 grid_for(int rows) { return dim3((rows + kRowsPerBlock - 1) / kRowsPerBlock); }

}  // namespace
}  // namespace repro

// C interface (ctypes).  Pointers are device pointers; rows >= 1; every
// row is 128 contiguous elements.  Returns cudaGetLastError() after the
// launch, or -1 for arguments the kernels do not take.

extern "C" int state_push_quantize(const float* local, const float* base,
                                   void* q, float* scales, float* residual,
                                   int rows, float qmax, int fp8, void* stream) {
  using namespace repro;
  if (rows < 1 || !(qmax > 0.f)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* codes = static_cast<uint8_t*>(q);
  if (fp8) {
    quantize_kernel<true><<<grid_for(rows), kThreads, 0, st>>>(
        local, base, codes, scales, residual, rows, qmax);
  } else {
    quantize_kernel<false><<<grid_for(rows), kThreads, 0, st>>>(
        local, base, codes, scales, residual, rows, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int state_push_apply(const float* global, const void* q,
                                const float* scales, float* out, int rows,
                                int fp8, void* stream) {
  using namespace repro;
  if (rows < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* codes = static_cast<const uint8_t*>(q);
  if (fp8) {
    apply_kernel<true><<<grid_for(rows), kThreads, 0, st>>>(global, codes, scales, out, rows);
  } else {
    apply_kernel<false><<<grid_for(rows), kThreads, 0, st>>>(global, codes, scales, out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int state_push_push(const float* local, const float* base,
                               const float* global, float* out, int rows,
                               void* stream) {
  using namespace repro;
  if (rows < 1) return -1;
  push_kernel<<<grid_for(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      local, base, global, out, rows);
  return static_cast<int>(cudaGetLastError());
}
