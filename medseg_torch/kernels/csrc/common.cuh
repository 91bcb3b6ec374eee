// Shared device helpers of the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace medseg {

constexpr float kLeakySlope = 0.01f;  // MONAI dynunet LeakyReLU

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : kLeakySlope * v; }

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// A value as the compute dtype T holds it: operands are rounded to T before
// they are multiplied, sums stay fp32 (the reference's numerics class).
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float<T>(from_float<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace medseg
