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

// The per-(b, c) statistics of K1, K2 and K5 in a fixed order. Each producer
// (a block of conv_of.cu, a tile group of conv_tc.cu) stores its partial sums
// into a slot of its own, part[(k * B * co + e) * nslots + slot], for sum k
// (0: s, 1: ss, 2: rs, 3: rss) of element e = b * co + c; no atomics.
// ``stats_finish`` (conv_of.cu) then launches one block per (k, e), which
// adds the element's partials in an order fixed by nslots alone (thread t:
// slots t, t + 128, ... in turn; the lanes by the same shuffle tree; the
// four warps in order) and writes out_k[e]. So every call on the same inputs
// gives the same bits, whichever blocks ran first. With tiles_per_b > 0 the
// producers are persistent tile groups (group g takes tiles g, g + nslots,
// ... of ntiles, b's tiles being [b * tiles_per_b, (b + 1) * tiles_per_b)),
// and slot g of b is read only where one of g's tiles is b's: the others
// were never written. With 0, every slot was written.
cudaError_t stats_finish(const float* part, int nslots, int nk, int B, int co, int tiles_per_b,
                         int ntiles, float* s, float* ss, float* rs, float* rss,
                         cudaStream_t stream);

// K6's fixed-order reduction (wgrad_tc.cu): dw[i] = the sum over the
// producers' partials partial[k * n + i], k = 0 .. groups - 1, in an order
// fixed by ``groups`` alone; wgrad_tc.cu's and conv_narrow_tc.cu's blocks
// each write their partial once.
cudaError_t wgrad_reduce(const float* partial, float* dw, int n, int groups,
                         cudaStream_t stream);

}  // namespace medseg
