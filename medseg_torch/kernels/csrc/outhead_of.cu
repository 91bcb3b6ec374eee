// Final residual-block combine + LeakyReLU + 1x1x1 out head + bias, times
// the per-voxel sliding-window blend weight, in one pass. NCDHW.
//
// Replaces the TPU kernel medseg/kernels/conv_of.py outhead_of
// (_outhead_kernel, non-transposed form) (K3):
//   comb[c]   = leaky(az[b,c]*z[c] + bz[b,c] + ar[b,c]*res[c] + br[b,c]), rounded
//               to the compute dtype
//   logits[k] = (sum_c K[k,c]*comb[c] + bias[k]) * scale        (fp32 sums,
//               stored in the compute dtype)
// Pad classes (k >= n_classes) carry bias*scale; callers crop them.
//
// What bounds it on the H100: device memory. Per voxel it reads 2*C values
// (2*16 bf16 = 64 B) and the fp32 scale, and writes K_pad logits (32 B in
// bf16, 64 B in fp32), for 2*C*K_pad = 512 FLOP: ~5 FLOP/byte, far below the
// card's ~300 FLOP/byte balance. So one thread per voxel, consecutive
// threads on consecutive voxels (every load and store of a channel plane is
// coalesced), the K_pad x C head, its bias and the block's four per-channel
// affines in shared memory, the C combined values in registers. No
// intermediate touches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int MAXC = 64;  // channels held in registers (feature_size <= 64)
constexpr int NTHREADS = 256;

template <typename T, bool SCALED>
__global__ void __launch_bounds__(NTHREADS)
    outhead_kernel(const T* __restrict__ z, const T* __restrict__ r, const float* az,
                   const float* bz, const float* ar, const float* br, const T* kout,
                   const float* bias, const float* __restrict__ scale, T* __restrict__ out, int C,
                   int K, long long V) {
  extern __shared__ float sm[];
  float* s_k = sm;             // [K][C]
  float* s_bias = s_k + K * C;  // [K]
  float* s_aff = s_bias + K;    // [4][C]: az, bz, ar, br of this batch element
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < K * C; i += NTHREADS) s_k[i] = to_float<T>(kout[i]);
  for (int i = threadIdx.x; i < K; i += NTHREADS) s_bias[i] = bias[i];
  for (int i = threadIdx.x; i < C; i += NTHREADS) {
    s_aff[i] = az[b * C + i];
    s_aff[C + i] = bz[b * C + i];
    s_aff[2 * C + i] = ar[b * C + i];
    s_aff[3 * C + i] = br[b * C + i];
  }
  __syncthreads();

  const long long v = (long long)blockIdx.x * NTHREADS + threadIdx.x;
  if (v >= V) return;
  float comb[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    comb[c] = 0.f;
    if (c < C) {
      const long long off = ((long long)b * C + c) * V + v;
      const float t = to_float<T>(z[off]) * s_aff[c] + s_aff[C + c] +
                      to_float<T>(r[off]) * s_aff[2 * C + c] + s_aff[3 * C + c];
      comb[c] = round_to<T>(leaky(t));
    }
  }
  const float sc = SCALED ? scale[(long long)b * V + v] : 1.f;
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c)
      if (c < C) acc = fmaf(s_k[k * C + c], comb[c], acc);
    acc += s_bias[k];
    if (SCALED) acc *= sc;
    out[((long long)b * K + k) * V + v] = from_float<T>(acc);
  }
}

template <typename T>
cudaError_t launch(int scaled, const void* z, const void* r, const float* az, const float* bz,
                   const float* ar, const float* br, const void* kout, const float* bias,
                   const float* scale, void* out, int B, int C, int K, long long V,
                   cudaStream_t st) {
  if (C > MAXC) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((V + NTHREADS - 1) / NTHREADS), B);
  const size_t smem = (size_t)(K * C + K + 4 * C) * sizeof(float);
  const T* zt = static_cast<const T*>(z);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(kout);
  T* ot = static_cast<T*>(out);
  if (scaled)
    outhead_kernel<T, true>
        <<<grid, NTHREADS, smem, st>>>(zt, rt, az, bz, ar, br, kt, bias, scale, ot, C, K, V);
  else
    outhead_kernel<T, false>
        <<<grid, NTHREADS, smem, st>>>(zt, rt, az, bz, ar, br, kt, bias, scale, ot, C, K, V);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the kernel was launched. z, res,
// kout and the logits are in the compute dtype (bf16 != 0: bfloat16).
int medseg_outhead(int device, int bf16, int scaled, const void* z, const void* r,
                   const float* az, const float* bz, const float* ar, const float* br,
                   const void* kout, const float* bias, const float* scale, void* out, int B,
                   int C, int K, long long V, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::launch<__nv_bfloat16>(scaled, z, r, az, bz, ar, br, kout, bias, scale, out,
                                           B, C, K, V, st)
           : medseg::launch<float>(scaled, z, r, az, bz, ar, br, kout, bias, scale, out, B, C, K,
                                   V, st);
  return (int)e;
}

}  // extern "C"
