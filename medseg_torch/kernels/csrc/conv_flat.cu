// Plain 3x3x3 same-pad convolution, fp32 output: the per-conv route of the
// training forward for convs wider than K1's (C_in up to 128). NCDHW, torch
// weight layout (CO, C, 3, 3, 3), fp32 or bf16 operands, fp32 accumulation,
// no prologue, no residual tap, no statistics.
//
// Replaces medseg/kernels/conv3d.py conv3x3x3_flat (_kernel) (K9), the
// flat-lane TPU kernel: its (H+2)*WP lane rows, halo padding in HBM and
// dx-major (3*CO, 9*C) weight matrix exist for the TPU's 128-lane tiles and
// one MXU matmul per z-row; none of it carries over. What it computes does:
// for x (B, C, D, H, W) and w (CO, C, 3, 3, 3) in the compute dtype, the
// zero-padded conv (B, CO, D, H, W) in fp32.
//
// What bounds it on the H100: arithmetic. The routed conv (decoder3.conv1 of
// a feature-size-32 UNETR, 128 -> 64 at 4 x 48^3) is 196 GFLOP against
// 0.11 GB of bf16 input (~1700 FLOP/byte). This first version runs on the
// CUDA cores in fp32 FMA (67 TFLOP/s peak), as K1 does: a block owns a
// 16x16 (y, x) tile of TZ=2 z-slices and CO output channels (16 or 32; a
// wider conv is split over blocks by output-channel group, in one launch);
// a chunk of 8 input channels of its halo tile is staged in shared memory
// beside the chunk's weights laid out [ci][tap][co], read as broadcast
// float4s; each thread keeps the CO fp32 sums of its TZ voxels in registers,
// so one staged input value feeds 2*CO FMAs. The C_in loop is outermost, so
// C_in up to 128 costs time, not registers. Tensor-core tiling is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int FX = 16, FY = 16, FZ = 2;  // output tile of one block
constexpr int FHX = FX + 2, FHY = FY + 2, FHZ = FZ + 2;
constexpr int FHALO = FHX * FHY * FHZ;
constexpr int FTHREADS = FX * FY;
constexpr int FCC = 8;  // input channels per shared-memory chunk

template <int CO>
constexpr int flat_smem_floats() {
  return FCC * FHALO + FCC * 27 * CO;
}

template <typename T, int CO>
__global__ void __launch_bounds__(FTHREADS)
    conv_flat_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ out,
                     int B, int C, int C_out, int D, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;              // [FCC][FHZ][FHY][FHX]
  float* s_w = s_in + FCC * FHALO;  // [FCC][27][CO]

  const int tx = threadIdx.x % FX, ty = threadIdx.x / FX;
  const int x0 = blockIdx.x * FX, y0 = blockIdx.y * FY;
  const int nzt = (D + FZ - 1) / FZ;
  const int per_group = B * nzt;
  const int group = blockIdx.z / per_group;  // output channels co0 .. co0 + CO - 1
  const int rest = blockIdx.z - group * per_group;
  const int b = rest / nzt;
  const int z0 = (rest - b * nzt) * FZ;
  const int co0 = group * CO;
  const long long HW = (long long)H * W;
  const long long V = HW * D;

  float acc[FZ][CO];
#pragma unroll
  for (int z = 0; z < FZ; ++z) {
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[z][co] = 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += FCC) {
    const int cn = min(FCC, C - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < cn * FHALO; i += FTHREADS) {
      const int ci = i / FHALO;
      const int r = i - ci * FHALO;
      const int hz = r / (FHY * FHX);
      const int r2 = r - hz * (FHY * FHX);
      const int hy = r2 / FHX;
      const int hx = r2 - hy * FHX;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      float v = 0.f;
      if (gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_float<T>(x[((long long)b * C + c0 + ci) * V + gz * HW + (long long)gy * W + gx]);
      s_in[i] = v;
    }
    for (int i = threadIdx.x; i < cn * 27 * CO; i += FTHREADS) {
      const int co = i % CO;
      const int t = (i / CO) % 27;
      const int ci = i / (27 * CO);
      s_w[i] = to_float<T>(w[((long long)(co0 + co) * C + c0 + ci) * 27 + t]);
    }
    __syncthreads();

    for (int ci = 0; ci < cn; ++ci) {
      const float* xin = s_in + ci * FHALO + ty * FHX + tx;
      const float* wc = s_w + ci * 27 * CO;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        const int kz = t / 9, ky = (t / 3) % 3, kx = t % 3;
        float v[FZ];
#pragma unroll
        for (int z = 0; z < FZ; ++z) v[z] = xin[((z + kz) * FHY + ky) * FHX + kx];
        const float4* w4 = reinterpret_cast<const float4*>(wc + t * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 wq = w4[q];
#pragma unroll
          for (int z = 0; z < FZ; ++z) {
            acc[z][4 * q + 0] = fmaf(v[z], wq.x, acc[z][4 * q + 0]);
            acc[z][4 * q + 1] = fmaf(v[z], wq.y, acc[z][4 * q + 1]);
            acc[z][4 * q + 2] = fmaf(v[z], wq.z, acc[z][4 * q + 2]);
            acc[z][4 * q + 3] = fmaf(v[z], wq.w, acc[z][4 * q + 3]);
          }
        }
      }
    }
  }

  const int gx = x0 + tx, gy = y0 + ty;
  if (gx >= W || gy >= H) return;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
#pragma unroll
    for (int z = 0; z < FZ; ++z) {
      if (z0 + z < D)
        out[((long long)b * C_out + co0 + co) * V + (z0 + z) * HW + (long long)gy * W + gx] =
            acc[z][co];
    }
  }
}

template <typename T, int CO>
cudaError_t launch_flat(const void* x, const void* w, float* out, int B, int C, int C_out, int D,
                        int H, int W, cudaStream_t stream) {
  const int smem = flat_smem_floats<CO>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(conv_flat_kernel<T, CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const long long nz = (long long)(C_out / CO) * B * ((D + FZ - 1) / FZ);
  if (nz > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((W + FX - 1) / FX, (H + FY - 1) / FY, (unsigned)nz);
  conv_flat_kernel<T, CO><<<grid, FTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), out, B, C, C_out, D, H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flat(int co_tile, const void* x, const void* w, float* out, int B, int C,
                          int C_out, int D, int H, int W, cudaStream_t st) {
  if (C_out % co_tile != 0) return cudaErrorInvalidValue;
  switch (co_tile) {
    case 16:
      return launch_flat<T, 16>(x, w, out, B, C, C_out, D, H, W, st);
    case 32:
      return launch_flat<T, 32>(x, w, out, B, C, C_out, D, H, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the kernel was launched. co_tile (16 or
// 32) divides c_out; the blocks of one launch cover c_out / co_tile groups.
int medseg_conv_flat(int device, int bf16, int co_tile, const void* x, const void* w, float* out,
                     int B, int C, int C_out, int D, int H, int W, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::dispatch_flat<__nv_bfloat16>(co_tile, x, w, out, B, C, C_out, D, H, W, st)
           : medseg::dispatch_flat<float>(co_tile, x, w, out, B, C, C_out, D, H, W, st);
  return (int)e;
}

}  // extern "C"
