// Filter gradient of a 3x3x3 stride-1 zero-padded convolution without a
// prologue. NCDHW activations, fp32 or bf16 operands, fp32 sums:
//
//   dW[co, ci, kz, ky, kx] = sum over (b, z, y, x) of
//                            g[b, co, z, y, x] * x[b, ci, z+kz-1, y+ky-1, x+kx-1]
//
// written as (CO, C, 3, 3, 3) fp32, torch's own weight layout.
//
// Replaces the TPU kernel medseg/kernels/conv_of.py conv3x3x3_wgrad_of
// (_wgrad_kernel) (K6). The TPU summed one (3*CO, 9*C) product per step of
// its sequential (b, z-block) grid into one output block; Hopper blocks run
// in parallel and in no order.
//
// What bounds it on the H100: arithmetic. 2*27*C*CO FLOP per voxel: 49 GFLOP
// for 16->16 at 4x96^3 (and for 64->32 at 4x48^3) against 0.23 GB of bf16
// activations read once. This first version runs on the CUDA cores in fp32
// FMA, not on the tensor cores. The trap is the reduction: every one of the
// 27*C*CO outputs sums over all 3.5 M voxels, and one atomicAdd per tile and
// weight would be tens of millions of atomics on the same few thousand
// addresses. The design:
//   - a block owns one chunk of WCC input channels (blockIdx.x) and a group
//     of voxel tiles (blockIdx.y): the grid is sized to the SMs by the
//     wrapper, and each block loops over many 1x16x16 (z, y, x) tiles;
//   - per tile, the x halo (3x18x18 for the chunk's channels) and the g tile
//     (CO x 256, stored [voxel][CO] so that g rows are broadcast float4
//     reads) are staged in shared memory;
//   - thread t owns one (ci, tap) pair of the chunk (27*WCC = 216 pairs) and
//     keeps its CO fp32 sums in registers across all of its tiles: one
//     shared-memory x value feeds CO FMAs. With fewer channels than WCC
//     (C = 1 at enc1.conv1: 27 pairs) the threads split the tile's voxels in
//     groups, reduced through shared memory at the end;
//   - each block writes its (CO, chunk, 27) partial sums once to its own slot
//     of a (groups, CO, C, 27) buffer, and a second pass sums the slots in a
//     fixed order: no atomics, deterministic, as the TPU's sequential grid
//     was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int WTX = 16, WTY = 16;  // voxel tile: one z-slice of 16x16 (y, x)
constexpr int WHX = WTX + 2, WHY = WTY + 2, WHZ = 3;
constexpr int WHALO = WHX * WHY * WHZ;  // 972 staged x values per channel
constexpr int WNV = WTX * WTY;          // 256 voxels per tile
constexpr int WTHREADS = 256;
constexpr int WCC = 8;  // input channels per block: 27 * 8 = 216 (ci, tap) pairs

constexpr int GPAD = 4;  // g rows of CO + GPAD floats: float4-aligned, fewer bank conflicts

template <int CO>
constexpr int wgrad_smem_floats() {
  return WCC * WHALO + WNV * (CO + GPAD);
}

struct WgradArgs {
  const void* x;   // (B, C, D, H, W)
  const void* g;   // (B, CO, D, H, W)
  float* partial;  // (gridDim.y, CO, C, 27)
  int B, C, D, H, W;
};

template <typename T, int CO>
__global__ void __launch_bounds__(WTHREADS) wgrad_kernel(WgradArgs p) {
  constexpr int GS = CO + GPAD;
  static_assert(WNV * CO <= WCC * WHALO + WNV * GS, "the reduction fits the staging area");
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;               // [WCC][WHZ][WHY][WHX]
  float* s_g = s_x + WCC * WHALO;  // [WNV][GS]

  const int c0 = blockIdx.x * WCC;
  const int cn = min(WCC, p.C - c0);
  const int npair = 27 * cn;
  const int vsplit = max(1, WTHREADS / npair);  // voxel groups of the tile
  const int t = threadIdx.x;
  const int pair = t % npair;
  const int grp = t / npair;
  const bool active = grp < vsplit;
  const int ci = pair / 27;
  const int tap = pair - ci * 27;
  const int kz = tap / 9, ky = (tap / 3) % 3, kx = tap % 3;
  const int x_off = ci * WHALO + (kz * WHY + ky) * WHX + kx;

  const T* x = static_cast<const T*>(p.x);
  const T* g = static_cast<const T*>(p.g);
  const long long HW = (long long)p.H * p.W;
  const long long V = HW * p.D;
  const int ntx = (p.W + WTX - 1) / WTX, nty = (p.H + WTY - 1) / WTY;
  const long long ntiles = (long long)p.B * p.D * nty * ntx;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (long long tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    long long r = tile;
    const int tx = (int)(r % ntx);
    r /= ntx;
    const int ty = (int)(r % nty);
    r /= nty;
    const int z = (int)(r % p.D);
    const int b = (int)(r / p.D);
    const int x0 = tx * WTX, y0 = ty * WTY;

    __syncthreads();  // the previous tile is consumed
    for (int i = t; i < cn * WHALO; i += WTHREADS) {
      const int c = i / WHALO;
      const int q = i - c * WHALO;
      const int hz = q / (WHY * WHX);
      const int q2 = q - hz * (WHY * WHX);
      const int hy = q2 / WHX;
      const int hx = q2 - hy * WHX;
      const int gz = z + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      float v = 0.f;
      if (gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
        v = to_float<T>(x[((long long)b * p.C + c0 + c) * V + gz * HW + (long long)gy * p.W + gx]);
      s_x[i] = v;
    }
    for (int i = t; i < CO * WNV; i += WTHREADS) {
      const int co = i / WNV;
      const int v = i - co * WNV;
      const int vy = v / WTX, vx = v - (v / WTX) * WTX;
      const int gy = y0 + vy, gx = x0 + vx;
      float val = 0.f;  // voxels past the volume's edge add nothing
      if (gy < p.H && gx < p.W)
        val = to_float<T>(g[((long long)b * CO + co) * V + z * HW + (long long)gy * p.W + gx]);
      s_g[v * GS + co] = val;
    }
    __syncthreads();

    if (active) {
      for (int v = grp; v < WNV; v += vsplit) {
        const int vy = v / WTX, vx = v - (v / WTX) * WTX;
        const float xv = s_x[x_off + vy * WHX + vx];
        const float4* g4 = reinterpret_cast<const float4*>(s_g + v * GS);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 gq = g4[q];
          acc[4 * q + 0] = fmaf(xv, gq.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, gq.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, gq.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, gq.w, acc[4 * q + 3]);
        }
      }
    }
  }

  // Sum the voxel groups' shares (in group order) and write this block's
  // partial (CO, chunk, 27) sums to its slot.
  __syncthreads();
  float* s_red = smem;  // [vsplit][npair][CO] <= WTHREADS * CO floats
  if (active) {
#pragma unroll
    for (int co = 0; co < CO; ++co) s_red[(grp * npair + pair) * CO + co] = acc[co];
  }
  __syncthreads();
  float* out = p.partial + (long long)blockIdx.y * CO * p.C * 27;
  for (int i = t; i < npair * CO; i += WTHREADS) {
    const int pr = i / CO;
    const int co = i - pr * CO;
    float s = 0.f;
    for (int k = 0; k < vsplit; ++k) s += s_red[(k * npair + pr) * CO + co];
    out[((long long)co * p.C + c0) * 27 + pr] = s;  // pr = ci*27 + tap within the chunk
  }
}

// dW[i] = sum over the groups of partial[group][i], in group order.
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                    int n, int groups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < groups; ++k) s += partial[(long long)k * n + i];
  dw[i] = s;
}

template <typename T, int CO>
cudaError_t launch_wgrad(const WgradArgs& p, int groups, float* dw, cudaStream_t st) {
  const int smem = wgrad_smem_floats<CO>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(wgrad_kernel<T, CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((p.C + WCC - 1) / WCC, groups);
  wgrad_kernel<T, CO><<<grid, WTHREADS, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = CO * p.C * 27;
  wgrad_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(p.partial, dw, n, groups);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_wgrad(int c_out, const WgradArgs& p, int groups, float* dw,
                           cudaStream_t st) {
  switch (c_out) {
    case 16:
      return launch_wgrad<T, 16>(p, groups, dw, st);
    case 32:
      return launch_wgrad<T, 32>(p, groups, dw, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when both kernels were launched. x and g
// are in the compute dtype (bf16 != 0: bfloat16); partial holds
// groups * c_out * C * 27 floats; dw (c_out, C, 3, 3, 3) fp32 is written,
// not accumulated.
int medseg_wgrad(int device, int bf16, int c_out, const void* x, const void* g, float* partial,
                 float* dw, int B, int C, int D, int H, int W, int groups, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (groups < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const medseg::WgradArgs p{x, g, partial, B, C, D, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::dispatch_wgrad<__nv_bfloat16>(c_out, p, groups, dw, st)
           : medseg::dispatch_wgrad<float>(c_out, p, groups, dw, st);
  return (int)e;
}

}  // extern "C"
