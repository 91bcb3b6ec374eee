// Filter gradient of a 3x3x3 stride-1 zero-padded convolution without a
// prologue, on the tensor cores: bf16 operands, fp32 sums,
//
//   dW[co, ci, kz, ky, kx] = sum over (b, z, y, x) of
//                            g[b, co, z, y, x] * x[b, ci, z+kz-1, y+ky-1, x+kx-1]
//
// written as (CO, C, 3, 3, 3) fp32, torch's own weight layout.
//
// Replaces the TPU kernel medseg/kernels/conv_of.py conv3x3x3_wgrad_of
// (_wgrad_kernel), K6, for bf16 with C % 16 == 0 (C <= 64) and CO in {16,
// 32, 64}; bf16 at C <= 8 takes conv_narrow_tc.cu, the other calls (fp32,
// other widths) keep the CUDA-core kernel of wgrad_of.cu, picked by the
// wrapper's shape and dtype predicates.
//
// What bounds it on the H100: 2*27*C*CO FLOP per voxel, 49 GFLOP for 16->16
// at 4x96^3 (0.050 ms at the bf16 tensor-core rate) against 0.23 GB of
// activations read once (0.068 ms). The CUDA-core kernel ran at 12-15
// TFLOP/s, bound by staging it did not overlap. The design is a GEMM with M
// = CO, N = 27 taps x one 16-channel slice of C and K = voxels:
//   - a block owns one slice (blockIdx.x) and a group of 2x8x16 voxel tiles
//     (blockIdx.y; the grid is sized to the SMs by the wrapper); all of CO
//     is in the block, so the cotangent is read once per slice;
//   - per tile, the 4x10x18 x halo and the 256-voxel cotangent tile are
//     staged channels-last in bf16 (tc_common.cuh's BoxStage, swizzled).
//     Both MMA operands then come from ldmatrix.trans, and every tap's shift
//     is a whole-row offset into the halo;
//   - 9 warps (18 at CO = 64, each with half of CO, so that the sums fit
//     the registers), warp w owning the taps (kz, ky) = (w % 9 / 3, w % 3)
//     and kx = 0..2 of the slice: (its CO) x 48 fp32 sums in its registers
//     across all tiles. One k16 step is one x-row of 16 voxels: the
//     cotangent fragments are loaded once and feed 3 taps x 2 channel octets;
//   - the next tile's global loads are issued into registers before this
//     tile's MMAs and stored after them into the second of two
//     shared-memory stages, one barrier per tile. (cp.async copies bytes as
//     they lie, and NCDHW rows have to be transposed to channels-last on
//     the way in, so the overlap goes through registers.)
//   - the cross-block reduction stays deterministic, as in wgrad_of.cu:
//     each block writes its (CO, slice, 27) sums to its own slot of a
//     (groups, CO, C, 27) buffer, and a second pass sums the slots in group
//     order.
// Measured on the H100 (PERF.md): 11-13% of the bf16 peak, set as in
// conv_tc.cu by the staging (the next tile's loads are not fully hidden
// behind one tile's MMAs), not by the MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace medseg {
namespace {

using tc::BoxStage;
using tc::swz;

constexpr int TX = 16, TY = 8, TZ = 2;  // voxel tile
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int ROWS = TZ * TY;  // x-rows of 16 voxels: one k16 step each

// Threads and m16 tiles per warp: 9 warps, one per (kz, ky); at CO = 64
// two per (kz, ky), each with half of the m16 tiles. Blocks per SM the
// registers are sized for: two at CO = 16 (measured 17-21% faster than one
// with more registers); at CO = 32 a second block's register cap spills.
template <int CO>
struct Cfg {
  static constexpr int SPLIT = CO == 64 ? 2 : 1;
  static constexpr int NT = 288 * SPLIT;
  static constexpr int MT = CO / 16 / SPLIT;
  static constexpr int BLOCKS = CO == 16 ? 2 : 1;
};
template <int CO>
using XHalo = BoxStage<HZ, HY, HX, 16, Cfg<CO>::NT>;
template <int CO>
using GTile = BoxStage<TZ, TY, TX, CO, Cfg<CO>::NT>;

struct WgradTcArgs {
  const __nv_bfloat16* x;  // (B, C, D, H, W)
  const __nv_bfloat16* g;  // (B, CO, D, H, W)
  float* partial;          // (gridDim.y, CO, C, 27)
  int B, C, D, H, W;
};

// Bytes of one shared-memory stage: the x halo and the cotangent tile (a
// struct, so that device code can read it)
template <int CO>
struct Stage {
  static constexpr int BYTES = XHalo<CO>::BYTES + GTile<CO>::BYTES;
};

template <int CO>
__global__ void __launch_bounds__(Cfg<CO>::NT, Cfg<CO>::BLOCKS) wgrad_tc_kernel(WgradTcArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int STAGE = Stage<CO>::BYTES;
  constexpr int MT = Cfg<CO>::MT;  // this warp's m16 tiles of CO: m0, m0 + 1, ...
  constexpr int XB = XHalo<CO>::BYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kz = warp % 9 / 3, ky = warp % 3, m0 = warp / 9 * MT;
  const int c0 = blockIdx.x * 16;
  const long long V = (long long)p.D * p.H * p.W;
  const int ntx = (p.W + TX - 1) / TX, nty = (p.H + TY - 1) / TY, ntz = (p.D + TZ - 1) / TZ;
  const long long ntiles = (long long)p.B * ntz * nty * ntx;

  float acc[MT][3][2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][k][n][e] = 0.f;

  XHalo<CO> xs;
  GTile<CO> gs;
  auto load = [&](long long tile) {
    long long r = tile;
    const int tx = (int)(r % ntx);
    r /= ntx;
    const int ty = (int)(r % nty);
    r /= nty;
    const int tz = (int)(r % ntz);
    const int b = (int)(r / ntz);
    const int z0 = tz * TZ, y0 = ty * TY, x0 = tx * TX;
    xs.load(p.x + ((long long)b * p.C + c0) * V, V, p.D, p.H, p.W, z0 - 1, y0 - 1, x0 - 1);
    gs.load(p.g + (long long)b * CO * V, V, p.D, p.H, p.W, z0, y0, x0);
  };
  auto store = [&](int it) {
    unsigned char* st = smem + (it & 1) * STAGE;
    xs.template store<false>(st, nullptr, nullptr);
    gs.template store<false>(st + XB, nullptr, nullptr);
  };

  // this lane's ldmatrix rows: A (cotangent, .trans) voxel and channel
  // chunk; B (x halo, .trans) voxel and channel chunk
  const int a_vox = ((lane >> 4) << 3) + (lane & 7);
  const int a_chunk = (lane >> 3) & 1;
  const int b_chunk = lane >> 4;

  long long tile = blockIdx.y;
  int it = 0;
  if (tile < ntiles) {
    load(tile);
    store(0);
  }
  __syncthreads();
  for (; tile < ntiles; tile += gridDim.y, ++it) {
    const long long next = tile + gridDim.y;
    if (next < ntiles) load(next);
    const uint32_t x_base = tc::smem_u32(smem + (it & 1) * STAGE);
    const uint32_t g_base = x_base + XB;
#pragma unroll 2
    for (int r = 0; r < ROWS; ++r) {
      const int tz = r / TY, ty = r % TY;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        tc::ldsm_x4_trans(g_base + swz<CO * 2>(r * TX + a_vox, 2 * (m0 + m) + a_chunk), a[m]);
      const int vb = ((tz + kz) * HY + ty + ky) * HX + (lane & 15);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        uint32_t bx[4];
        tc::ldsm_x4_trans(x_base + swz<32>(vb + kx, b_chunk), bx);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          tc::mma_bf16(acc[m][kx][0], a[m], bx[0], bx[1]);
          tc::mma_bf16(acc[m][kx][1], a[m], bx[2], bx[3]);
        }
      }
    }
    if (next < ntiles) store(it + 1);
    __syncthreads();
  }

  // fragment (m, kx, n, e): co = 16 (m0 + m) + lane/4 (+8 for e >= 2), ci =
  // 8n + 2*(lane%4) + (e & 1), tap = 9kz + 3ky + kx
  float* out = p.partial + (long long)blockIdx.y * CO * p.C * 27;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = 16 * (m0 + m) + (lane >> 2) + 8 * (e >> 1);
          const int ci = c0 + 8 * n + 2 * (lane & 3) + (e & 1);
          out[((long long)co * p.C + ci) * 27 + 9 * kz + 3 * ky + kx] = acc[m][kx][n][e];
        }
}

// dW[i] = sum over the groups of partial[group][i] in a fixed order: lane y
// of a block column sums groups y, y + RED_Y, ... in turn, then the column's
// RED_Y sums are added in lane order (deterministic, and RED_Y loads in
// flight per output instead of one chain of ``groups`` dependent ones).
constexpr int RED_X = 32, RED_Y = 8;

__global__ void __launch_bounds__(RED_X * RED_Y)
    wgrad_tc_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int n,
                           int groups) {
  __shared__ float part[RED_Y][RED_X];
  const int i = blockIdx.x * RED_X + threadIdx.x;
  float s = 0.f;
  if (i < n)
    for (int k = threadIdx.y; k < groups; k += RED_Y) s += partial[(long long)k * n + i];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < RED_Y; ++y) t += part[y][threadIdx.x];
    dw[i] = t;
  }
}

template <int CO>
cudaError_t launch(const WgradTcArgs& p, int groups, float* dw, cudaStream_t st) {
  const int smem = 2 * Stage<CO>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(wgrad_tc_kernel<CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  constexpr int nt = Cfg<CO>::NT;
  wgrad_tc_kernel<CO><<<dim3(p.C / 16, groups), nt, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return wgrad_reduce(p.partial, dw, CO * p.C * 27, groups, st);
}

}  // namespace

cudaError_t wgrad_reduce(const float* partial, float* dw, int n, int groups,
                         cudaStream_t stream) {
  wgrad_tc_reduce_kernel<<<(n + RED_X - 1) / RED_X, dim3(RED_X, RED_Y), 0, stream>>>(partial, dw,
                                                                                    n, groups);
  return cudaGetLastError();
}

}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when both kernels were launched. x and g
// are bf16; C a multiple of 16 up to 64; c_out 16, 32 or 64; partial holds
// groups * c_out * C * 27 floats; dw (c_out, C, 3, 3, 3) fp32 is written,
// not accumulated.
int medseg_wgrad_tc(int device, int c_out, const void* x, const void* g, float* partial, float* dw,
                    int B, int C, int D, int H, int W, int groups, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (groups < 1 || C < 16 || C > 64 || C % 16 != 0) return (int)cudaErrorInvalidValue;
  const medseg::WgradTcArgs p{static_cast<const __nv_bfloat16*>(x),
                              static_cast<const __nv_bfloat16*>(g), partial, B, C, D, H, W};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_out) {
    case 16:
      return (int)medseg::launch<16>(p, groups, dw, st);
    case 32:
      return (int)medseg::launch<32>(p, groups, dw, st);
    case 64:
      return (int)medseg::launch<64>(p, groups, dw, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
