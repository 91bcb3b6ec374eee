// Fused 3x3x3 same-pad convolution with an input prologue, a residual 1x1x1
// tap and instance-norm statistics in the epilogue. NCDHW, torch weight
// layouts, fp32 or bf16 operands, fp32 accumulation.
//
// Replaces three TPU kernels of medseg/kernels/conv_of.py, one template each
// input mode:
//   - conv3x3x3_of          (_kernel):         modes PLAIN and AFFINE (K1)
//   - conv3x3x3_of_cat2     (_cat2_kernel):    mode CAT2              (K5)
//   - conv3x3x3_of_combine  (_combine_kernel): mode COMBINE           (K2)
// Input modes (channel ci of the conv input, before the zero padding):
//   PLAIN    x[ci]
//   AFFINE   leaky(a[b,ci] * x[ci] + b[b,ci])              (previous norm + act)
//   CAT2     [xa ; xb][ci]                                   (no concat in HBM)
//   COMBINE  [up ; leaky(ay*y + by + ax*x + bx)][ci]         (x: 1 or C/2 channels)
// Taps outside the volume are zero in the TRANSFORMED space (leaky(a*0+b) is
// not 0), as the reference masks after its prologue.
//
// What bounds it on the H100: arithmetic. A 16->16 conv at 4x96^3 is 49
// GFLOP against 0.23 GB of bf16 activations (~200 FLOP/byte), and this first
// version runs on the CUDA cores in fp32 FMA (67 TFLOP/s peak), not on the
// tensor cores. The design keeps the FMA pipe fed from registers and
// shared memory: a block owns a 16x16 (y, x) tile of TZ=2 z-slices; a chunk
// of CC input channels of its halo tile is staged in shared memory with the
// prologue applied once per staged value, beside the chunk's weights laid
// out [ci][tap][co] so that each thread reads them as broadcast float4s.
// Each thread keeps the C_out fp32 sums of its TZ voxels in registers (one
// input load feeds 2*C_out FMAs). Epilogue: store in the output dtype, warp
// and block reduce per-channel sum and sum of squares of the fp32 values
// into the block's own slot of the partial sums, which ``stats_finish``
// adds in a fixed order (the TPU summed over its sequential z grid; Hopper
// blocks run in parallel, and atomics would add in a varying order).
// Tensor-core tiling is conv_tc.cu's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int TX = 16, TY = 16, TZ = 2;  // output tile of one block
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int HALO = HX * HY * HZ;
constexpr int NTHREADS = TX * TY;
constexpr int NWARPS = NTHREADS / 32;
constexpr int CC = 8;  // input channels per shared-memory chunk

enum Mode : int { PLAIN = 0, AFFINE = 1, CAT2 = 2, COMBINE = 3 };

struct ConvArgs {
  const void* x0;  // PLAIN/AFFINE: x; CAT2: xa; COMBINE: up      (B, C or C/2, D, H, W)
  const void* x1;  // CAT2: xb; COMBINE: y                        (B, C/2, D, H, W)
  const void* x2;  // COMBINE: residual stream x                  (B, Cx, D, H, W)
  const float* a0;  // AFFINE: a (B, C); COMBINE: ay (B, C/2)
  const float* b0;  // AFFINE: b; COMBINE: by
  const float* a1;  // COMBINE: ax (B, C/2)
  const float* b1;  // COMBINE: bx
  const void* w;     // (CO, C, 3, 3, 3)
  const void* wres;  // (CO, C) residual tap, or null
  void* out;         // (B, CO, D, H, W)
  float* s;          // (B, CO) sum, written by stats_finish
  float* ss;         // (B, CO) sum of squares
  void* res;
  float* rs;
  float* rss;
  int B, C, Ch, Cx, D, H, W;
  float* part;       // the blocks' partial sums: [2 or 4][B][CO][nslots]
  int nslots;        // blocks per batch element
};

template <typename T, int MODE>
__device__ __forceinline__ float load_input(const ConvArgs& p, int b, int ci, long long vox,
                                            long long V) {
  const T* x0 = static_cast<const T*>(p.x0);
  if constexpr (MODE == PLAIN) {
    return to_float<T>(x0[((long long)b * p.C + ci) * V + vox]);
  } else if constexpr (MODE == AFFINE) {
    const int k = b * p.C + ci;
    return leaky(to_float<T>(x0[(long long)k * V + vox]) * p.a0[k] + p.b0[k]);
  } else {
    if (ci < p.Ch) return to_float<T>(x0[((long long)b * p.Ch + ci) * V + vox]);
    const T* x1 = static_cast<const T*>(p.x1);
    const int c = ci - p.Ch;
    const int k = b * p.Ch + c;
    if constexpr (MODE == CAT2) {
      return to_float<T>(x1[(long long)k * V + vox]);
    } else {
      const T* x2 = static_cast<const T*>(p.x2);
      const int cx = p.Cx == 1 ? 0 : c;
      const float y = to_float<T>(x1[(long long)k * V + vox]);
      const float xv = to_float<T>(x2[((long long)b * p.Cx + cx) * V + vox]);
      return leaky(y * p.a0[k] + p.b0[k] + xv * p.a1[k] + p.b1[k]);
    }
  }
}

template <bool RES, int CO>
constexpr int smem_floats() {
  return CC * HALO + CC * 27 * CO + (RES ? CC * CO : 0) + 2 * NWARPS * CO;
}

// Store TZ voxels x CO channels and the block's per-channel sum and sum of
// squares (of the fp32 values) into its slot of sums k0 and k0 + 1.
template <typename T, int CO>
__device__ __forceinline__ void store_with_stats(const float (&acc)[TZ][CO], T* out, int k0,
                                                 int slot, float* s_red, const ConvArgs& p,
                                                 int b, int z0, int gy, int gx, bool in_xy) {
  const long long HW = (long long)p.H * p.W;
  const long long V = HW * p.D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int z = 0; z < TZ; ++z) {
      if (in_xy && z0 + z < p.D) {
        const float v = acc[z][co];
        out[((long long)b * CO + co) * V + (z0 + z) * HW + (long long)gy * p.W + gx] =
            from_float<T>(v);
        sum += v;
        sq += v * v;
      }
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    if (lane == 0) {
      s_red[warp * CO + co] = sum;
      s_red[(NWARPS + warp) * CO + co] = sq;
    }
  }
  __syncthreads();
  if (threadIdx.x < CO) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      sum += s_red[w * CO + threadIdx.x];
      sq += s_red[(NWARPS + w) * CO + threadIdx.x];
    }
    const long long n = (long long)p.B * CO, e = (long long)b * CO + threadIdx.x;
    p.part[(k0 * n + e) * p.nslots + slot] = sum;
    p.part[((k0 + 1) * n + e) * p.nslots + slot] = sq;
  }
}

template <typename T, int MODE, bool RES, int CO>
__global__ void __launch_bounds__(NTHREADS) conv3_kernel(ConvArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* s_in = smem;                                 // [CC][HZ][HY][HX]
  float* s_w = s_in + CC * HALO;                      // [CC][27][CO]
  float* s_wr = s_w + CC * 27 * CO;                   // [CC][CO]
  float* s_red = s_wr + (RES ? CC * CO : 0);          // [2][NWARPS][CO]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  const int nzt = (p.D + TZ - 1) / TZ;
  const int b = blockIdx.z / nzt;
  const int z0 = (blockIdx.z - b * nzt) * TZ;
  const long long HW = (long long)p.H * p.W;
  const long long V = HW * p.D;
  const T* w = static_cast<const T*>(p.w);
  const T* wres = static_cast<const T*>(p.wres);

  float acc[TZ][CO];
  float racc[TZ][RES ? CO : 1];
#pragma unroll
  for (int z = 0; z < TZ; ++z) {
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[z][co] = 0.f;
#pragma unroll
    for (int co = 0; co < (RES ? CO : 1); ++co) racc[z][co] = 0.f;
  }

  for (int c0 = 0; c0 < p.C; c0 += CC) {
    const int cn = min(CC, p.C - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < cn * HALO; i += NTHREADS) {
      const int ci = i / HALO;
      const int r = i - ci * HALO;
      const int hz = r / (HY * HX);
      const int r2 = r - hz * (HY * HX);
      const int hy = r2 / HX;
      const int hx = r2 - hy * HX;
      const int gz = z0 + hz - 1, gy = y0 + hy - 1, gx = x0 + hx - 1;
      float v = 0.f;
      if (gz >= 0 && gz < p.D && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
        v = round_to<T>(load_input<T, MODE>(p, b, c0 + ci, gz * HW + (long long)gy * p.W + gx, V));
      s_in[i] = v;
    }
    for (int i = threadIdx.x; i < cn * 27 * CO; i += NTHREADS) {
      const int co = i % CO;
      const int t = (i / CO) % 27;
      const int ci = i / (27 * CO);
      s_w[i] = to_float<T>(w[((long long)co * p.C + c0 + ci) * 27 + t]);
    }
    if constexpr (RES) {
      for (int i = threadIdx.x; i < cn * CO; i += NTHREADS) {
        const int co = i % CO, ci = i / CO;
        s_wr[i] = to_float<T>(wres[(long long)co * p.C + c0 + ci]);
      }
    }
    __syncthreads();

    for (int ci = 0; ci < cn; ++ci) {
      const float* xin = s_in + ci * HALO + ty * HX + tx;
      const float* wc = s_w + ci * 27 * CO;
#pragma unroll
      for (int t = 0; t < 27; ++t) {
        const int kz = t / 9, ky = (t / 3) % 3, kx = t % 3;
        float v[TZ];
#pragma unroll
        for (int z = 0; z < TZ; ++z) v[z] = xin[((z + kz) * HY + ky) * HX + kx];
        const float4* w4 = reinterpret_cast<const float4*>(wc + t * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 wq = w4[q];
#pragma unroll
          for (int z = 0; z < TZ; ++z) {
            acc[z][4 * q + 0] = fmaf(v[z], wq.x, acc[z][4 * q + 0]);
            acc[z][4 * q + 1] = fmaf(v[z], wq.y, acc[z][4 * q + 1]);
            acc[z][4 * q + 2] = fmaf(v[z], wq.z, acc[z][4 * q + 2]);
            acc[z][4 * q + 3] = fmaf(v[z], wq.w, acc[z][4 * q + 3]);
          }
        }
      }
      if constexpr (RES) {  // 1x1x1 tap on the same transformed center voxel
        float v[TZ];
#pragma unroll
        for (int z = 0; z < TZ; ++z) v[z] = xin[((z + 1) * HY + 1) * HX + 1];
        const float4* r4 = reinterpret_cast<const float4*>(s_wr + ci * CO);
#pragma unroll
        for (int q = 0; q < CO / 4; ++q) {
          const float4 wq = r4[q];
#pragma unroll
          for (int z = 0; z < TZ; ++z) {
            racc[z][4 * q + 0] = fmaf(v[z], wq.x, racc[z][4 * q + 0]);
            racc[z][4 * q + 1] = fmaf(v[z], wq.y, racc[z][4 * q + 1]);
            racc[z][4 * q + 2] = fmaf(v[z], wq.z, racc[z][4 * q + 2]);
            racc[z][4 * q + 3] = fmaf(v[z], wq.w, racc[z][4 * q + 3]);
          }
        }
      }
    }
  }

  const int gx = x0 + tx, gy = y0 + ty;
  const bool in_xy = gx < p.W && gy < p.H;
  // the block's slot among the nslots = gridDim.x * gridDim.y * nzt of its b
  const int slot = ((blockIdx.z - b * nzt) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  store_with_stats<T, CO>(acc, static_cast<T*>(p.out), 0, slot, s_red, p, b, z0, gy, gx, in_xy);
  if constexpr (RES) {
    __syncthreads();  // s_red is reused
    store_with_stats<T, CO>(racc, static_cast<T*>(p.res), 2, slot, s_red, p, b, z0, gy, gx,
                            in_xy);
  }
}

constexpr int FINISH_THREADS = 128;

// Whether group g (of nslots, taking tiles g, g + nslots, ... < ntiles)
// took a tile of batch element b (tiles [b * tiles_per_b, (b + 1) *
// tiles_per_b)); always with tiles_per_b == 0.
__device__ __forceinline__ bool slot_written(int g, int b, int nslots, int tiles_per_b,
                                             int ntiles) {
  if (tiles_per_b == 0) return true;
  const long long lo = (long long)b * tiles_per_b;
  const long long hi = lo + tiles_per_b < ntiles ? lo + tiles_per_b : ntiles;
  const long long first = g >= lo ? g : g + (lo - g + nslots - 1) / nslots * nslots;
  return first < hi;
}

__global__ void __launch_bounds__(FINISH_THREADS)
    stats_finish_kernel(const float* __restrict__ part, int nslots, int B, int co,
                        int tiles_per_b, int ntiles, float* s, float* ss, float* rs, float* rss) {
  __shared__ float warps[FINISH_THREADS / 32];
  const int e = blockIdx.x;  // (k, element)
  const int n_elem = B * co;
  const int b = (e % n_elem) / co;
  const float* src = part + (long long)e * nslots;
  float v = 0.f;
  for (int j = threadIdx.x; j < nslots; j += FINISH_THREADS)
    if (slot_written(j, b, nslots, tiles_per_b, ntiles)) v += src[j];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < FINISH_THREADS / 32; ++w) total += warps[w];
    const int k = e / n_elem;
    float* out = k == 0 ? s : (k == 1 ? ss : (k == 2 ? rs : rss));
    out[e - k * n_elem] = total;
  }
}

template <typename T, int MODE, bool RES, int CO>
cudaError_t launch(ConvArgs p, cudaStream_t stream) {
  const int smem = smem_floats<RES, CO>() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(conv3_kernel<T, MODE, RES, CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int nzt = (p.D + TZ - 1) / TZ;
  const dim3 grid((p.W + TX - 1) / TX, (p.H + TY - 1) / TY, p.B * nzt);
  const long long nslots = (long long)grid.x * grid.y * nzt;
  if (nslots > p.nslots) return cudaErrorInvalidValue;  // the caller's partial-sum buffer
  p.nslots = (int)nslots;
  if (p.B == 0 || nslots == 0) return cudaSuccess;
  conv3_kernel<T, MODE, RES, CO><<<grid, NTHREADS, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return stats_finish(p.part, p.nslots, RES ? 4 : 2, p.B, CO, 0, 0, p.s, p.ss, p.rs, p.rss,
                      stream);
}

template <typename T, int CO>
cudaError_t dispatch_mode(int mode, int residual, const ConvArgs& p, cudaStream_t st) {
  switch (mode) {
    case PLAIN:
      return residual ? launch<T, PLAIN, true, CO>(p, st) : launch<T, PLAIN, false, CO>(p, st);
    case AFFINE:
      return residual ? launch<T, AFFINE, true, CO>(p, st) : launch<T, AFFINE, false, CO>(p, st);
    case CAT2:
      return residual ? launch<T, CAT2, true, CO>(p, st) : cudaErrorInvalidValue;
    case COMBINE:
      return residual ? launch<T, COMBINE, true, CO>(p, st) : cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_co(int c_out, int mode, int residual, const ConvArgs& p, cudaStream_t st) {
  switch (c_out) {
    case 16:
      return dispatch_mode<T, 16>(mode, residual, p, st);
    case 32:
      return dispatch_mode<T, 32>(mode, residual, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t stats_finish(const float* part, int nslots, int nk, int B, int co, int tiles_per_b,
                         int ntiles, float* s, float* ss, float* rs, float* rss,
                         cudaStream_t stream) {
  if (nk * B * co == 0) return cudaSuccess;
  stats_finish_kernel<<<nk * B * co, FINISH_THREADS, 0, stream>>>(part, nslots, B, co,
                                                                  tiles_per_b, ntiles, s, ss, rs,
                                                                  rss);
  return cudaGetLastError();
}

}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the kernels were launched (the conv,
// then the statistics' finish). ``part``: room for [2 or 4][B][c_out]
// [slots] fp32 partial sums, slots at least the conv's blocks per batch
// element (ceil(W/16) * ceil(H/16) * ceil(D/2)).
int medseg_conv3x3x3(int device, int bf16, int mode, int residual, int c_out, const void* x0,
                     const void* x1, const void* x2, const float* a0, const float* b0,
                     const float* a1, const float* b1, const void* w, const void* wres, void* out,
                     float* s, float* ss, void* res, float* rs, float* rss, float* part,
                     int slots, int B, int C, int Ch, int Cx, int D, int H, int W, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const medseg::ConvArgs p{x0, x1, x2, a0, b0, a1, b1, w,  wres, out, s, ss, res, rs, rss,
                           B,  C,  Ch, Cx, D,  H,  W, part, slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::dispatch_co<__nv_bfloat16>(c_out, mode, residual, p, st)
           : medseg::dispatch_co<float>(c_out, mode, residual, p, st);
  return (int)e;
}

const char* medseg_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
