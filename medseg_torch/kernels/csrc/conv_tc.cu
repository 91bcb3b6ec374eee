// Fused 3x3x3 same-pad convolution on the tensor cores: bf16 operands, fp32
// sums, an input mode, an optional residual 1x1x1 tap, and per-(b, c_out)
// sum and sum of squares of the fp32 results. NCDHW activations; weights
// packed by the wrapper (``conv_of.pack_tc_weight``): (C/16, 27, CO, 16) and
// (C/16, CO, 16) bf16.
//
// Replaces three TPU kernels of medseg/kernels/conv_of.py, one input mode
// each (channel ci of the conv input, before the zero padding):
//   - conv3x3x3_of (_kernel), K1:          PLAIN    x[ci]
//                                          AFFINE   leaky(a*x + b)[ci]
//     for C_in % 16 == 0 (C_in <= 64), C_out 16, 32 or 64;
//   - conv3x3x3_of_cat2 (_cat2_kernel), K5: CAT2     [xa ; xb][ci]
//   - conv3x3x3_of_combine (_combine_kernel), K2:
//                                  COMBINE  [up ; leaky(ay*y + by + ax*x + bx)][ci]
//     both with the residual tap, for C/2 % 16 == 0 (C <= 64), C_out = C/2
//     of the decoder (K5: 32; K2: 16 or 32), x of 1 channel (broadcast) or
//     C/2.
// The other calls (fp32, C_in of 1 or 4, K5 at C = 128) keep the CUDA-core
// kernel of conv_of.cu, picked by the wrapper's shape and dtype predicate.
//
// What bounds it on the H100: bytes and operations are close. A 16->16 conv
// at 4x96^3 is 49 GFLOP (0.050 ms at 989 TFLOP/s) against 0.23 GB of bf16
// activations (0.068 ms at 3.35 TB/s); the CUDA-core kernel ran it at 27
// TFLOP/s in fp32 FMA. The design is an implicit GEMM: output voxels x
// C_out is M x N, the reduction runs over 27 taps x C_in in 16-channel
// slices, one mma.sync m16n8k16 k-step per tap and slice.
//   - A tile is 2x8x16 (z, y, x) output voxels: 16 x-rows of 16 voxels, two
//     m16 rows per warp (8 warps), all C_out columns per warp.
//   - Blocks are persistent: as many as fit the SMs, each walking tiles
//     blockIdx.x, + gridDim.x, ... slice by slice. A step is one (tile,
//     slice): its 4x10x18 input halo is staged channels-last in bf16
//     (tc_common.cuh's BoxStage: the prologue and the bf16 rounding applied
//     once per staged value, taps outside the volume 0 in the transformed
//     space), so a tap's A operand is the same ldmatrix at a whole-row
//     offset. The next step's global loads are issued into registers before
//     this step's MMAs and stored after them into the other of two halo
//     buffers (software pipelining: the prologue needs the values in
//     registers, so cp.async cannot carry the input).
//   - The packed weights (27 x CO rows of 32 B per slice) arrive by
//     cp.async: all slices once per block where they fit in shared memory
//     (every conv of the main paths), else one slice per step into two
//     buffers, beside the halo's.
//   - CAT2 and COMBINE read their slices from two streams: slice s of C/16
//     comes from the first (xa, up) for s < C/32 and from the second (xb,
//     y) at channel 16 s - C/2 for the rest, a base pointer per step (the
//     stream boundary falls on a slice boundary, so no step straddles it).
//     COMBINE's y slices also load the matching 8 channels of x per item
//     (or its one channel, broadcast) and apply the prologue in fp32 in the
//     staging, rounding to bf16 once, as AFFINE's does. x's width is a
//     template argument (XS): a one-channel x then holds one register per
//     item between the loads and the store, not four.
//   - The residual tap is one extra k-step per slice on the centre tap's
//     A fragments, into accumulators of its own.
//   - Epilogue per tile: the output goes through shared memory (the halo
//     buffer just consumed, where it fits), so that the global stores are
//     contiguous 16-byte pieces of NCDHW x-rows. The fragments' sums and
//     sums of squares (ragged voxels masked) are reduced by shuffles within
//     the warp into per-warp slots in shared memory, and added into s / ss
//     with one atomicAdd per block, channel and batch element the block met:
//     per-tile atomics (13,824 tiles x 2 C_out at 4x96^3, all on B x C_out
//     addresses) serialise in L2 and cost more than the MMAs.
// Measured on the H100 (PERF.md): 11-25% of the bf16 peak; removing the MMAs
// changes little. The staging (the NCDHW -> channels-last transpose through
// registers) and the per-tile epilogue set the time, and stay unhidden where
// few tiles per SM leave one or two blocks on it (48^3 at C >= 32). wgmma
// (64-row warpgroup tiles) is for when the MMAs bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_common.cuh"

namespace medseg {
namespace {

using tc::BoxStage;
using tc::swz;

constexpr int TX = 16, TY = 8, TZ = 2;  // output tile
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int ROWS = TZ * TY;  // x-rows of 16 voxels: one m16 tile each
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int ROWS_PER_WARP = ROWS / NWARP;
constexpr int TILE = ROWS * TX;
constexpr int OUT_LD = TILE + 8;  // bf16 per channel row of the staged output tile

using Halo = BoxStage<HZ, HY, HX, 16, NT>;

enum Mode : int { PLAIN = 0, AFFINE = 1, CAT2 = 2, COMBINE = 3 };

struct TcConvArgs {
  const __nv_bfloat16* x;     // PLAIN, AFFINE: x (B, C, D, H, W); CAT2: xa; COMBINE: up
  const __nv_bfloat16* x1;    // CAT2: xb; COMBINE: y (B, C/2, D, H, W)
  const __nv_bfloat16* x2;    // COMBINE: x (B, Cx, D, H, W)
  const float* a;             // AFFINE: a (B, C); COMBINE: ay (B, C/2)
  const float* b;             // AFFINE: b; COMBINE: by
  const float* a1;            // COMBINE: ax (B, C/2)
  const float* b1;            // COMBINE: bx
  const __nv_bfloat16* w;     // (C/16, 27, CO, 16)
  const __nv_bfloat16* wres;  // (C/16, CO, 16) or null
  __nv_bfloat16* out;         // (B, CO, D, H, W)
  float* s;                   // (B, CO), zeroed by the caller
  float* ss;
  __nv_bfloat16* res;
  float* rs;
  float* rss;
  int B, C, Cx, D, H, W;      // Cx: COMBINE's x channels, 1 or C/2
  int ntx, nty, ntz, ntiles;  // tiles along x, y, z; in all
  int resident;               // 1: every slice's weights in shared memory
};

// Shared-memory layout (byte offsets; a struct, so that device code can read
// it): two halo buffers, the staged output tile where it does not fit in the
// halo buffer just consumed (C_out = 64), the per-warp statistics slots
// ([out, res][sum, sq][warp][co]), then the weights: per slice the 27 taps'
// CO rows and the residual tap's, all slices or two buffers.
template <bool RES, int CO>
struct Smem {
  static constexpr bool OUT_IN_HALO = CO * OUT_LD * 2 <= Halo::BYTES;
  static constexpr int OUT = 2 * Halo::BYTES;
  static constexpr int STAT = OUT + (OUT_IN_HALO ? 0 : CO * OUT_LD * 2);
  static constexpr int STAT_FLOATS = (RES ? 2 : 1) * 2 * NWARP * CO;
  static constexpr int W = STAT + STAT_FLOATS * 4;
  static constexpr int RES_ROWS = 27 * CO * 32;  // the residual tap's rows within a slice
  static constexpr int W_SLICE = RES_ROWS + (RES ? CO * 32 : 0);
};

struct Tile {
  int b, z0, y0, x0;
};

__device__ __forceinline__ Tile tile_at(const TcConvArgs& p, int t) {
  Tile r;
  r.x0 = (t % p.ntx) * TX;
  t /= p.ntx;
  r.y0 = (t % p.nty) * TY;
  t /= p.nty;
  r.z0 = (t % p.ntz) * TZ;
  r.b = t / p.ntz;
  return r;
}

// One tile's epilogue for one output (the conv, or the residual tap):
// ``acc`` (fragment layout) -> s_out -> ``out``; the tile's per-channel sums
// (voxels inside the volume only) added into this warp's slots of ``stat``
// ([sum, sq][warp][co]), which with ``flush`` are added into s / ss and
// zeroed. Begins and ends with a barrier's worth of ordering: the caller
// has synchronised since s_out was last read.
template <int CO>
__device__ __forceinline__ void finish_output(const float (&acc)[ROWS_PER_WARP][CO / 8][4],
                                              __nv_bfloat16* s_out, float* stat,
                                              __nv_bfloat16* out, float* s, float* ss,
                                              const TcConvArgs& p, const Tile& t, bool flush) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool ok[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const bool row_ok = t.z0 + r / TY < p.D && t.y0 + r % TY < p.H;
#pragma unroll
    for (int h = 0; h < 2; ++h) ok[i][h] = row_ok && t.x0 + (lane >> 2) + 8 * h < p.W;
  }
  // fragment (i, j, 2h + e): voxel (lane >> 2) + 8h of row i, channel
  // 8j + 2 (lane & 3) + e
#pragma unroll
  for (int j = 0; j < CO / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = 8 * j + 2 * (lane & 3) + e;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int r = warp * ROWS_PER_WARP + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = acc[i][j][2 * h + e];
          s_out[co * OUT_LD + r * TX + (lane >> 2) + 8 * h] = __float2bfloat16(v);
          if (ok[i][h]) {
            sum += v;
            sq += v * v;
          }
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {  // lanes of the same lane & 3 hold the same channel
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (lane < 4) {  // this warp's slots: no other thread writes them
        stat[warp * CO + co] += sum;
        stat[(NWARP + warp) * CO + co] += sq;
      }
    }
  }
  __syncthreads();
  // 16-byte pieces (half an x-row of one channel), halves fastest
  const long long HW = (long long)p.H * p.W;
  const bool vec = p.W % 8 == 0;
  for (int u = threadIdx.x; u < CO * ROWS * 2; u += NT) {
    const int co = u / (ROWS * 2), rem = u - co * (ROWS * 2);
    const int r = rem >> 1, h = rem & 1;
    const int z = t.z0 + r / TY, y = t.y0 + r % TY, x = t.x0 + 8 * h;
    if (z >= p.D || y >= p.H || x >= p.W) continue;
    const __nv_bfloat16* src = s_out + co * OUT_LD + r * TX + 8 * h;
    __nv_bfloat16* dst = out + ((long long)(t.b * CO + co) * p.D + z) * HW + (long long)y * p.W + x;
    if (vec && x + 8 <= p.W) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int k = 0; k < 8 && x + k < p.W; ++k) dst[k] = src[k];
    }
  }
  if (flush && threadIdx.x < CO) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      sum += stat[w * CO + threadIdx.x];
      sq += stat[(NWARP + w) * CO + threadIdx.x];
      stat[w * CO + threadIdx.x] = 0.f;
      stat[(NWARP + w) * CO + threadIdx.x] = 0.f;
    }
    atomicAdd(&s[t.b * CO + threadIdx.x], sum);
    atomicAdd(&ss[t.b * CO + threadIdx.x], sq);
  }
}

// XS: COMBINE's x per staged item, 1 (its one channel, broadcast) or 8 (the
// same 8 channels); 0 in the other modes.
template <int MODE, bool RES, int CO, int XS>
__global__ void __launch_bounds__(NT, CO == 64 ? 1 : 2) conv_tc_kernel(TcConvArgs p) {
  static_assert((MODE == COMBINE) == (XS != 0), "an x stream in COMBINE only");
  using L = Smem<RES, CO>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_stat = reinterpret_cast<float*>(smem + L::STAT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = p.C / 16;
  const long long V = (long long)p.D * p.H * p.W;

  for (int i = threadIdx.x; i < L::STAT_FLOATS; i += NT) s_stat[i] = 0.f;

  auto issue_weights = [&](int s, int slot) {  // cp.async of slice s's packed weights
    const uint32_t base = tc::smem_u32(smem + L::W + slot * L::W_SLICE);
    const __nv_bfloat16* w = p.w + (long long)s * 27 * CO * 16;
    for (int q = threadIdx.x; q < 27 * CO * 2; q += NT)
      tc::cp_async16(base + swz<32>(q >> 1, q & 1), w + q * 8);
    if constexpr (RES) {
      const __nv_bfloat16* wr = p.wres + (long long)s * CO * 16;
      for (int q = threadIdx.x; q < CO * 2; q += NT)
        tc::cp_async16(base + L::RES_ROWS + swz<32>(q >> 1, q & 1), wr + q * 8);
    }
    tc::cp_async_commit();
  };
  Halo halo;
  constexpr bool TWO = MODE == CAT2 || MODE == COMBINE;  // two streams of C/2 channels
  const int ch = TWO ? p.C / 2 : p.C;  // channels of a stream
  // slice s: its stream (the second from s = ns / 2 on) and its channel there
  auto second = [&](int s) { return TWO && 2 * s >= ns; };
  auto chan = [&](int s) { return 16 * s - (second(s) ? ch : 0); };
  auto load_halo = [&](const Tile& t, int s) {
    const __nv_bfloat16* xk = (second(s) ? p.x1 : p.x) + ((long long)t.b * ch + chan(s)) * V;
    if constexpr (MODE == COMBINE) {
      if (second(s)) {  // y, with x's values at the same items
        const __nv_bfloat16* xs = p.x2 + ((long long)t.b * p.Cx + (XS == 1 ? 0 : chan(s))) * V;
        halo.load<XS>(xk, V, p.D, p.H, p.W, t.z0 - 1, t.y0 - 1, t.x0 - 1, xs);
        return;
      }
    }
    halo.load(xk, V, p.D, p.H, p.W, t.z0 - 1, t.y0 - 1, t.x0 - 1);
  };
  auto store_halo = [&](const Tile& t, int s, int buf) {
    unsigned char* dst = smem + buf * Halo::BYTES;
    const int k = t.b * ch + chan(s);
    if constexpr (MODE == COMBINE) {
      if (second(s)) {
        halo.store_combine<XS>(dst, p.a + k, p.b + k, p.a1 + k, p.b1 + k);
        return;
      }
    }
    halo.store<MODE == AFFINE>(dst, p.a + k, p.b + k);
  };

  float acc[ROWS_PER_WARP][CO / 8][4];
  float racc[ROWS_PER_WARP][RES ? CO / 8 : 1][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
      for (int j = 0; j < CO / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < (RES ? CO / 8 : 1); ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) racc[i][j][e] = 0.f;
    }
  };
  // halo voxel of tap (0, 0, 0) of each of this lane's A rows
  int vrow[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    vrow[i] = ((r / TY) * HY + r % TY) * HX + (lane & 15);
  }
  const int a_chunk = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);  // channel within a 16-channel n pair
  const int b_chunk = (lane >> 3) & 1;

  int tile = blockIdx.x, s = 0, buf = 0;  // the current step and its halo buffer
  Tile cur = tile_at(p, tile);
  if (p.resident) {
    for (int i = 0; i < ns; ++i) issue_weights(i, i);
  } else {
    issue_weights(0, 0);
  }
  load_halo(cur, 0);
  store_halo(cur, 0, 0);
  zero_acc();
  tc::cp_async_wait_all();
  __syncthreads();

  for (;;) {
    int next = tile, ns_next = s + 1;
    if (ns_next == ns) {
      ns_next = 0;
      next = tile + gridDim.x;
    }
    const bool has_next = next < p.ntiles;
    const Tile nt = has_next ? tile_at(p, next) : cur;
    if (has_next) {
      load_halo(nt, ns_next);
      if (!p.resident) issue_weights(ns_next, buf ^ 1);
    }
    const uint32_t in_base = tc::smem_u32(smem + buf * Halo::BYTES);
    const uint32_t w_base = tc::smem_u32(smem + L::W + (p.resident ? s : buf) * L::W_SLICE);
#pragma unroll
    for (int t = 0; t < 27; ++t) {
      const int off = ((t / 9) * HY + (t / 3) % 3) * HX + t % 3;
      uint32_t a[ROWS_PER_WARP][4];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
        tc::ldsm_x4(in_base + swz<32>(vrow[i] + off, a_chunk), a[i]);
#pragma unroll
      for (int q = 0; q < CO / 16; ++q) {
        uint32_t bf[4];
        tc::ldsm_x4(w_base + swz<32>(t * CO + 16 * q + b_row, b_chunk), bf);
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          tc::mma_bf16(acc[i][2 * q], a[i], bf[0], bf[1]);
          tc::mma_bf16(acc[i][2 * q + 1], a[i], bf[2], bf[3]);
        }
      }
      if constexpr (RES) {
        if (t == 13) {  // the centre tap: the 1x1x1 conv on the same staged input
#pragma unroll
          for (int q = 0; q < CO / 16; ++q) {
            uint32_t bf[4];
            tc::ldsm_x4(w_base + L::RES_ROWS + swz<32>(16 * q + b_row, b_chunk), bf);
#pragma unroll
            for (int i = 0; i < ROWS_PER_WARP; ++i) {
              tc::mma_bf16(racc[i][2 * q], a[i], bf[0], bf[1]);
              tc::mma_bf16(racc[i][2 * q + 1], a[i], bf[2], bf[3]);
            }
          }
        }
      }
    }
    if (s == ns - 1) {  // the tile is complete; the statistics leave at the last of its b
      const bool flush = !has_next || nt.b != cur.b;
      __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(
          smem + (L::OUT_IN_HALO ? buf * Halo::BYTES : L::OUT));
      if constexpr (L::OUT_IN_HALO) __syncthreads();  // every warp is done with this halo
      finish_output<CO>(acc, s_out, s_stat, p.out, p.s, p.ss, p, cur, flush);
      if constexpr (RES) {
        __syncthreads();  // s_out is reused
        finish_output<CO>(racc, s_out, s_stat + 2 * NWARP * CO, p.res, p.rs, p.rss, p, cur,
                          flush);
      }
      zero_acc();
    }
    if (!has_next) break;
    store_halo(nt, ns_next, buf ^ 1);
    tc::cp_async_wait_all();
    __syncthreads();
    tile = next;
    s = ns_next;
    cur = nt;
    buf ^= 1;
  }
}

template <int MODE, bool RES, int CO, int XS = 0>
cudaError_t launch(TcConvArgs p, int device, cudaStream_t stream) {
  using L = Smem<RES, CO>;
  const int ns = p.C / 16;
  int optin = 0, sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  p.resident = L::W + ns * L::W_SLICE <= optin;
  const int smem = L::W + (p.resident ? ns : 2) * L::W_SLICE;
  e = cudaFuncSetAttribute(conv_tc_kernel<MODE, RES, CO, XS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_tc_kernel<MODE, RES, CO, XS>,
                                                    NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p.ntx = (p.W + TX - 1) / TX;
  p.nty = (p.H + TY - 1) / TY;
  p.ntz = (p.D + TZ - 1) / TZ;
  const long long ntiles = (long long)p.B * p.ntz * p.nty * p.ntx;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  if (p.ntiles == 0) return cudaSuccess;
  const int grid = p.ntiles < per_sm * sms ? p.ntiles : per_sm * sms;
  conv_tc_kernel<MODE, RES, CO, XS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int CO>
cudaError_t dispatch_mode(int mode, int residual, const TcConvArgs& p, int device,
                          cudaStream_t st) {
  switch (mode) {
    case PLAIN:
      return residual ? launch<PLAIN, true, CO>(p, device, st)
                      : launch<PLAIN, false, CO>(p, device, st);
    case AFFINE:
      return residual ? launch<AFFINE, true, CO>(p, device, st)
                      : launch<AFFINE, false, CO>(p, device, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// CAT2 and COMBINE, with the residual tap, only at the output widths their
// routes send (conv_of.TC_MODE_C_OUT), COMBINE for either width of x: each
// unrolled instantiation adds to the build time.
cudaError_t dispatch_two(int mode, int c_out, const TcConvArgs& p, int device, cudaStream_t st) {
  const bool one = p.Cx == 1;
  if (mode == CAT2 && c_out == 32) return launch<CAT2, true, 32>(p, device, st);
  if (mode == COMBINE && c_out == 16)
    return one ? launch<COMBINE, true, 16, 1>(p, device, st)
               : launch<COMBINE, true, 16, 8>(p, device, st);
  if (mode == COMBINE && c_out == 32)
    return one ? launch<COMBINE, true, 32, 1>(p, device, st)
               : launch<COMBINE, true, 32, 8>(p, device, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the kernel was launched. mode 0:
// PLAIN, 1: AFFINE (x0, a0, b0), C a multiple of 16 up to 64, c_out 16, 32
// or 64; 2: CAT2 (x0, x1), 3: COMBINE (x0, x1, x2, a0, b0, a1, b1; Cx 1 or
// C/2), both with the residual tap, C 32 or 64, c_out as dispatch_two.
int medseg_conv_tc(int device, int mode, int residual, int c_out, const void* x0, const void* x1,
                   const void* x2, const float* a0, const float* b0, const float* a1,
                   const float* b1, const void* w, const void* wres, void* out, float* s,
                   float* ss, void* res, float* rs, float* rss, int B, int C, int Cx, int D,
                   int H, int W, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (C < 16 || C > 64 || C % 16 != 0) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const medseg::TcConvArgs p{static_cast<const bf*>(x0), static_cast<const bf*>(x1),
                             static_cast<const bf*>(x2), a0, b0, a1, b1,
                             static_cast<const bf*>(w), static_cast<const bf*>(wres),
                             static_cast<bf*>(out), s, ss, static_cast<bf*>(res), rs, rss,
                             B, C, Cx, D, H, W, 0, 0, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == medseg::CAT2 || mode == medseg::COMBINE) {
    if (!residual || C % 32 != 0 || (mode == medseg::COMBINE && Cx != 1 && Cx != C / 2))
      return (int)cudaErrorInvalidValue;
    return (int)medseg::dispatch_two(mode, c_out, p, device, st);
  }
  switch (c_out) {
    case 16:
      return (int)medseg::dispatch_mode<16>(mode, residual, p, device, st);
    case 32:
      return (int)medseg::dispatch_mode<32>(mode, residual, p, device, st);
    case 64:
      return (int)medseg::dispatch_mode<64>(mode, residual, p, device, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
