// Fused 3x3x3 same-pad convolution on the tensor cores: bf16 operands, fp32
// sums, an input mode, an optional residual 1x1x1 tap, and per-(b, c_out)
// sum and sum of squares of the fp32 results (or, mode FLAT, a plain fp32
// output). NCDHW activations; weights packed by the wrapper
// (``conv_of.pack_tc_weight``): (C/16, 27, CO, 16) and (C/16, CO, 16) bf16.
//
// Replaces four TPU kernels, one input mode each (channel ci of the conv
// input, before the zero padding):
//   - medseg/kernels/conv_of.py conv3x3x3_of (_kernel), K1:
//                                          PLAIN    x[ci]
//                                          AFFINE   leaky(a*x + b)[ci]
//     for C_in % 16 == 0 (C_in <= 64), C_out 16, 32 or 64;
//   - conv_of.py conv3x3x3_of_cat2 (_cat2_kernel), K5:
//                                          CAT2     [xa ; xb][ci]
//     with the residual tap, C/2 % 16 == 0 (C <= 128), C_out 32 or 64;
//   - conv_of.py conv3x3x3_of_combine (_combine_kernel), K2:
//                                  COMBINE  [up ; leaky(ay*y + by + ax*x + bx)][ci]
//     with the residual tap, C/2 % 16 == 0 (C <= 64), C_out 16 or 32, x of
//     1 channel (broadcast) or C/2;
//   - medseg/kernels/conv3d.py conv3x3x3_flat (_kernel), K9:
//                                          FLAT     x[ci], fp32 out, no
//     statistics, for C % 16 == 0 (C <= 128), C_out 16, 32 or 64.
// bf16 at C_in <= 8 without a prologue takes conv_narrow_tc.cu; the other
// calls (fp32, other widths) keep the CUDA-core kernels of conv_of.cu and
// conv_flat.cu, picked by the wrapper's shape and dtype predicates
// (``conv_of.tc_route``, ``narrow_tc_route``).
//
// What bounds it on the H100: operations, and the staging that feeds them.
// A 16->16 conv at 4x96^3 is 49 GFLOP (0.050 ms at 989 TFLOP/s) against
// 0.23 GB of bf16 activations (0.068 ms at 3.35 TB/s); K9's 128->64 at
// 4x48^3 is 196 GFLOP (0.198 ms) against 0.11 GB. The design is an implicit
// GEMM: output voxels x C_out is M x N, the reduction runs over 27 taps x C
// in 16-channel slices, one mma.sync m16n8k16 k-step per tap and slice.
//   - A tile is 2x8x16 (z, y, x) output voxels: 16 x-rows of 16 voxels, two
//     m16 rows per warp of a group of 8 warps, all C_out columns per warp.
//   - Blocks are persistent: as many as fit the SMs, each group walking its
//     tiles slice by slice. A step is one (tile, slice): its 4x10x18 input
//     halo is staged channels-last in bf16 (taps outside the volume 0 in
//     the transformed space), so a tap's A operand is the same ldmatrix at a
//     whole-row offset (``mma_step``, the one mainloop of both stagings).
//   - Register staging (PLAIN, AFFINE, COMBINE; CAT2 and FLAT where W % 8 !=
//     0), ``conv_tc_kernel``: the next step's global loads are issued into
//     registers before this step's MMAs and stored, through the prologue,
//     after them into the other of two halo buffers (tc_common.cuh's
//     BoxStage). The prologue needs the values in registers.
//   - Asynchronous staging (CAT2 and FLAT, which have no prologue, where W
//     % 8 == 0), ``conv_tc_async_kernel``: the group copies the step's box
//     (16 channels x z 4 x y 10 of 48-byte rows: the x-row's 16 voxels as two
//     16-byte pieces, the halo's x0 - 1 and x0 + 16 as 4-byte pairs) by
//     cp.async with zero fill, R steps ahead, into a ring of stages (one
//     commit group per step); the zero fill outside the volume is the conv's
//     zero padding. W % 8 == 0 keeps every 16-byte piece aligned and wholly
//     inside or outside the volume. The group transposes the channel-major
//     box into the swizzled channels-last rows in one shared-to-shared pass
//     (``box_to_rows``), so nothing staged stays in registers across the
//     MMAs. TMA would need the box's x start at a multiple of 16 bytes (x0 -
//     1 faults on the H100: PERF.md), a 32-voxel box of 40,960 B that leaves
//     no room for two groups. Where the weights sit in shared memory once
//     for several groups (C_out <= 32), a block runs two groups of 8 warps,
//     each on its own tiles with its own named barrier: one group's staging
//     overlaps the other's MMAs.
//   - The packed weights (27 x CO rows of 32 B per slice) arrive by
//     cp.async: all slices once per block where they fit in shared memory,
//     else one slice per step into two buffers (per group), a step ahead.
//   - CAT2 and COMBINE read their slices from two streams: slice s of C/16
//     comes from the first (xa, up) for s < C/32 and from the second (xb,
//     y) at channel 16 s - C/2 for the rest (a base pointer, or a tensor
//     map, per step). COMBINE's y slices also load the matching 8 channels
//     of x per item (or its one channel, template XS) and apply the prologue
//     in fp32 in the staging, rounding to bf16 once, as AFFINE's does.
//   - The residual tap is one extra k-step per slice on the centre tap's
//     A fragments, into accumulators of its own.
//   - Epilogue per tile, modes with statistics: the output goes through
//     shared memory (a buffer just consumed, 32 channels at a time where the
//     tile is wider than it), so that the global stores are contiguous
//     16-byte pieces of NCDHW x-rows; the fragments' sums and sums of
//     squares (ragged voxels masked) are reduced by shuffles into per-warp
//     slots in shared memory. After the group's last tile of a batch
//     element (its tiles only ever move to later ones; the register-staged
//     kernel waits until the next halo has left the registers) the warps'
//     slots are added in order into the group's own slot of the partial
//     sums in global memory (a group whose tiles skip a batch element
//     leaves its slot unwritten, and the finish skips it); ``stats_finish`` (common.cuh)
//     then adds the groups' slots in a fixed order, one block per (sum,
//     b, c), so the statistics are the same bits on every call (atomics
//     added them in the order the groups finished). FLAT writes its fp32
//     output from the fragments: 8 lanes cover 32 contiguous bytes of an
//     x-row per channel.
// Measured on the H100: PERF.md section 6 (times, spills, occupancy).

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
constexpr int NT = 256;        // threads of a group
constexpr int NWARP = NT / 32;
constexpr int ROWS_PER_WARP = ROWS / NWARP;
constexpr int TILE = ROWS * TX;
constexpr int OUT_LD = TILE + 8;  // bf16 per channel row of the staged output tile
// The asynchronous staging's box: per (channel, z, y) row of the 4x10x18
// halo BOX_PITCH bf16, [12 B unused][x0 - 2, x0 - 1][x0 .. x0 + 15], then x0 +
// 16, x0 + 17 in the next row's unused bytes: halo voxel vx (x = x0 - 1 +
// vx) at element BOX_OFF + vx of its row.
constexpr int BOX_PITCH = 24, BOX_OFF = 7;
constexpr int BOX_ROWS = 16 * HZ * HY;
constexpr int BOX_BYTES = (BOX_ROWS * BOX_PITCH * 2 + 16 + 127) / 128 * 128;
constexpr int ASYNC_W_ALIGN = 8;  // W % 8 == 0: aligned 16-byte pieces

using Halo = BoxStage<HZ, HY, HX, 16, NT>;

enum Mode : int { PLAIN = 0, AFFINE = 1, CAT2 = 2, COMBINE = 3, FLAT = 4 };
enum Staging : int { REGISTERS = 0, ASYNC = 1 };

struct TcConvArgs {
  const __nv_bfloat16* x;     // PLAIN, AFFINE, FLAT: x (B, C, D, H, W); CAT2: xa; COMBINE: up
  const __nv_bfloat16* x1;    // CAT2: xb; COMBINE: y (B, C/2, D, H, W)
  const __nv_bfloat16* x2;    // COMBINE: x (B, Cx, D, H, W)
  const float* a;             // AFFINE: a (B, C); COMBINE: ay (B, C/2)
  const float* b;             // AFFINE: b; COMBINE: by
  const float* a1;            // COMBINE: ax (B, C/2)
  const float* b1;            // COMBINE: bx
  const __nv_bfloat16* w;     // (C/16, 27, CO, 16)
  const __nv_bfloat16* wres;  // (C/16, CO, 16) or null
  void* out;                  // (B, CO, D, H, W): bf16, FLAT fp32
  float* s;                   // (B, CO), written by stats_finish
  float* ss;
  __nv_bfloat16* res;
  float* rs;
  float* rss;
  int B, C, Cx, D, H, W;      // Cx: COMBINE's x channels, 1 or C/2
  int ntx, nty, ntz, ntiles;  // tiles along x, y, z; in all
  int resident;               // 1: every slice's weights in shared memory
  // last, so that the fields above keep their offsets: inserted after rss,
  // the two shift the ints and the COMBINE kernels spill (ptxas: 0 -> 168 B
  // at C_out 16 with a 1-channel x; PERF.md section 6)
  float* part;                // the groups' partial sums: [2 or 4][B][CO][nslots]
  int nslots;                 // groups in the launch (the caller's room, until launch)
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

// The weights of one slice in shared memory: 27 taps' CO rows of 32 B, then
// the residual tap's CO rows.
template <bool RES, int CO>
struct WSlice {
  static constexpr int RES_ROWS = 27 * CO * 32;
  static constexpr int BYTES = RES_ROWS + (RES ? CO * 32 : 0);
};

// cp.async of slice s's packed weights into ``base`` (swizzled rows), by
// threads t0, t0 + nthr, ...; one commit group.
template <bool RES, int CO>
__device__ __forceinline__ void issue_weights(const TcConvArgs& p, int s, uint32_t base, int t0,
                                              int nthr) {
  const __nv_bfloat16* w = p.w + (long long)s * 27 * CO * 16;
  for (int q = t0; q < 27 * CO * 2; q += nthr)
    tc::cp_async16(base + swz<32>(q >> 1, q & 1), w + q * 8);
  if constexpr (RES) {
    const __nv_bfloat16* wr = p.wres + (long long)s * CO * 16;
    for (int q = t0; q < CO * 2; q += nthr)
      tc::cp_async16(base + WSlice<RES, CO>::RES_ROWS + swz<32>(q >> 1, q & 1), wr + q * 8);
  }
  tc::cp_async_commit();
}

// One step's MMAs: the 27 taps of a staged slice (``in_base``, channels-last
// rows) against its weights (``w_base``), and the residual tap on the
// centre tap's A fragments. ``vrow``: the halo row of tap (0, 0, 0) of each
// of this lane's A rows.
template <bool RES, int CO>
__device__ __forceinline__ void mma_step(uint32_t in_base, uint32_t w_base,
                                         const int (&vrow)[ROWS_PER_WARP], int lane,
                                         float (&acc)[ROWS_PER_WARP][CO / 8][4],
                                         float (&racc)[ROWS_PER_WARP][RES ? CO / 8 : 1][4]) {
  const int a_chunk = lane >> 4;
  const int b_row = ((lane >> 4) << 3) + (lane & 7);  // channel within a 16-channel n pair
  const int b_chunk = (lane >> 3) & 1;
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
          tc::ldsm_x4(w_base + WSlice<RES, CO>::RES_ROWS + swz<32>(16 * q + b_row, b_chunk), bf);
#pragma unroll
          for (int i = 0; i < ROWS_PER_WARP; ++i) {
            tc::mma_bf16(racc[i][2 * q], a[i], bf[0], bf[1]);
            tc::mma_bf16(racc[i][2 * q + 1], a[i], bf[2], bf[3]);
          }
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[ROWS_PER_WARP][N][4]) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// One tile's epilogue for one output (the conv, or the residual tap):
// ``acc`` (fragment layout) -> s_out -> ``out``, OUT_CH channels at a time;
// the tile's per-channel sums (voxels inside the volume only) added into
// this warp's slots of ``stat`` ([sum, sq][warp][co]), visible to the group
// at the return. ``tid``: the thread within its group of NT; ``sync``: the
// group's barrier. The caller has synchronised since s_out was last read;
// s_out is read until the return.
template <int CO, int OUT_CH, class Sync>
__device__ __forceinline__ void finish_output(const float (&acc)[ROWS_PER_WARP][CO / 8][4],
                                              __nv_bfloat16* s_out, float* stat,
                                              __nv_bfloat16* out, const TcConvArgs& p,
                                              const Tile& t, int tid, Sync sync) {
  static_assert(CO % OUT_CH == 0 && OUT_CH % 8 == 0, "whole passes of 8-channel groups");
  const int lane = tid & 31, warp = tid >> 5;
  bool ok[ROWS_PER_WARP][2];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const bool row_ok = t.z0 + r / TY < p.D && t.y0 + r % TY < p.H;
#pragma unroll
    for (int h = 0; h < 2; ++h) ok[i][h] = row_ok && t.x0 + (lane >> 2) + 8 * h < p.W;
  }
  const long long HW = (long long)p.H * p.W;
  const bool vec = p.W % 8 == 0;
#pragma unroll
  for (int pass = 0; pass < CO / OUT_CH; ++pass) {
    const int c0 = pass * OUT_CH;
    if (pass > 0) sync();  // the previous pass's s_out is read
    // fragment (i, j, 2h + e): voxel (lane >> 2) + 8h of row i, channel
    // 8j + 2 (lane & 3) + e
#pragma unroll
    for (int jj = 0; jj < OUT_CH / 8; ++jj) {
      const int j = pass * (OUT_CH / 8) + jj;
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
            s_out[(co - c0) * OUT_LD + r * TX + (lane >> 2) + 8 * h] = __float2bfloat16(v);
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
    sync();
    // 16-byte pieces (half an x-row of one channel), halves fastest
    for (int u = tid; u < OUT_CH * ROWS * 2; u += NT) {
      const int cl = u / (ROWS * 2), rem = u - cl * (ROWS * 2);
      const int r = rem >> 1, h = rem & 1;
      const int z = t.z0 + r / TY, y = t.y0 + r % TY, x = t.x0 + 8 * h;
      if (z >= p.D || y >= p.H || x >= p.W) continue;
      const __nv_bfloat16* src = s_out + cl * OUT_LD + r * TX + 8 * h;
      __nv_bfloat16* dst =
          out + ((long long)(t.b * CO + c0 + cl) * p.D + z) * HW + (long long)y * p.W + x;
      if (vec && x + 8 <= p.W) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int k = 0; k < 8 && x + k < p.W; ++k) dst[k] = src[k];
      }
    }
  }
}

// The group's statistics of batch element ``b`` leave: per output (the
// conv's sums k = 0, 1 from ``stat``; with RES the residual tap's k = 2, 3
// from the next 2 x NWARP x CO floats) the warps' shared slots are added in
// warp order, stored into the group's ``slot`` of the partial sums and
// zeroed, by threads tid < CO. The caller synchronises the group before
// (the warps' last adds) and after (the next adds). The register-staged
// kernel calls it after the next step's halo has left the registers, so
// that its registers do not add to the epilogue's.
template <bool RES, int CO>
__device__ __forceinline__ void flush_stats(float* stat, int b, int slot, const TcConvArgs& p,
                                            int tid) {
  if (tid >= CO) return;
#pragma unroll
  for (int k0 = 0; k0 < (RES ? 4 : 2); k0 += 2) {
    float* st = stat + k0 * NWARP * CO;
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      sum += st[w * CO + tid];
      sq += st[(NWARP + w) * CO + tid];
      st[w * CO + tid] = 0.f;
      st[(NWARP + w) * CO + tid] = 0.f;
    }
    float* part = p.part + ((k0 * p.B + b) * CO + tid) * p.nslots + slot;
    part[0] = sum;
    part[p.B * CO * p.nslots] = sq;  // sum k0 + 1
  }
}

// FLAT's epilogue: the fp32 fragments straight to NCDHW (a warp's store
// covers 4 channels x 8 neighbouring voxels: 32-byte pieces of x-rows).
template <int CO>
__device__ __forceinline__ void store_f32(const float (&acc)[ROWS_PER_WARP][CO / 8][4],
                                          float* out, const TcConvArgs& p, const Tile& t,
                                          int warp, int lane) {
  const long long HW = (long long)p.H * p.W, V = HW * p.D;
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int z = t.z0 + r / TY, y = t.y0 + r % TY;
    if (z >= p.D || y >= p.H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = t.x0 + (lane >> 2) + 8 * h;
      if (x >= p.W) continue;
      float* o = out + (long long)t.b * CO * V + z * HW + (long long)y * p.W + x;
#pragma unroll
      for (int j = 0; j < CO / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) o[(8 * j + 2 * (lane & 3) + e) * V] = acc[i][j][2 * h + e];
    }
  }
}

// halo row of tap (0, 0, 0) of each of this lane's A rows
__device__ __forceinline__ void a_rows(int warp, int lane, int (&vrow)[ROWS_PER_WARP]) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    vrow[i] = ((r / TY) * HY + r % TY) * HX + (lane & 15);
  }
}

// ---------------------------------------------------------------------------
// register staging
// ---------------------------------------------------------------------------

// Shared-memory layout (byte offsets; a struct, so that device code can read
// it): two halo buffers, the staged output tile where it does not fit in the
// halo buffer just consumed (C_out = 64), the per-warp statistics slots
// ([out, res][sum, sq][warp][co]), then the weights: per slice the 27 taps'
// CO rows and the residual tap's, all slices or two buffers.
template <bool RES, int CO, bool STATS>
struct Smem {
  static constexpr bool OUT_IN_HALO = !STATS || CO * OUT_LD * 2 <= Halo::BYTES;
  static constexpr int OUT = 2 * Halo::BYTES;
  static constexpr int STAT = OUT + (OUT_IN_HALO ? 0 : CO * OUT_LD * 2);
  static constexpr int STAT_FLOATS = STATS ? (RES ? 2 : 1) * 2 * NWARP * CO : 0;
  static constexpr int W = STAT + STAT_FLOATS * 4;
  static constexpr int W_SLICE = WSlice<RES, CO>::BYTES;
};

// XS: COMBINE's x per staged item, 1 (its one channel, broadcast) or 8 (the
// same 8 channels); 0 in the other modes.
template <int MODE, bool RES, int CO, int XS>
__global__ void __launch_bounds__(NT, CO == 64 ? 1 : 2) conv_tc_kernel(TcConvArgs p) {
  static_assert((MODE == COMBINE) == (XS != 0), "an x stream in COMBINE only");
  constexpr bool STATS = MODE != FLAT;
  using L = Smem<RES, CO, STATS>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_stat = reinterpret_cast<float*>(smem + L::STAT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ns = p.C / 16;
  const long long V = (long long)p.D * p.H * p.W;

  for (int i = threadIdx.x; i < L::STAT_FLOATS; i += NT) s_stat[i] = 0.f;

  auto weights = [&](int s, int slot) {
    issue_weights<RES, CO>(p, s, tc::smem_u32(smem + L::W + slot * L::W_SLICE), threadIdx.x, NT);
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
  auto sync = []() { __syncthreads(); };

  float acc[ROWS_PER_WARP][CO / 8][4];
  float racc[ROWS_PER_WARP][RES ? CO / 8 : 1][4];
  int vrow[ROWS_PER_WARP];
  a_rows(warp, lane, vrow);

  int tile = blockIdx.x, s = 0, buf = 0;  // the current step and its halo buffer
  Tile cur = tile_at(p, tile);
  if (p.resident) {
    for (int i = 0; i < ns; ++i) weights(i, i);
  } else {
    weights(0, 0);
  }
  load_halo(cur, 0);
  store_halo(cur, 0, 0);
  zero(acc);
  zero(racc);
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
      if (!p.resident) weights(ns_next, buf ^ 1);
    }
    mma_step<RES, CO>(tc::smem_u32(smem + buf * Halo::BYTES),
                      tc::smem_u32(smem + L::W + (p.resident ? s : buf) * L::W_SLICE), vrow, lane,
                      acc, racc);
    if (s == ns - 1) {  // the tile is complete
      if constexpr (STATS) {  // the statistics leave after the last tile of its b
        __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(
            smem + (L::OUT_IN_HALO ? buf * Halo::BYTES : L::OUT));
        if constexpr (L::OUT_IN_HALO) __syncthreads();  // every warp is done with this halo
        finish_output<CO, CO>(acc, s_out, s_stat, static_cast<__nv_bfloat16*>(p.out), p, cur,
                              threadIdx.x, sync);
        if constexpr (RES) {
          __syncthreads();  // s_out is reused
          finish_output<CO, CO>(racc, s_out, s_stat + 2 * NWARP * CO, p.res, p, cur,
                                threadIdx.x, sync);
        }
        zero(racc);
      } else {
        store_f32<CO>(acc, static_cast<float*>(p.out), p, cur, warp, lane);
      }
      zero(acc);
    }
    if (!has_next) break;
    store_halo(nt, ns_next, buf ^ 1);
    tc::cp_async_wait_all();
    __syncthreads();
    if (STATS && ns_next == 0 && nt.b != cur.b) {  // cur was b's last tile; the next
      flush_stats<RES, CO>(s_stat, cur.b, blockIdx.x, p, threadIdx.x);  // halo is in smem
      __syncthreads();  // before the next tile's adds
    }
    tile = next;
    s = ns_next;
    cur = nt;
    buf ^= 1;
  }
  if (STATS) flush_stats<RES, CO>(s_stat, cur.b, blockIdx.x, p, threadIdx.x);  // the last tile
}

// A launch's plan, where the caller asks for it instead of the launch:
// blocks per SM, threads per block, shared memory per block, resident.
struct Plan {
  int per_sm, threads, smem, resident;
};

// Before a launch of ``groups`` tile groups in all: their slots of the
// partial sums (``p.nslots`` holds the caller's room until this check).
template <bool STATS>
cudaError_t set_slots(TcConvArgs& p, long long groups) {
  if (!STATS) return cudaSuccess;
  if (groups > p.nslots) return cudaErrorInvalidValue;
  p.nslots = (int)groups;
  return cudaSuccess;
}

// After the launch: the statistics' fixed-order finish (common.cuh).
template <bool STATS, bool RES, int CO>
cudaError_t finish_stats(const TcConvArgs& p, cudaStream_t stream) {
  if (!STATS) return cudaSuccess;
  // group g's tiles are g, g + nslots, ...: the finish reads slot g of b
  // only where one of them lies in b's ntz * nty * ntx tiles
  return stats_finish(p.part, p.nslots, RES ? 4 : 2, p.B, CO, p.ntz * p.nty * p.ntx, p.ntiles,
                      p.s, p.ss, p.rs, p.rss, stream);
}

template <int MODE, bool RES, int CO, int XS = 0>
cudaError_t launch(TcConvArgs p, int device, cudaStream_t stream, Plan* plan) {
  using L = Smem<RES, CO, MODE != FLAT>;
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
  if (plan != nullptr) {
    *plan = Plan{per_sm, NT, smem, p.resident};
    return cudaSuccess;
  }
  p.ntx = (p.W + TX - 1) / TX;
  p.nty = (p.H + TY - 1) / TY;
  p.ntz = (p.D + TZ - 1) / TZ;
  const long long ntiles = (long long)p.B * p.ntz * p.nty * p.ntx;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  if (p.ntiles == 0) return cudaSuccess;
  const int grid = p.ntiles < per_sm * sms ? p.ntiles : per_sm * sms;
  constexpr bool STATS = MODE != FLAT;
  e = set_slots<STATS>(p, grid);
  if (e != cudaSuccess) return e;
  conv_tc_kernel<MODE, RES, CO, XS><<<grid, NT, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish_stats<STATS, RES, CO>(p, stream);
}

// ---------------------------------------------------------------------------
// asynchronous staging (CAT2, FLAT; W % 8 == 0)
// ---------------------------------------------------------------------------

// Per instantiation: NG groups of NT threads per block (two where the
// weights of several slices fit once per block), R stages per group. Shared
// memory: per group [R stages][channels-last rows][statistics slots], then
// the weights (all slices, or two buffers per group).
template <int MODE, int CO>
struct Async {
  static constexpr bool RES = MODE == CAT2;
  static constexpr bool STATS = MODE == CAT2;
  static constexpr int NG = CO == 64 ? 1 : 2;
  static constexpr int R = NG == 1 ? 2 : 1;
  static constexpr int OUT_CH = CO < 32 ? CO : 32;  // output channels per staged pass
  static constexpr int STAT_FLOATS = STATS ? 2 * 2 * NWARP * CO : 0;
  static constexpr int CL = R * BOX_BYTES;  // a group's channels-last rows
  static constexpr int STAT = CL + Halo::BYTES;
  static constexpr int GROUP = STAT + STAT_FLOATS * 4;
  static constexpr int W = NG * GROUP;
  static constexpr int W_SLICE = WSlice<RES, CO>::BYTES;
  static_assert(GROUP % 128 == 0 && BOX_BYTES % 128 == 0, "128-byte aligned buffers");
  static_assert(OUT_CH * OUT_LD * 2 <= Halo::BYTES, "a pass of the output fits the rows");
};

// cp.async of the box of (tile t, the 16 channels of ``x``: a stream at the
// box's batch element and first channel) into the stage at ``dst``, by the
// group's NT threads: 4 pieces per row (the pair at x0 - 2, the two 16-byte
// halves of the x-row, the pair at x0 + 16), one kind per warp. ROLLED:
// the loop stays rolled where two groups cap the registers at 128 (its
// unrolled addresses spill beside the accumulators); one group unrolls it.
template <bool ROLLED>
__device__ __forceinline__ void issue_box(const __nv_bfloat16* x, const TcConvArgs& p,
                                          const Tile& t, uint32_t dst, int tid) {
  static_assert(4 * BOX_ROWS % NT == 0 && BOX_ROWS % 32 == 0, "whole warps per piece kind");
  const long long HW = (long long)p.H * p.W, V = HW * p.D;
  auto piece = [&](int j) {
    const int kind = j / BOX_ROWS, row = j - kind * BOX_ROWS;
    const int c = row / (HZ * HY), zy = row - c * (HZ * HY);
    const int z = t.z0 - 1 + zy / HY, y = t.y0 - 1 + zy % HY;
    const int xs = t.x0 + (kind == 0 ? -2 : (kind == 3 ? 16 : 8 * (kind - 1)));
    const bool in = z >= 0 && z < p.D && y >= 0 && y < p.H && xs >= 0 && xs < p.W;
    const __nv_bfloat16* src = in ? x + c * V + z * HW + (long long)y * p.W + xs : x;
    const uint32_t d = dst + row * BOX_PITCH * 2 + (kind == 0 ? 12 : 16 * kind);
    if (kind == 0 || kind == 3) {
      tc::cp_async4_zfill(d, src, in ? 4 : 0);
    } else {
      tc::cp_async16_zfill(d, src, in ? 16 : 0);
    }
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int k = 0; k < 4 * BOX_ROWS / NT; ++k) piece(tid + k * NT);
  } else {
#pragma unroll
    for (int k = 0; k < 4 * BOX_ROWS / NT; ++k) piece(tid + k * NT);
  }
}

template <int MODE, int CO>
__global__ void __launch_bounds__(Async<MODE, CO>::NG* NT, 1)
    conv_tc_async_kernel(TcConvArgs p) {
  using L = Async<MODE, CO>;
  constexpr bool RES = L::RES;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  const int g = threadIdx.x / NT, tid = threadIdx.x - g * NT;
  const int lane = tid & 31, warp = tid >> 5;
  unsigned char* gbase = smem + g * L::GROUP;
  unsigned char* rows = gbase + L::CL;
  float* s_stat = reinterpret_cast<float*>(gbase + L::STAT);
  const int ns = p.C / 16;
  const long long V = (long long)p.D * p.H * p.W;
  // this group's tiles: gid, gid + gstride, ...; step k = (tile k / ns, slice k % ns)
  const int gid = blockIdx.x * L::NG + g, gstride = gridDim.x * L::NG;
  const int nsteps = gid < p.ntiles ? (p.ntiles - gid + gstride - 1) / gstride * ns : 0;
  auto sync = [g]() { asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(NT) : "memory"); };
  auto wbuf = [&](int i) { return tc::smem_u32(smem + L::W + (2 * g + i) * L::W_SLICE); };
  auto box = [&](int k) {  // step k's box into stage k % R (the caller commits)
    const int s = k % ns;
    const Tile t = tile_at(p, gid + k / ns * gstride);
    const bool second = MODE == CAT2 && 2 * s >= ns;
    const int ch = MODE == CAT2 ? p.C / 2 : p.C;  // channels of a stream
    const __nv_bfloat16* x =
        (second ? p.x1 : p.x) + ((long long)t.b * ch + 16 * s - (second ? ch : 0)) * V;
    issue_box<L::NG == 2>(x, p, t, tc::smem_u32(gbase + (k % R) * BOX_BYTES), tid);
  };

  for (int i = tid; i < L::STAT_FLOATS; i += NT) s_stat[i] = 0.f;
  if (p.resident) {
    for (int i = 0; i < ns; ++i)
      issue_weights<RES, CO>(p, i, tc::smem_u32(smem + L::W + i * L::W_SLICE), threadIdx.x,
                             L::NG * NT);
  } else if (nsteps > 0) {
    issue_weights<RES, CO>(p, 0, wbuf(0), tid, NT);
  }
  for (int k = 0; k < R && k < nsteps; ++k) box(k);
  tc::cp_async_commit();
  tc::cp_async_wait_all();
  __syncthreads();  // the boxes of the first R steps and the weights of step 0 (all, where
                    // resident) have landed

  float acc[ROWS_PER_WARP][CO / 8][4];
  float racc[ROWS_PER_WARP][RES ? CO / 8 : 1][4];
  zero(acc);
  zero(racc);
  int vrow[ROWS_PER_WARP];
  a_rows(warp, lane, vrow);

  for (int k = 0; k < nsteps; ++k) {
    const int s = k % ns;
    // step k's box (committed R steps ago) and weights (a step ago, before
    // the box of step k + R - 1): the last group, step k + R - 1's box, may
    // still fly where R = 2
    tc::cp_async_wait<R - 1>();
    sync();  // every thread's copies have landed; the last step's MMAs are done
    tc::box_to_rows<HZ, HY, HX, BOX_PITCH, BOX_OFF, NT>(gbase + (k % R) * BOX_BYTES, rows, tid);
    sync();  // the rows are staged; stage k % R and the other weight buffer are free
    if (!p.resident && k + 1 < nsteps)
      issue_weights<RES, CO>(p, (k + 1) % ns, wbuf((k + 1) & 1), tid, NT);
    if (k + R < nsteps) box(k + R);
    tc::cp_async_commit();  // one group per step, empty at the end
    mma_step<RES, CO>(tc::smem_u32(rows),
                      p.resident ? tc::smem_u32(smem + L::W + s * L::W_SLICE) : wbuf(k & 1),
                      vrow, lane, acc, racc);
    if (s == ns - 1) {  // the tile is complete
      const Tile cur = tile_at(p, gid + k / ns * gstride);
      if constexpr (L::STATS) {  // the statistics leave at the last tile of its b
        __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(rows);
        sync();  // every warp is done with the rows
        finish_output<CO, L::OUT_CH>(acc, s_out, s_stat, static_cast<__nv_bfloat16*>(p.out), p,
                                     cur, tid, sync);
        if constexpr (RES) {
          sync();  // s_out is reused
          finish_output<CO, L::OUT_CH>(racc, s_out, s_stat + 2 * NWARP * CO, p.res, p, cur, tid,
                                       sync);
        }
        if (k + 1 == nsteps || tile_at(p, gid + (k / ns + 1) * gstride).b != cur.b) {
          flush_stats<RES, CO>(s_stat, cur.b, gid, p, tid);  // the adds are visible
          sync();  // before the next tile's adds
        }
        zero(racc);
      } else {
        store_f32<CO>(acc, static_cast<float*>(p.out), p, cur, warp, lane);
      }
      zero(acc);
    }
  }
}

template <int MODE, int CO>
cudaError_t launch_async(TcConvArgs p, int device, cudaStream_t stream, Plan* plan) {
  using L = Async<MODE, CO>;
  const int ns = p.C / 16;
  if (plan == nullptr &&
      (p.W % ASYNC_W_ALIGN != 0 || reinterpret_cast<uintptr_t>(p.x) % 16 != 0 ||
       (MODE == CAT2 && reinterpret_cast<uintptr_t>(p.x1) % 16 != 0)))
    return cudaErrorInvalidValue;  // aligned 16-byte pieces
  int optin = 0, sms = 0;
  cudaError_t e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  p.resident = L::W + ns * L::W_SLICE <= optin;
  const int smem = L::W + (p.resident ? ns : 2 * L::NG) * L::W_SLICE;
  if (smem > optin) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(conv_tc_async_kernel<MODE, CO>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_tc_async_kernel<MODE, CO>,
                                                    L::NG * NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (plan != nullptr) {
    *plan = Plan{per_sm, L::NG * NT, smem, p.resident};
    return cudaSuccess;
  }
  p.ntx = (p.W + TX - 1) / TX;
  p.nty = (p.H + TY - 1) / TY;
  p.ntz = (p.D + TZ - 1) / TZ;
  const long long ntiles = (long long)p.B * p.ntz * p.nty * p.ntx;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  if (p.ntiles == 0) return cudaSuccess;
  const int blocks = (p.ntiles + L::NG - 1) / L::NG;
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  e = set_slots<L::STATS>(p, (long long)grid * L::NG);
  if (e != cudaSuccess) return e;
  conv_tc_async_kernel<MODE, CO><<<grid, L::NG * NT, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finish_stats<L::STATS, L::RES, CO>(p, stream);
}

template <int CO>
cudaError_t dispatch_mode(int mode, int residual, const TcConvArgs& p, int device,
                          cudaStream_t st, Plan* plan) {
  switch (mode) {
    case PLAIN:
      return residual ? launch<PLAIN, true, CO>(p, device, st, plan)
                      : launch<PLAIN, false, CO>(p, device, st, plan);
    case AFFINE:
      return residual ? launch<AFFINE, true, CO>(p, device, st, plan)
                      : launch<AFFINE, false, CO>(p, device, st, plan);
    default:
      return cudaErrorInvalidValue;
  }
}

// CAT2, COMBINE and FLAT only at the output widths their routes send
// (conv_of.TC_MODE_C_OUT), COMBINE for either width of x, CAT2 and FLAT
// for either staging: each unrolled instantiation adds to the build time.
cudaError_t dispatch_wide(int mode, int c_out, int staging, const TcConvArgs& p, int device,
                          cudaStream_t st, Plan* plan) {
  const bool one = p.Cx == 1, as = staging == ASYNC;
  if (mode == CAT2 && c_out == 32)
    return as ? launch_async<CAT2, 32>(p, device, st, plan)
               : launch<CAT2, true, 32>(p, device, st, plan);
  if (mode == CAT2 && c_out == 64)
    return as ? launch_async<CAT2, 64>(p, device, st, plan)
               : launch<CAT2, true, 64>(p, device, st, plan);
  if (mode == FLAT && c_out == 16)
    return as ? launch_async<FLAT, 16>(p, device, st, plan)
               : launch<FLAT, false, 16>(p, device, st, plan);
  if (mode == FLAT && c_out == 32)
    return as ? launch_async<FLAT, 32>(p, device, st, plan)
               : launch<FLAT, false, 32>(p, device, st, plan);
  if (mode == FLAT && c_out == 64)
    return as ? launch_async<FLAT, 64>(p, device, st, plan)
               : launch<FLAT, false, 64>(p, device, st, plan);
  if (as) return cudaErrorInvalidValue;
  if (mode == COMBINE && c_out == 16)
    return one ? launch<COMBINE, true, 16, 1>(p, device, st, plan)
               : launch<COMBINE, true, 16, 8>(p, device, st, plan);
  if (mode == COMBINE && c_out == 32)
    return one ? launch<COMBINE, true, 32, 1>(p, device, st, plan)
               : launch<COMBINE, true, 32, 8>(p, device, st, plan);
  return cudaErrorInvalidValue;
}

// The checks and dispatch of both entry points below.
cudaError_t conv_tc(int device, int mode, int residual, int c_out, int staging,
                    const TcConvArgs& p, cudaStream_t st, Plan* plan) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int max_c = mode == CAT2 || mode == FLAT ? 128 : 64;
  if (p.C < 16 || p.C > max_c || p.C % 16 != 0) return cudaErrorInvalidValue;
  if (staging != REGISTERS && !((mode == CAT2 || mode == FLAT) && staging == ASYNC))
    return cudaErrorInvalidValue;
  if (mode == CAT2 || mode == COMBINE) {
    if (!residual || p.C % 32 != 0 || (mode == COMBINE && p.Cx != 1 && p.Cx != p.C / 2))
      return cudaErrorInvalidValue;
    return dispatch_wide(mode, c_out, staging, p, device, st, plan);
  }
  if (mode == FLAT) {
    if (residual) return cudaErrorInvalidValue;
    return dispatch_wide(mode, c_out, staging, p, device, st, plan);
  }
  switch (c_out) {
    case 16:
      return dispatch_mode<16>(mode, residual, p, device, st, plan);
    case 32:
      return dispatch_mode<32>(mode, residual, p, device, st, plan);
    case 64:
      return dispatch_mode<64>(mode, residual, p, device, st, plan);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the kernel (and, modes with
// statistics, their fixed-order finish) was launched. ``part``: room for
// [2, or 4 with the residual tap][B][c_out][slots] fp32 partial sums, slots
// at least the launch's tile groups (blocks per SM x SMs x groups per
// block, from medseg_conv_tc_plan, or fewer where the volume has fewer
// tiles). mode 0:
// PLAIN, 1: AFFINE (x0, a0, b0), C a multiple of 16 up to 64, c_out 16, 32
// or 64; 2: CAT2 (x0, x1), 3: COMBINE (x0, x1, x2, a0, b0, a1, b1; Cx 1 or
// C/2), both with the residual tap, C/2 a multiple of 16 (CAT2: C up to 128;
// COMBINE: up to 64), c_out as dispatch_wide; 4: FLAT (x0; out fp32, no
// residual tap, no statistics), C a multiple of 16 up to 128. staging 1
// (CAT2 and FLAT, W a multiple of 8): the asynchronous staging, 0: registers.
int medseg_conv_tc(int device, int mode, int residual, int c_out, int staging, const void* x0,
                   const void* x1, const void* x2, const float* a0, const float* b0,
                   const float* a1, const float* b1, const void* w, const void* wres, void* out,
                   float* s, float* ss, void* res, float* rs, float* rss, float* part, int slots,
                   int B, int C, int Cx, int D, int H, int W, void* stream) {
  using bf = __nv_bfloat16;
  const medseg::TcConvArgs p{static_cast<const bf*>(x0), static_cast<const bf*>(x1),
                             static_cast<const bf*>(x2), a0, b0, a1, b1,
                             static_cast<const bf*>(w), static_cast<const bf*>(wres),
                             out, s, ss, static_cast<bf*>(res), rs, rss,
                             B, C, Cx, D, H, W, 0, 0, 0, 0, 0, part, slots};
  return (int)medseg::conv_tc(device, mode, residual, c_out, staging, p,
                              static_cast<cudaStream_t>(stream), nullptr);
}

// The plan of the launch that medseg_conv_tc would make for these widths,
// without launching: plan[0..3] = blocks per SM, threads per block, shared
// memory bytes per block, whether every slice's weights are resident.
int medseg_conv_tc_plan(int device, int mode, int residual, int c_out, int staging, int C, int Cx,
                        int* plan) {
  medseg::TcConvArgs p{};
  p.C = C;
  p.Cx = Cx;
  medseg::Plan r{};
  const cudaError_t e = medseg::conv_tc(device, mode, residual, c_out, staging, p, nullptr, &r);
  plan[0] = r.per_sm;
  plan[1] = r.threads;
  plan[2] = r.smem;
  plan[3] = r.resident;
  return (int)e;
}

}  // extern "C"
