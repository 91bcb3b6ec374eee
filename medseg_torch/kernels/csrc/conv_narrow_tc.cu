// The narrow-input 3x3x3 convs on the tensor cores: the forward (K1) and the
// filter gradient (K6) of a same-pad conv whose input has 1 to 8 channels
// (encoder1.conv1 of UNETR: 1 CT channel, 4 BraTS channels), bf16 operands,
// fp32 sums, 16 or 32 output channels. NCDHW activations.
//
// Replaces, at those widths, two TPU kernels of medseg/kernels/conv_of.py:
//   - conv3x3x3_of (_kernel), K1, input_act "none", with or without the 1x1x1
//     residual tap, and the per-(b, c_out) sum and sum of squares of the fp32
//     results (the C = 1 case runs on the automatic halo pipeline there);
//   - conv3x3x3_wgrad_of (_wgrad_kernel), K6: dW (CO, C, 3, 3, 3) fp32.
// conv_tc.cu and wgrad_tc.cu slice the reduction by 16 input channels per
// tap, which wastes 15/16 of each MMA at C = 1; conv_of.cu and wgrad_of.cu
// (fp32 FMA) keep fp32 and the prologue modes at these widths.
//
// What bounds them on the H100: bytes. 16 bf16 output channels per voxel
// against 1 or 4 input channels: the output (K1) or the cotangent (K6) is
// 80-94% of the bytes. Their arithmetic (2 x 27 x C x 16 FLOP per voxel: 29
// GFLOP at C = 4 on 4x128^3) is above what the fp32 pipe does in that byte
// time, but noise on the tensor cores. So the design packs the reduction
// across taps and spends the rest on the big stream:
//   - K, the reduction of the forward (N, the columns of the filter
//     gradient), is (tap, ci) packed tap-major: k = tap * CP + ci with CP
//     the channels of a staged voxel (C rounded up to 1, 2, 4 or 8; the
//     extra channels staged 0), padded with zero weights to a multiple of 16
//     (8): 32 at C = 1 and 112 at C = 4, 2 and 7 k-steps of mma.sync
//     m16n8k16. At CP 4 and 8 the forward orders each k-step's taps so
//     that a lane's two B registers are 4 consecutive channels of one tap
//     (conv_of.narrow_columns): one 8-byte load.
//   - Tiles of 2 x 4 x 64 (z, y, x) voxels, one 64-voxel x-row per warp of
//     8; persistent blocks (as many as fit the SMs) walk the tiles in order,
//     x fastest. Each tile's input halo (4 x 6 x 66 voxels) is staged once
//     in shared memory, any W (the input is 1/16 to 1/4 of the output's
//     bytes; cp.async pieces where W % 8 == 0, a value at a time otherwise).
//   - The forward runs out^T = W (CO x K) . A^T (K x voxels): M = C_out, so
//     the weights are the A operand, held in registers for the block's life
//     where they fit (shared memory otherwise), and each accumulator holds
//     two x-neighbouring voxels of one output channel. A^T is gathered from
//     the channels-last halo through a per-thread table of (tap, ci) ->
//     shared-memory offsets: at CP = 2 a (ci, ci + 1) pair is one 32-bit
//     load, at CP 4 and 8 both registers one 64-bit load. The residual tap
//     is more M rows of the same product whose weights are zero but at the
//     centre tap, so only the k-step holding tap 13 runs them: one pass
//     gives out and res.
//   - The store stream: a quad's lanes hold 8 consecutive voxels of a
//     channel in 4 fragments; one 4 x 4 transpose of 32-bit words by
//     shuffles within the quad gives each lane 16 contiguous bytes, so a
//     warp writes its 64-voxel x-row of a channel as whole 128-byte lines of
//     NCDHW (16-byte stores where W % 8 == 0, 2-byte ones otherwise). No
//     shared-memory round trip, no barrier.
//   - Statistics as in conv_tc.cu: per-thread fp32 sums of the valid
//     voxels across a batch element's tiles, reduced over the quad and the
//     warps in a fixed order into the block's slot of the partial sums when
//     its walk leaves the batch element; stats_finish (common.cuh) adds the
//     slots in a fixed order. Bitwise reproducible.
//   - The filter gradient runs dW (CO x N) = G (CO x voxels) . X (voxels x N)
//     over the same tiles: the cotangent tile, 80-94% of the bytes, arrives
//     from its NCDHW rows as 16-byte cp.async pieces and its A fragments are
//     ldmatrix reads of it; the x operand comes from the staged halo by the
//     same kind of offset table, kept twice (one copy shifted by one voxel)
//     so that every x-neighbouring pair is one aligned 32-bit load. Each
//     warp sums its rows into registers across the block's whole walk; the
//     warps are added in a fixed order, each block writes its (CO, C, 27)
//     partial once, and wgrad_reduce (common.cuh) sums the blocks'
//     partials in block order. Deterministic.
//   - Staging, both kernels: each tile's x box (and K6's cotangent tile)
//     arrives by cp.async three tiles in flight per block (the ring of
//     NSTAGE stages), so that no tile waits for its loads; the forward
//     transposes it to channels-last at CP >= 2, the filter gradient builds
//     its shifted copy, 16 bytes at a time.
// Measured on the H100 (PERF.md section 6; tools/time_routes.py): 32-49% of
// the byte bound, 2.4-7x the CUDA-core kernels; a copy-only build without
// the gather and the MMAs (the copy floor) reached 47-65%.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_common.cuh"

namespace medseg {
namespace {

constexpr int TX = 64, TY = 4, TZ = 2;  // voxel tile: one x-row of 64 per warp
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int NT = 256;
constexpr int NWARP = NT / 32;
static_assert(TZ * TY == NWARP, "one x-row per warp");
constexpr unsigned FULL = 0xffffffffu;
constexpr int NSTAGE = 3;  // staged tiles: the current one and two ahead

struct Tile {
  int b, z0, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int ntx, int nty, int ntz) {
  Tile r;
  r.x0 = (t % ntx) * TX;
  t /= ntx;
  r.y0 = (t % nty) * TY;
  t /= nty;
  r.z0 = (t % ntz) * TZ;
  r.b = t / ntz;
  return r;
}

// Lane t of each quad holds w[j] = M[t][j]; afterwards v[i] = M[i][t] (a 4 x
// 4 transpose of 32-bit words within the quad, 4 shuffles).
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
  const int t = threadIdx.x & 3;
  const bool l = t & 1, h = t & 2;
  // exchange with t ^ 1 the words whose index differs from t in bit 0
  const uint32_t x0 = l ? w[1] : w[0], x1 = l ? w[3] : w[2];  // M[t][l], M[t][l + 2]
  const uint32_t r0 = __shfl_xor_sync(FULL, l ? w[0] : w[1], 1);  // M[t ^ 1][l]
  const uint32_t r1 = __shfl_xor_sync(FULL, l ? w[2] : w[3], 1);  // M[t ^ 1][l + 2]
  // exchange with t ^ 2 the column that is not t
  const uint32_t k0 = h ? x1 : x0, k1 = h ? r1 : r0;  // M[t][t], M[t ^ 1][t]
  const uint32_t q0 = __shfl_xor_sync(FULL, h ? x0 : x1, 2);  // M[t ^ 2][t]
  const uint32_t q1 = __shfl_xor_sync(FULL, h ? r0 : r1, 2);  // M[t ^ 3][t]
  const uint32_t e0 = l ? k1 : k0, e1 = l ? k0 : k1;  // rows (t & 2), (t & 2) + 1
  const uint32_t f0 = l ? q1 : q0, f1 = l ? q0 : q1;  // rows (t & 2) ^ 2, ((t & 2) ^ 2) + 1
  w[0] = h ? f0 : e0;
  w[1] = h ? f1 : e1;
  w[2] = h ? e0 : f0;
  w[3] = h ? e1 : f1;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The 8 bf16 of ``w`` to an x-row from x = x0 on, those inside W.
__device__ __forceinline__ void store8(__nv_bfloat16* row, int x0, int W, bool vec,
                                       const uint32_t (&w)[4]) {
  if (vec && x0 + 8 <= W) {
    *reinterpret_cast<uint4*>(row + x0) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  unsigned short* r = reinterpret_cast<unsigned short*>(row);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (x0 + k < W) r[x0 + k] = (unsigned short)(w[k >> 1] >> (16 * (k & 1)));
}

// The raw x box of a tile in shared memory: per (c, hz, hy) row of the CP x
// HZ x HY halo rows (channel-major, a channel every CPW words: 16 bytes more
// than its rows, so that the channels of a column tile start in other banks;
// channels c >= C and rows outside the volume 0) RW 32-bit words, element
// XOFF + hx holding halo voxel hx (x = x0 - 1 + hx), so that the tile's 64
// voxels (words 4..35) are 16-byte aligned: where W % 8 == 0 and x is 16-byte
// aligned (``async``), each row arrives as 8 cp.async pieces of 16 bytes and
// two of 4 (the x-pairs (x0 - 2, x0 - 1) and (x0 + 64, x0 + 65)), with zero
// fill outside the volume, issued a tile ahead (the caller commits);
// otherwise a value at a time.
constexpr int RW = 40;
constexpr int RWE = 2 * RW;  // elements per raw row
constexpr int XOFF = 7;
constexpr int RAW_ROWS = HZ * HY;  // per channel
constexpr int CPW = RAW_ROWS * RW + 4;
constexpr int EO = XOFF - 1;  // K6's E: halo voxel hx at element EO + hx

template <int CP>
struct Raw {
  static constexpr int BYTES = (CP * CPW * 4 + 127) / 128 * 128;
};

struct XIn {
  const __nv_bfloat16* x;  // (B, C, D, H, W)
  int C, D, H, W;
};

template <int CP>
__device__ __forceinline__ void issue_raw(const XIn& in, const Tile& t, unsigned char* raw,
                                          bool async, int tid) {
  const long long V = (long long)in.D * in.H * in.W;
  const __nv_bfloat16* xb = in.x + (long long)t.b * in.C * V;
  if (async) {
    const uint32_t base = tc::smem_u32(raw);
    for (int i = tid; i < CP * RAW_ROWS * 10; i += NT) {
      const int row = i / 10, piece = i - row * 10;
      const int c = row / RAW_ROWS, r = row - c * RAW_ROWS;
      const int hz = r / HY, hy = r - hz * HY;
      const int gz = t.z0 - 1 + hz, gy = t.y0 - 1 + hy;
      const bool in_row = c < in.C && gz >= 0 && gz < in.D && gy >= 0 && gy < in.H;
      const __nv_bfloat16* src = in_row ? xb + c * V + ((long long)gz * in.H + gy) * in.W : xb;
      const uint32_t dst = base + (c * CPW + r * RW) * 4;
      if (piece == 0) {
        const bool ok = in_row && t.x0 >= 2;
        tc::cp_async4_zfill(dst + 3 * 4, ok ? src + t.x0 - 2 : xb, ok ? 4 : 0);
      } else if (piece == 9) {
        const bool ok = in_row && t.x0 + 64 < in.W;
        tc::cp_async4_zfill(dst + 36 * 4, ok ? src + t.x0 + 64 : xb, ok ? 4 : 0);
      } else {
        const int gx = t.x0 + 8 * (piece - 1);
        const bool ok = in_row && gx < in.W;
        tc::cp_async16_zfill(dst + (4 + 4 * (piece - 1)) * 4, ok ? src + gx : xb, ok ? 16 : 0);
      }
    }
    return;
  }
  unsigned short* h = reinterpret_cast<unsigned short*>(raw);
  const unsigned short* x16 = reinterpret_cast<const unsigned short*>(xb);
  for (int i = tid; i < CP * RAW_ROWS * (HX + 2); i += NT) {  // hx = -1 .. 66
    const int row = i / (HX + 2), hx = i - row * (HX + 2) - 1;
    const int c = row / RAW_ROWS, r = row - c * RAW_ROWS;
    const int gz = t.z0 - 1 + r / HY, gy = t.y0 - 1 + r % HY, gx = t.x0 - 1 + hx;
    const bool ok = c < in.C && gz >= 0 && gz < in.D && gy >= 0 && gy < in.H && gx >= 0 &&
                    gx < in.W;
    h[2 * c * CPW + r * RWE + XOFF + hx] = ok ? __ldg(x16 + c * V + ((long long)gz * in.H + gy) * in.W + gx)
                                  : (unsigned short)0;
  }
}

// ---------------------------------------------------------------------------
// K1: the forward
// ---------------------------------------------------------------------------

struct NarrowArgs {
  const __nv_bfloat16* x;     // (B, C, D, H, W)
  const __nv_bfloat16* w;     // (CO, KP) packed, k = tap * CP + ci
  const __nv_bfloat16* wres;  // (CO, KP), nonzero at tap 13 only; or null
  __nv_bfloat16* out;         // (B, CO, D, H, W)
  __nv_bfloat16* res;         // (B, CO, D, H, W) or null
  float* s;                   // (B, CO), written by stats_finish
  float* ss;
  float* rs;
  float* rss;
  float* part;                // the blocks' partial sums: [2 or 4][B][CO][nslots]
  int nslots;                 // blocks in the launch
  int B, C, D, H, W;
  int ntx, nty, ntz, ntiles;
};

// Per instantiation (a struct, so that device code can read it): the packed
// K, its k-steps, the one holding the centre tap's channels, the m16 tiles
// of C_out, n8 tiles per pass, whether the weights sit in registers, and the
// halo the gather reads: at CP = 1 the raw box itself (a y-row pitch HP of
// RWE elements, voxel hx at HX0 + hx), else channels-last [HZ][HY][HP][CP]
// transposed from it, voxel hx at position HX0 + hx (a y-row pitch of at
// least 68 positions that puts the next row 64 bytes further modulo 128, so
// that a k-step's taps of neighbouring rows fall in other banks). Shared memory: NSTAGE raw boxes (the tile's and the next ones'), the
// channels-last halo, the weights' rows where they are not in registers (a
// pitch of an odd multiple of 16 bytes: ldmatrix's 8 rows in 8 bank groups),
// the warps' statistics slots.
template <int CP, int CO, bool RES>
struct Fwd {
  static constexpr int KP = (27 * CP + 15) / 16 * 16;
  static constexpr int KS = KP / 16;
  static constexpr int K13 = 13 * CP / 16;
  static constexpr int MT = CO / 16;
  static constexpr int NOUT = RES ? 2 : 1;
  static constexpr int NN = MT * NOUT == 1 ? 8 : 4;
  static constexpr int PASSES = TX / (8 * NN);
  static constexpr bool WREG = KS * MT * 4 <= 32;
  static constexpr int NOFF = CP == 1 ? 4 : (CP == 2 ? 2 : 1);  // halo offsets per k-step, lane
  static constexpr int HP = CP == 1 ? RWE : (CP == 2 ? 80 : (CP == 4 ? 88 : 84));
  static constexpr int HX0 = CP == 1 ? XOFF : 1;
  static constexpr int RAW = Raw<CP>::BYTES;
  static constexpr int HALO = NSTAGE * RAW;
  static constexpr int HALO_BYTES = CP == 1 ? 0 : (HZ * HY * HP * CP * 2 + 127) / 128 * 128;
  static constexpr int W_PITCH = KP * 2 + 16;
  static constexpr int WS = HALO + HALO_BYTES;
  static constexpr int W_BYTES = WREG ? 0 : (MT * 16 * W_PITCH + 127) / 128 * 128;
  static constexpr int STAT = WS + W_BYTES;
  static constexpr int SMEM = STAT + NOUT * 2 * NWARP * CO * 4;
  // blocks per SM the registers are sized for (85 a thread for three)
  static constexpr int BLOCKS = CP == 1 && CO == 16 && !RES ? 3 : 2;
  static_assert(K13 == (14 * CP - 1) / 16, "the centre tap's channels in one k-step");
  static_assert(RAW % 128 == 0, "aligned raw boxes");
};

// Element offset in the halo of channel ci of a tap from a voxel's tap (0,
// 0, 0); padded taps (zero weights) read offset 0, a finite staged value.
template <int CP>
__device__ __forceinline__ int tap_offset(int tap, int ci, int hp) {
  if (tap >= 27) return 0;
  return (((tap / 9) * HY + (tap / 3) % 3) * hp + tap % 3) * CP + ci;
}

// The same of the k-th column in the order k = tap * CP + ci (CP 1 and 2).
template <int CP>
__device__ __forceinline__ int k_offset(int k, int hp) {
  return k >= 27 * CP ? 0 : tap_offset<CP>(k / CP, k % CP, hp);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The raw box, channel-major, to the channels-last halo [HZ][HY][HP][CP],
// halo voxel hx at position hx + 1: item (row, quad) reads 16 bytes (8
// x-neighbouring voxels) of each of the CP channels and writes the voxels'
// CP channels two voxels to a store.
template <int CP, int HP>
__device__ __forceinline__ void raw_to_halo(const unsigned char* raw, __nv_bfloat16* halo,
                                            int tid) {
  static_assert(CP == 2 || CP == 4 || CP == 8, "channels-last rows of 4, 8 or 16 bytes");
  constexpr int QUADS = RW / 4;  // raw words 4q .. 4q + 3: halo voxels 8q - 7 .. 8q
  const uint32_t* src = reinterpret_cast<const uint32_t*>(raw);
  for (int i = tid; i < RAW_ROWS * QUADS; i += NT) {
    const int r = i / QUADS, q = i - r * QUADS;
    uint4 v[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c)
      v[c] = *reinterpret_cast<const uint4*>(src + c * CPW + r * RW + 4 * q);
    __nv_bfloat16* row = halo + r * HP * CP;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // word k: voxels at positions 8q - 6 + 2k and + 1
      const int pos = 8 * q - 6 + 2 * k;
      if (pos < 0 || pos > HX) continue;  // positions 0 .. 67 hold halo voxels -1 .. 66
      uint32_t lo[CP / 2], hi[CP / 2];  // the two voxels' channel pairs
#pragma unroll
      for (int c = 0; c < CP / 2; ++c) {
        const uint32_t a = word(v[2 * c], k), b = word(v[2 * c + 1], k);
        lo[c] = __byte_perm(a, b, 0x5410);
        hi[c] = __byte_perm(a, b, 0x7632);
      }
      if constexpr (CP == 2) {
        *reinterpret_cast<uint2*>(row + pos * CP) = make_uint2(lo[0], hi[0]);
      } else if constexpr (CP == 4) {
        *reinterpret_cast<uint4*>(row + pos * CP) = make_uint4(lo[0], lo[1], hi[0], hi[1]);
      } else {
        *reinterpret_cast<uint4*>(row + pos * CP) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(row + (pos + 1) * CP) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
  }
}

// One pass's epilogue for one output: the fragments (m, j) of NN n8 tiles
// from x = xb on, rounded to bf16, transposed in the quad and stored;
// their valid voxels' sums into ``st`` ([m][h][sum, sq]).
template <int MT, int NN>
__device__ __forceinline__ void store_pass(const float (&acc)[MT][NN][4], __nv_bfloat16* out,
                                           long long V, long long row, int xb, int W, bool vec,
                                           float (&st)[MT][2][2], int g, int tig) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat16* dst = out + (long long)(16 * m + 8 * h + g) * V + row;
#pragma unroll
      for (int q = 0; q < NN / 4; ++q) {
        uint32_t w[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj;
          const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
          const int x = xb + 8 * j + 2 * tig;
          if (x < W) {
            st[m][h][0] += v0;
            st[m][h][1] += v0 * v0;
          }
          if (x + 1 < W) {
            st[m][h][0] += v1;
            st[m][h][1] += v1 * v1;
          }
          w[jj] = pack_bf16(v0, v1);
        }
        quad_transpose(w);
        store8(dst, xb + 32 * q + 8 * tig, W, vec, w);
      }
    }
}

template <int CP, int CO, bool RES>
__global__ void __launch_bounds__(NT, Fwd<CP, CO, RES>::BLOCKS) conv_narrow_kernel(NarrowArgs p) {
  using F = Fwd<CP, CO, RES>;
  constexpr int MT = F::MT, NN = F::NN, KS = F::KS, NOUT = F::NOUT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_stat = reinterpret_cast<float*>(smem + F::STAT);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long HW = (long long)p.H * p.W, V = HW * p.D;
  const bool vec = p.W % 8 == 0 && reinterpret_cast<uintptr_t>(p.out) % 16 == 0 &&
                   (!RES || reinterpret_cast<uintptr_t>(p.res) % 16 == 0);
  const bool async = p.W % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0;
  const XIn in{p.x, p.C, p.D, p.H, p.W};

  // the weights: A fragments (co 16m + g (+8), k 16ks + 2tig (+1, +8, +9))
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(p.w);
  auto wfrag = [&](const uint32_t* src, int ks, int m, uint32_t (&a)[4]) {
    const int r0 = (16 * m + g) * (F::KP / 2) + 8 * ks + tig;
    a[0] = __ldg(src + r0);
    a[1] = __ldg(src + r0 + 4 * F::KP);
    a[2] = __ldg(src + r0 + 4);
    a[3] = __ldg(src + r0 + 4 * F::KP + 4);
  };
  uint32_t wa[F::WREG ? KS : 1][MT][4];
  uint32_t wr[RES ? MT : 1][4];
  if constexpr (F::WREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int m = 0; m < MT; ++m) wfrag(w32, ks, m, wa[ks][m]);
  } else {  // visible after the walk's first barrier
    for (int i = threadIdx.x; i < MT * 16 * (F::KP / 8); i += NT) {
      const int r = i / (F::KP / 8), c = i - r * (F::KP / 8);
      *reinterpret_cast<uint4*>(smem + F::WS + r * F::W_PITCH + 16 * c) =
          __ldg(reinterpret_cast<const uint4*>(p.w) + i);
    }
  }
  if constexpr (RES) {
#pragma unroll
    for (int m = 0; m < MT; ++m) wfrag(reinterpret_cast<const uint32_t*>(p.wres), F::K13, m, wr[m]);
  }
  const uint32_t w_smem = tc::smem_u32(smem + F::WS);
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;

  // this lane's halo offsets of its k columns, per k-step (the order of
  // conv_of.narrow_columns: at CP 4 and 8 both B registers are 4 consecutive
  // channels of one tap)
  int off[KS][F::NOFF];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int k = 16 * ks + 2 * tig;
    if constexpr (CP == 1) {
      off[ks][0] = k_offset<CP>(k, F::HP);
      off[ks][1] = k_offset<CP>(k + 1, F::HP);
      off[ks][2] = k_offset<CP>(k + 8, F::HP);
      off[ks][3] = k_offset<CP>(k + 9, F::HP);
    } else if constexpr (CP == 2) {
      off[ks][0] = k_offset<CP>(k, F::HP);
      off[ks][1] = k_offset<CP>(k + 8, F::HP);
    } else {
      constexpr int LPT = CP / 4;  // lanes per tap
      off[ks][0] = tap_offset<CP>(16 / CP * ks + tig / LPT, 4 * (tig % LPT), F::HP);
    }
  }

  float st[NOUT][MT][2][2];
#pragma unroll
  for (int o = 0; o < NOUT; ++o)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) st[o][m][h][0] = st[o][m][h][1] = 0.f;

  const int z = warp / TY, y = warp % TY;  // this warp's x-row of the tile
  const int tiles_per_b = p.ntz * p.nty * p.ntx;
  // the ring: tile i of the walk in box i % NSTAGE, issued NSTAGE - 1 tiles
  // ahead, one commit group per tile (empty past the walk's end)
  for (int s = 0; s < NSTAGE - 1; ++s) {
    const int ahead = blockIdx.x + s * gridDim.x;
    if (ahead < p.ntiles)
      issue_raw<CP>(in, tile_at(ahead, p.ntx, p.nty, p.ntz), smem + s * F::RAW, async,
                    threadIdx.x);
    tc::cp_async_commit();
  }
  int slot = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, p.ntx, p.nty, p.ntz);
    tc::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // the tile's raw box landed; the previous tile's reads are done
    const int ahead = tile + (NSTAGE - 1) * gridDim.x;
    if (ahead < p.ntiles)
      issue_raw<CP>(in, tile_at(ahead, p.ntx, p.nty, p.ntz),
                    smem + (slot == 0 ? NSTAGE - 1 : slot - 1) * F::RAW, async, threadIdx.x);
    tc::cp_async_commit();
    const __nv_bfloat16* halo;
    if constexpr (CP == 1) {
      halo = reinterpret_cast<const __nv_bfloat16*>(smem + slot * F::RAW);
    } else {
      __nv_bfloat16* cl = reinterpret_cast<__nv_bfloat16*>(smem + F::HALO);
      raw_to_halo<CP, F::HP>(smem + slot * F::RAW, cl, threadIdx.x);
      __syncthreads();
      halo = cl;
    }
    slot = slot == NSTAGE - 1 ? 0 : slot + 1;
    const int gz = t.z0 + z, gy = t.y0 + y;
    if (gz < p.D && gy < p.H) {
      const long long row = (long long)t.b * CO * V + gz * HW + (long long)gy * p.W;
#pragma unroll 1
      for (int pass = 0; pass < F::PASSES; ++pass) {
        const int xs = pass * 8 * NN;
        if (t.x0 + xs >= p.W) break;
        float acc[MT][NN][4], racc[RES ? MT : 1][NN][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NN; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] = racc[RES ? m : 0][j][e] = 0.f;
        const int vb = ((z * HY + y) * F::HP + F::HX0 + xs + g) * CP;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if constexpr (F::WREG) {
#pragma unroll
              for (int e = 0; e < 4; ++e) a[m][e] = wa[ks][m][e];
            } else {
              tc::ldsm_x4(w_smem + (16 * m + a_row) * F::W_PITCH + 32 * ks + 16 * a_chunk, a[m]);
            }
          }
#pragma unroll
          for (int j = 0; j < NN; ++j) {
            const int v = vb + 8 * j * CP;
            // the lane's B registers: columns (k, k + 1) and (k + 8, k + 9)
            uint32_t b0, b1;
            if constexpr (CP == 1) {  // four taps, a value each
              const unsigned short* h = reinterpret_cast<const unsigned short*>(halo) + v;
              b0 = (uint32_t)h[off[ks][0]] | ((uint32_t)h[off[ks][1]] << 16);
              b1 = (uint32_t)h[off[ks][2]] | ((uint32_t)h[off[ks][3]] << 16);
            } else if constexpr (CP == 2) {  // two taps, a channel pair each
              b0 = *reinterpret_cast<const uint32_t*>(halo + v + off[ks][0]);
              b1 = *reinterpret_cast<const uint32_t*>(halo + v + off[ks][1]);
            } else {  // one tap, four channels
              const uint2 q = *reinterpret_cast<const uint2*>(halo + v + off[ks][0]);
              b0 = q.x;
              b1 = q.y;
            }
#pragma unroll
            for (int m = 0; m < MT; ++m) tc::mma_bf16(acc[m][j], a[m], b0, b1);
            if constexpr (RES) {
              if (ks == F::K13) {
#pragma unroll
                for (int m = 0; m < MT; ++m) tc::mma_bf16(racc[m][j], wr[m], b0, b1);
              }
            }
          }
        }
        store_pass<MT, NN>(acc, p.out, V, row, t.x0 + xs, p.W, vec, st[0], g, tig);
        if constexpr (RES)
          store_pass<MT, NN>(racc, p.res, V, row, t.x0 + xs, p.W, vec, st[NOUT - 1], g, tig);
      }
    }
    // the statistics leave when the walk leaves the batch element
    const int next = tile + gridDim.x;
    if (next >= p.ntiles || next / tiles_per_b != t.b) {
#pragma unroll
      for (int o = 0; o < NOUT; ++o)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              float v = st[o][m][h][k];
              v += __shfl_xor_sync(FULL, v, 1);
              v += __shfl_xor_sync(FULL, v, 2);
              if (tig == 0) s_stat[((2 * o + k) * NWARP + warp) * CO + 16 * m + 8 * h + g] = v;
              st[o][m][h][k] = 0.f;
            }
      __syncthreads();
      if (threadIdx.x < 2 * NOUT * CO) {
        const int kk = threadIdx.x / CO, co = threadIdx.x - kk * CO;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < NWARP; ++w) sum += s_stat[(kk * NWARP + w) * CO + co];
        p.part[((long long)(kk * p.B + t.b) * CO + co) * p.nslots + blockIdx.x] = sum;
      }
    }
  }
}

template <int CP, int CO, bool RES>
cudaError_t launch_fwd(NarrowArgs p, int device, cudaStream_t stream, int* per_sm_out) {
  using F = Fwd<CP, CO, RES>;
  cudaError_t e = cudaFuncSetAttribute(conv_narrow_kernel<CP, CO, RES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_narrow_kernel<CP, CO, RES>, NT,
                                                    F::SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm_out != nullptr) {
    *per_sm_out = per_sm;
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  p.ntx = (p.W + TX - 1) / TX;
  p.nty = (p.H + TY - 1) / TY;
  p.ntz = (p.D + TZ - 1) / TZ;
  const long long ntiles = (long long)p.B * p.ntz * p.nty * p.ntx;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  if (p.ntiles == 0) return cudaSuccess;
  const int grid = p.ntiles < per_sm * sms ? p.ntiles : per_sm * sms;
  if (grid > p.nslots) return cudaErrorInvalidValue;  // the caller's partial-sum buffer
  p.nslots = grid;
  conv_narrow_kernel<CP, CO, RES><<<grid, NT, F::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return stats_finish(p.part, p.nslots, RES ? 4 : 2, p.B, CO, p.ntz * p.nty * p.ntx, p.ntiles,
                      p.s, p.ss, p.rs, p.rss, stream);
}

template <int CP>
cudaError_t dispatch_fwd(int c_out, int residual, const NarrowArgs& p, int device,
                         cudaStream_t st, int* per_sm) {
  if (c_out == 16)
    return residual ? launch_fwd<CP, 16, true>(p, device, st, per_sm)
                    : launch_fwd<CP, 16, false>(p, device, st, per_sm);
  if (c_out == 32)
    return residual ? launch_fwd<CP, 32, true>(p, device, st, per_sm)
                    : launch_fwd<CP, 32, false>(p, device, st, per_sm);
  return cudaErrorInvalidValue;
}

cudaError_t conv_narrow(int device, int residual, int c_out, const NarrowArgs& p,
                        cudaStream_t st, int* per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p.C < 1 || p.C > 8) return cudaErrorInvalidValue;
  if (p.C == 1) return dispatch_fwd<1>(c_out, residual, p, device, st, per_sm);
  if (p.C == 2) return dispatch_fwd<2>(c_out, residual, p, device, st, per_sm);
  if (p.C <= 4) return dispatch_fwd<4>(c_out, residual, p, device, st, per_sm);
  return dispatch_fwd<8>(c_out, residual, p, device, st, per_sm);
}

// ---------------------------------------------------------------------------
// K6: the filter gradient
// ---------------------------------------------------------------------------

struct WgradNarrowArgs {
  const __nv_bfloat16* x;  // (B, C, D, H, W)
  const __nv_bfloat16* g;  // (B, CO, D, H, W)
  float* partial;          // (gridDim.x, CO, C, 27)
  int B, C, D, H, W;
  int ntx, nty, ntz, ntiles;
};

// Per instantiation: the (tap, ci) columns (tap-major, padded to n8 tiles),
// the warps' split of them (so that a warp's sums stay within 32 registers:
// NSPLIT groups of warps, each with NTW n8 tiles and NSPLIT x-rows per
// tile), and shared memory: NSTAGE stages (the tile's and the next ones'),
// each the raw x box, which serves the taps with kx odd (the x-pair (x, x +
// 1) of such a tap starts on 4 bytes there), and the cotangent tile [CO][512
// voxels] (a channel every 1040 bytes: ldmatrix's 8 rows in 8 bank groups);
// then the current tile's raw rows one element to the left (E: voxel hx at
// element EO + hx, so that 16 aligned bytes of E come from 20 of the raw
// row), for the taps with kx even, 64 bytes modulo 128 after a raw box: a
// column tile's (tap, ci) rows start in spread banks.
template <int CP, int CO>
struct Wg {
  static constexpr int NP = (27 * CP + 7) / 8 * 8;
  static constexpr int NT8 = NP / 8;
  static constexpr int MT = CO / 16;
  static constexpr int NSPLIT = MT * NT8 * 4 <= 32   ? 1
                                : MT * NT8 * 2 <= 32 ? 2
                                : MT * NT8 <= 32     ? 4
                                                     : 8;
  static constexpr int NTW = (NT8 + NSPLIT - 1) / NSPLIT;
  static constexpr int RAW = (CP * CPW * 4 + 127) / 128 * 128;
  static constexpr int CPITCH = TZ * TY * TX + 8;  // cotangent elements per channel
  static constexpr int STAGE = RAW + (CO * CPITCH * 2 + 127) / 128 * 128;
  static constexpr int E = NSTAGE * STAGE + 64;
  static constexpr int SMEM_ = E + RAW;
  static constexpr int SMEM = SMEM_ > CO * NP * 4 ? SMEM_ : CO * NP * 4;
  static constexpr int BLOCKS = 2;  // per SM, as the registers allow
  static_assert(RAW >= CP * CPW * 4 && STAGE % 128 == 0, "aligned stages");
  static_assert(NWARP % NSPLIT == 0, "whole warps per split");
};

template <int CP, int CO>
__global__ void __launch_bounds__(NT, Wg<CP, CO>::BLOCKS) wgrad_narrow_kernel(WgradNarrowArgs p) {
  using L = Wg<CP, CO>;
  constexpr int MT = L::MT, NTW = L::NTW, NSPLIT = L::NSPLIT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int split = warp % NSPLIT, wrow = warp / NSPLIT;
  const long long HW = (long long)p.H * p.W, V = HW * p.D;
  const bool async = p.W % 8 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(p.g) % 16 == 0;
  const XIn in{p.x, p.C, p.D, p.H, p.W};

  // the element offset of this lane's column (tap, ci) of each of its n8
  // tiles, from the voxel's tap (0, 0, 0), in the raw box (kx odd: bit j of
  // ``odd``) or in E
  int off[NTW];
  unsigned odd = 0;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int n = 8 * (split * NTW + j) + g;
    off[j] = 0;
    if (n < 27 * CP) {
      const int tap = n / CP, ci = n % CP, kx = tap % 3;
      off[j] = (kx & 1 ? XOFF : EO) + 2 * ci * CPW + ((tap / 9) * HY + (tap / 3) % 3) * RWE + kx;
      odd |= (unsigned)(kx & 1) << j;
    }
  }
  float acc[MT][NTW][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  // the x box and the cotangent of tile t into stage ``st``
  auto issue = [&](int tile, unsigned char* st) {
    const Tile t = tile_at(tile, p.ntx, p.nty, p.ntz);
    issue_raw<CP>(in, t, st, async, threadIdx.x);
    const __nv_bfloat16* gb = p.g + (long long)t.b * CO * V;
    unsigned char* cot = st + L::RAW;
    if (async) {
      const uint32_t base = tc::smem_u32(cot);
      for (int i = threadIdx.x; i < CO * TZ * TY * (TX / 8); i += NT) {
        const int co = i / (TZ * TY * (TX / 8)), rem = i - co * (TZ * TY * (TX / 8));
        const int r = rem / (TX / 8), piece = rem - r * (TX / 8);
        const int gz = t.z0 + r / TY, gy = t.y0 + r % TY, gx = t.x0 + 8 * piece;
        const bool ok = gz < p.D && gy < p.H && gx < p.W;
        tc::cp_async16_zfill(base + (co * L::CPITCH + r * TX + 8 * piece) * 2,
                             ok ? gb + co * V + gz * HW + (long long)gy * p.W + gx : gb,
                             ok ? 16 : 0);
      }
    } else {
      unsigned short* h = reinterpret_cast<unsigned short*>(cot);
      const unsigned short* g16 = reinterpret_cast<const unsigned short*>(gb);
      for (int i = threadIdx.x; i < CO * TZ * TY * TX; i += NT) {
        const int co = i / (TZ * TY * TX), rem = i - co * (TZ * TY * TX);
        const int r = rem / TX, xx = rem - r * TX;
        const int gz = t.z0 + r / TY, gy = t.y0 + r % TY, gx = t.x0 + xx;
        const bool ok = gz < p.D && gy < p.H && gx < p.W;
        h[co * L::CPITCH + rem] =
            ok ? __ldg(g16 + co * V + gz * HW + (long long)gy * p.W + gx) : (unsigned short)0;
      }
    }
  };

  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_chunk = lane >> 4;
  // the ring as in the forward: tile i of the walk in stage i % NSTAGE
  for (int s = 0; s < NSTAGE - 1; ++s) {
    const int ahead = blockIdx.x + s * gridDim.x;
    if (ahead < p.ntiles) issue(ahead, smem + s * L::STAGE);
    tc::cp_async_commit();
  }
  int slot = 0;
  for (int tile = blockIdx.x; tile < p.ntiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, p.ntx, p.nty, p.ntz);
    unsigned char* st = smem + slot * L::STAGE;
    tc::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // the tile's stage landed; the previous tile's reads are done
    const int ahead = tile + (NSTAGE - 1) * gridDim.x;
    if (ahead < p.ntiles) issue(ahead, smem + (slot == 0 ? NSTAGE - 1 : slot - 1) * L::STAGE);
    tc::cp_async_commit();
    slot = slot == NSTAGE - 1 ? 0 : slot + 1;
    {  // E: the raw rows one element to the left, 4 words at a time: E
       // elements 8q .. 8q + 7 are raw elements 8q + 1 .. 8q + 8
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(st);
      uint32_t* e = reinterpret_cast<uint32_t*>(smem + L::E);
      constexpr int QUADS = (EO + HX + 7) / 8;  // E elements EO .. EO + 65
      for (int i = threadIdx.x; i < CP * RAW_ROWS * QUADS; i += NT) {
        const int row = i / QUADS, q = i - row * QUADS;
        const int c = row / RAW_ROWS, r = row - c * RAW_ROWS;
        const int w = c * CPW + r * RW + 4 * q;
        const uint4 a = *reinterpret_cast<const uint4*>(raw + w);
        const uint32_t b = raw[w + 4];
        *reinterpret_cast<uint4*>(e + w) =
            make_uint4(__byte_perm(a.x, a.y, 0x5432), __byte_perm(a.y, a.z, 0x5432),
                       __byte_perm(a.z, a.w, 0x5432), __byte_perm(a.w, b, 0x5432));
      }
    }
    __syncthreads();
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(smem);
    const uint32_t cot = tc::smem_u32(st + L::RAW);
    int o[NTW];  // the columns' offsets from shared memory's start
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      o[j] = off[j] + ((odd >> j) & 1 ? (int)(st - smem) : L::E) / 2;
#pragma unroll 1
    for (int i = 0; i < NSPLIT; ++i) {
      const int r = wrow + i * (NWARP / NSPLIT);  // this warp's x-row of the tile
      const int z = r / TY, y = r % TY;
      if (t.z0 + z >= p.D || t.y0 + y >= p.H) continue;
      const int rb = (z * HY + y) * RWE;
#pragma unroll
      for (int s = 0; s < TX / 16; ++s) {  // k16 steps of 16 voxels
        if (t.x0 + 16 * s >= p.W) break;
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          tc::ldsm_x4(cot + ((16 * m + a_row) * L::CPITCH + r * TX + 16 * s + 8 * a_chunk) * 2,
                      a[m]);
        const int v = rb + 16 * s + 2 * tig;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(h + v + o[j]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(h + v + o[j] + 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) tc::mma_bf16(acc[m][j], a[m], b0, b1);
        }
      }
    }
  }

  // the warps' sums in a fixed order (the warps of each split in turn), then
  // the block's (CO, C, 27) partial to its slot
  float* red = reinterpret_cast<float*>(smem);  // [CO][NP]
#pragma unroll 1
  for (int round = 0; round < NWARP / NSPLIT; ++round) {
    __syncthreads();
    if (wrow == round) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NTW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 8 * (split * NTW + j) + 2 * tig + (e & 1);
            if (split * NTW + j >= L::NT8) continue;
            float* dst = red + (16 * m + g + 8 * (e >> 1)) * L::NP + n;
            *dst = round == 0 ? acc[m][j][e] : *dst + acc[m][j][e];
          }
    }
  }
  __syncthreads();
  float* out = p.partial + (long long)blockIdx.x * CO * p.C * 27;
  for (int i = threadIdx.x; i < CO * p.C * 27; i += NT) {
    const int co = i / (p.C * 27), rem = i - co * (p.C * 27);
    const int ci = rem / 27, tap = rem - ci * 27;
    out[i] = red[co * L::NP + tap * CP + ci];
  }
}

template <int CP, int CO>
cudaError_t launch_wgrad(WgradNarrowArgs p, int groups, float* dw, cudaStream_t stream,
                         int* per_sm_out) {
  using L = Wg<CP, CO>;
  cudaError_t e = cudaFuncSetAttribute(wgrad_narrow_kernel<CP, CO>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm_out != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm_out, wgrad_narrow_kernel<CP, CO>,
                                                         NT, L::SMEM);
  p.ntx = (p.W + TX - 1) / TX;
  p.nty = (p.H + TY - 1) / TY;
  p.ntz = (p.D + TZ - 1) / TZ;
  const long long ntiles = (long long)p.B * p.ntz * p.nty * p.ntx;
  if (ntiles > 0x7fffffff) return cudaErrorInvalidValue;
  p.ntiles = (int)ntiles;
  wgrad_narrow_kernel<CP, CO><<<groups, NT, L::SMEM, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return wgrad_reduce(p.partial, dw, CO * p.C * 27, groups, stream);
}

template <int CP>
cudaError_t dispatch_wgrad(int c_out, const WgradNarrowArgs& p, int groups, float* dw,
                           cudaStream_t st, int* per_sm) {
  if (c_out == 16) return launch_wgrad<CP, 16>(p, groups, dw, st, per_sm);
  if (c_out == 32) return launch_wgrad<CP, 32>(p, groups, dw, st, per_sm);
  return cudaErrorInvalidValue;
}

cudaError_t wgrad_narrow(int device, int c_out, const WgradNarrowArgs& p, int groups, float* dw,
                         cudaStream_t st, int* per_sm) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (p.C < 1 || p.C > 8 || (per_sm == nullptr && groups < 1)) return cudaErrorInvalidValue;
  if (p.C == 1) return dispatch_wgrad<1>(c_out, p, groups, dw, st, per_sm);
  if (p.C == 2) return dispatch_wgrad<2>(c_out, p, groups, dw, st, per_sm);
  if (p.C <= 4) return dispatch_wgrad<4>(c_out, p, groups, dw, st, per_sm);
  return dispatch_wgrad<8>(c_out, p, groups, dw, st, per_sm);
}

}  // namespace
}  // namespace medseg

extern "C" {

// Returns a cudaError_t value: 0 when the conv and its statistics' finish
// were launched. x (B, C, D, H, W) bf16 with 1 <= C <= 8; w (and wres, or
// null) packed (c_out, KP) bf16 by conv_of.pack_narrow_weight (_wres);
// c_out 16 or 32; out (and res) (B, c_out, D, H, W) bf16; part room for [2,
// or 4 with the residual tap][B][c_out][slots] fp32, slots at least the
// launch's blocks (blocks per SM from medseg_narrow_plan x SMs, or fewer
// where the volume has fewer 2x4x64 tiles).
int medseg_conv_narrow(int device, int residual, int c_out, const void* x, const void* w,
                       const void* wres, void* out, float* s, float* ss, void* res, float* rs,
                       float* rss, float* part, int slots, int B, int C, int D, int H, int W,
                       void* stream) {
  using bf = __nv_bfloat16;
  const medseg::NarrowArgs p{static_cast<const bf*>(x), static_cast<const bf*>(w),
                             static_cast<const bf*>(wres), static_cast<bf*>(out),
                             static_cast<bf*>(res), s, ss, rs, rss, part, slots,
                             B, C, D, H, W, 0, 0, 0, 0};
  if (residual && (wres == nullptr || res == nullptr)) return (int)cudaErrorInvalidValue;
  return (int)medseg::conv_narrow(device, residual, c_out, p, static_cast<cudaStream_t>(stream),
                                  nullptr);
}

// Returns a cudaError_t value: 0 when both kernels were launched. x (B, C,
// D, H, W) and g (B, c_out, D, H, W) bf16, 1 <= C <= 8, c_out 16 or 32;
// partial holds groups * c_out * C * 27 floats; dw (c_out, C, 3, 3, 3) fp32
// is written, not accumulated.
int medseg_wgrad_narrow(int device, int c_out, const void* x, const void* g, float* partial,
                        float* dw, int B, int C, int D, int H, int W, int groups, void* stream) {
  using bf = __nv_bfloat16;
  const medseg::WgradNarrowArgs p{static_cast<const bf*>(x), static_cast<const bf*>(g), partial,
                                  B, C, D, H, W, 0, 0, 0, 0};
  return (int)medseg::wgrad_narrow(device, c_out, p, groups, dw,
                                   static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks per SM of the kernel that would run these widths (which 0: the
// forward, with ``residual``; 1: the filter gradient), without launching.
int medseg_narrow_plan(int device, int which, int residual, int c_out, int C, int* per_sm) {
  *per_sm = 0;
  if (which == 0) {
    medseg::NarrowArgs p{};
    p.C = C;
    return (int)medseg::conv_narrow(device, residual, c_out, p, nullptr, per_sm);
  }
  medseg::WgradNarrowArgs p{};
  p.C = C;
  return (int)medseg::wgrad_narrow(device, c_out, p, 0, nullptr, nullptr, per_sm);
}

}  // extern "C"
