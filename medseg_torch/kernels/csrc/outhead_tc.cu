// Out head on the tensor cores: the final residual-block combine + LeakyReLU,
// the 1x1x1 head + bias and the per-voxel blend weight, with two exits.
// bf16 operands, fp32 sums. NCDHW.
//
// Replaces two TPU kernels of medseg/kernels/conv_of.py, for bf16 with C %
// 16 == 0 and K_pad 8, 16 or 32 (``conv_of.outhead_tc_route``; fp32 and the
// other widths keep outhead_of.cu and outhead_row_of.cu):
//   - outhead_of (_outhead_kernel), K3 (``outhead_tc_kernel``), C <= 64:
//       comb[c]   = leaky(az[b,c]*z[c] + bz[b,c] + ar[b,c]*res[c] + br[b,c]),
//                   rounded once to bf16
//       logits[k] = (sum_c K[k,c]*comb[c] + bias[k]) * scale    -> bf16
//   - outhead_row_of (_outhead_row_kernel), K4 (``outhead_row_tc_kernel``),
//     C <= 32: the same per window of a batch of B <= 16, summed in fp32 over
//     the windows covering each voxel in window order and added into the
//     (K, Dp, Hp, Wp) accumulator with one rounding to its dtype (fp32 or
//     bf16). Voxels no window covers are left untouched.
//
// What bounds it on the H100: device memory. Per voxel K3 reads 2*C bf16
// values and the fp32 weight and writes K bf16 logits (100 B at C = K = 16)
// for 2*C*K = 512 FLOP: ~5 FLOP/byte against the card's ~295. K4 reads 68 B
// per covered window voxel and reads and writes K accumulator values per
// voxel of the windows' box. So the design keeps bytes in flight and the
// arithmetic off their path:
//   - A warp owns a segment of 32 voxels: an x-run of the windows' bounding
//     box (K4; x-starts on multiples of 8 of the accumulator) or a run of
//     one batch element's flattened volume (K3). Its work is a sequence of
//     passes, one per (segment, window covering the segment's row) in window
//     order (K3: one per segment). Blocks of 8 independent warps are
//     persistent, each warp striding over the segments. No block barrier:
//     warps only meet at __syncwarp.
//   - A pass's bytes are copied by cp.async one pass ahead (STAGES = 2)
//     into a ring of stages in the warp's shared memory: per channel and
//     tensor, the run's 5 aligned 16-byte chunks (4 when it starts on 16
//     bytes; a window need not start on 8 voxels, the z-row walk's last one
//     starts at W - roi, nor a row on 16 bytes when W % 8 != 0), only those
//     holding a voxel the window covers, so no read leaves the aligned
//     chunks of the tensor; and the lane's blend weight (4 bytes, zero where
//     not covered: a 128-byte request per warp, as many transactions as
//     16-byte vectors, at any alignment). Nothing in flight holds a register.
//   - An item is 8 consecutive voxels of one channel: two of its row's
//     chunks shifted into place (``align8``), the combine applied once per
//     value (``tc::combine_pair``: fp32, one bf16 rounding, as the plain
//     version's ``comb.to(bf16)``), staged channel-major, 16-byte chunks
//     swizzled (``tc::swz<64>``), so that ``ldmatrix.trans`` reads the A
//     operand (voxels x channels) without a transpose or bank conflicts.
//   - The head is ``mma.sync`` m16n8k16 with voxels as M (two m16 tiles per
//     segment) and classes as N: K_pad = 8 fills one n8 tile. Each warp holds
//     the head's B fragments and the bias in registers for the whole kernel.
//   - The epilogue is fp32 in registers: (sum + bias) * weight, the same fp32
//     operations, rounded the same way, as the plain versions (__fadd_rn and
//     __fmul_rn: no contraction). K4 adds each window's weighted logits
//     into fp32 fragments that carry the sum across the segment's passes.
//   - The exit goes through shared memory (fp32 rows of 36 floats per class:
//     the fragment writes are conflict-free). K3's logits leave as 16-byte
//     vectors along x (an 8-voxel item that is not 16-byte aligned or not
//     wholly covered value by value). K4 does one read-modify-write of the
//     accumulator per class and voxel: the segment's accumulator rows are
//     copied with its first pass (aligned 16-byte chunks into a ring of
//     slots, one per stage), and the exit takes one voxel per lane, so a
//     warp's write is 32 consecutive values of a class plane at any
//     alignment of the rows (Wp % 8 != 0 included) and waits for no read.
// Ownership (K4): one warp owns each voxel of the box in a launch, and
// launches on a stream run in order, so the result is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "common.cuh"
#include "tc_common.cuh"

namespace medseg {
namespace {

constexpr int SEG = 32;        // voxels of a warp's segment: two m16 tiles
constexpr int WARPS = 8;       // warps of a block, each on its own segments
constexpr int NTHREADS = 32 * WARPS;
constexpr int MAXB = 16;       // windows per K4 launch (the wrapper splits larger batches)
constexpr int EPI_PITCH = 36;  // floats per class row of the exit's staging
constexpr int ROW_CHUNKS = 5;  // aligned 16-byte chunks holding a 32-voxel bf16 run
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of a warp: a ring of STAGES copy stages (each the z and res
// chunk rows of NCM * 16 channels, then the lane's blend weights), then the
// combined segment (channel-major bf16 rows of SEG voxels) and, after the
// last MMA of a segment, the exit's fp32 rows (NK * 8 classes) in the same
// bytes; then (K4, accumulator elements of ACC bytes) a ring of STAGES slots
// of a segment's accumulator rows, ACC_CHUNKS aligned 16-byte chunks per
// class.
template <int NCM, int NK, int ACC = 0>
struct Cfg {
  static constexpr int ROWS = NCM * 16;
  static constexpr int STAGES = 2;
  static constexpr int RAW_BYTES = 2 * ROWS * ROW_CHUNKS * 16;
  static constexpr int STAGE_BYTES = RAW_BYTES + SEG * 4;
  static constexpr int A_BYTES = ROWS * SEG * 2;
  static constexpr int E_BYTES = NK * 8 * EPI_PITCH * 4;
  static constexpr int AE_BYTES = A_BYTES > E_BYTES ? A_BYTES : E_BYTES;
  static constexpr int ACC_CHUNKS = ACC == 2 ? 5 : 9;  // a 32-value run at any alignment
  static constexpr int SLOT_BYTES = ACC ? NK * 8 * ACC_CHUNKS * 16 : 0;
  static constexpr int WARP_BYTES = STAGES * (STAGE_BYTES + SLOT_BYTES) + AE_BYTES;
  static constexpr int BLOCK_BYTES = WARPS * WARP_BYTES;
  static constexpr int ITEMS = ROWS * (SEG / 8) / 32;        // combine items per lane
  static constexpr int COPIES = 2 * ROWS * ROW_CHUNKS / 32;  // 16-byte copies per lane
  static_assert(2 * ROWS * ROW_CHUNKS % 32 == 0, "whole copies per lane");
};

// The head's B fragments (B[k][n] = kout[n][k], k a channel, n a class) and
// the bias of the lane's two classes per n8 tile, held for the whole kernel.
template <int NCM, int NK>
struct Head {
  uint32_t b[NK][NCM][2];
  float bias[NK][2];

  __device__ __forceinline__ void load(const __nv_bfloat16* kout, const float* bias_g, int C,
                                       int lane) {
    const unsigned short* k16 = reinterpret_cast<const unsigned short*>(kout);
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      const int n = 8 * nt + g;
#pragma unroll
      for (int ks = 0; ks < NCM; ++ks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // b0: channels 2t, 2t+1 of the slice; b1: 2t+8, 2t+9
          const int k = 16 * ks + 8 * h + 2 * t;
          b[nt][ks][h] = k < C ? (uint32_t)__ldg(k16 + n * C + k) |
                                     ((uint32_t)__ldg(k16 + n * C + k + 1) << 16)
                               : 0u;
        }
      }
      bias[nt][0] = __ldg(bias_g + 8 * nt + 2 * t);
      bias[nt][1] = __ldg(bias_g + 8 * nt + 2 * t + 1);
    }
  }
};

// One pass of a warp: a segment and the window (K4) or batch element (K3)
// it reads. Voxel v of the segment is element ``first + v`` of channel plane
// c (``plane`` elements apart) in z and res, element ``sfirst + v`` of the
// blend weight; bit v of ``bm``: the window covers voxel v.
struct Pass {
  int seg;     // the segment's index (< 0: no pass)
  int b;       // window (K4) or batch element (K3)
  int x0;      // the segment's voxel 0: its x in acc (K4) or in the flattened volume (K3)
  int y0, z0;  // its y and z in acc (K4)
  uint32_t bm;
  long long first;
  long long sfirst;
};

// The warp's segment indices seg, seg + stride, ... as the digits (fastest
// first) of a mixed radix (r0, r1, unbounded): one division per digit at
// the start, then each step adds the stride's digits with carries.
struct Digits {
  int v0, v1, v2, s0, s1, s2, r0, r1;

  __device__ __forceinline__ Digits(int seg, int stride, int radix0, int radix1)
      : r0(radix0), r1(radix1) {
    v0 = seg % r0, v1 = (seg / r0) % r1, v2 = seg / r0 / r1;
    s0 = stride % r0, s1 = (stride / r0) % r1, s2 = stride / r0 / r1;
  }

  __device__ __forceinline__ void advance() {
    v0 += s0;
    const int c0 = v0 >= r0;
    v0 -= c0 * r0;
    v1 += s1 + c0;
    const int c1 = v1 >= r1;
    v1 -= c1 * r1;
    v2 += s2 + c1;
  }
};

// Byte address of element ``off`` of t (an integer: off may lie before t
// for a window that starts left of the segment; only covered elements are
// read).
__device__ __forceinline__ uintptr_t address(const __nv_bfloat16* t, long long off) {
  return reinterpret_cast<uintptr_t>(t) + 2 * (uintptr_t)off;
}

// The voxels of the run that aligned chunk j of a row of EPC elements per
// chunk holds, the run starting s elements into chunk 0: v in [EPC j - s,
// EPC j - s + EPC) of [0, 32).
template <int EPC>
__device__ __forceinline__ uint32_t chunk_voxels(int j, int s) {
  constexpr uint32_t ONES = (1u << EPC) - 1u;
  const int lo = EPC * j - s;
  return lo >= 0 ? (lo < SEG ? ONES << lo : 0u) : ONES >> -lo;
}

// Issues the cp.async copies of a pass into ``stage`` (one commit group is
// the caller's): chunk i = lane + 32 m of (tensor, channel, chunk j), copied
// only where it holds a covered voxel (the others are never read unmasked).
// The blend weight is zero-filled where the window does not cover the voxel.
template <int NCM, int NK>
__device__ __forceinline__ void issue(const Pass& q, const __nv_bfloat16* z,
                                      const __nv_bfloat16* r, long long plane,
                                      const float* scale, int C, unsigned char* stage,
                                      int lane) {
  using CF = Cfg<NCM, NK>;
  if (q.seg < 0) return;
#pragma unroll
  for (int m = 0; m < CF::COPIES; ++m) {
    const int i = lane + 32 * m;
    const int t = i / (CF::ROWS * ROW_CHUNKS), rest = i - t * (CF::ROWS * ROW_CHUNKS);
    const int c = rest / ROW_CHUNKS, j = rest - c * ROW_CHUNKS;
    if (c < C) {
      const __nv_bfloat16* base = t ? r : z;
      const uintptr_t addr = address(base, c * plane + q.first);
      const int s = (int)((addr & 15u) >> 1);
      if (q.bm & chunk_voxels<8>(j, s))
        tc::cp_async16(tc::smem_u32(stage + ((t * CF::ROWS + c) * ROW_CHUNKS + j) * 16),
                       reinterpret_cast<const void*>((addr & ~(uintptr_t)15) + 16 * j));
    }
  }
  if (scale != nullptr) {
    const bool cov = (q.bm >> lane) & 1u;
    tc::cp_async4_zfill(tc::smem_u32(stage + CF::RAW_BYTES + 4 * lane),
                        cov ? scale + q.sfirst + lane : scale, cov ? 4 : 0);
  }
}

// The 8 elements from element s of the 16 in (lo, hi), those whose bit is
// clear in vm set to 0: for s != 0 a word shift by s / 2 (two conditional
// moves) and a half-word funnel shift when s is odd; the mask only where vm
// is not whole.
__device__ __forceinline__ uint4 align8(const uint4& lo, const uint4& hi, int s, uint32_t vm) {
  uint32_t r[4] = {lo.x, lo.y, lo.z, lo.w};
  if (s) {
    uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (s & 4) {
#pragma unroll
      for (int j = 0; j < 6; ++j) w[j] = w[j + 2];
    }
    if (s & 2) {
#pragma unroll
      for (int j = 0; j < 5; ++j) w[j] = w[j + 1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = (s & 1) ? __funnelshift_r(w[j], w[j + 1], 16) : w[j];
  }
  if (vm != 0xffu) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] &= ((0u - ((vm >> (2 * j)) & 1u)) & 0x0000ffffu) |
              ((0u - ((vm >> (2 * j + 1)) & 1u)) & 0xffff0000u);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// leaky(az*z + bz + ar*res + br) of 8 voxels of one channel, rounded to bf16.
__device__ __forceinline__ uint4 combine8(const uint4& z, const uint4& r, float az, float bz,
                                          float ar, float br) {
  return make_uint4(tc::combine_pair(z.x, r.x, az, bz, ar, br, az, bz, ar, br),
                    tc::combine_pair(z.y, r.y, az, bz, ar, br, az, bz, ar, br),
                    tc::combine_pair(z.z, r.z, az, bz, ar, br, az, bz, ar, br),
                    tc::combine_pair(z.w, r.w, az, bz, ar, br, az, bz, ar, br));
}

// A landed pass: its items combined into ``As``, the head's fp32 sums (no
// bias) in d[m16 tile][n8 tile], and the lane's voxel's blend weight (1
// without one). ``coef``: the (B, C) affines.
template <int NCM, int NK>
__device__ __forceinline__ void pass_head(const Pass& q, const __nv_bfloat16* z,
                                          const __nv_bfloat16* r, long long plane, bool scaled,
                                          const float* az, const float* bz, const float* ar,
                                          const float* br, int C, const unsigned char* stage,
                                          unsigned char* As, const Head<NCM, NK>& head, int lane,
                                          float (&d)[2][NK][4], float& sc) {
  using CF = Cfg<NCM, NK>;
#pragma unroll
  for (int k = 0; k < CF::ITEMS; ++k) {  // item (channel c, 8-voxel chunk u) = lane + 32 k
    const int i = lane + 32 * k, c = i >> 2, u = i & 3;
    if (c < C) {
      const uint32_t vm = (q.bm >> (8 * u)) & 0xffu;
      const int sz = (int)((address(z, c * plane + q.first) & 15u) >> 1);
      const int sr = (int)((address(r, c * plane + q.first) & 15u) >> 1);
      const uint4* rz = reinterpret_cast<const uint4*>(stage) + c * ROW_CHUNKS + u;
      const uint4* rr = reinterpret_cast<const uint4*>(stage) + (CF::ROWS + c) * ROW_CHUNKS + u;
      const int bc = q.b * C + c;
      *reinterpret_cast<uint4*>(As + tc::swz<64>(c, u)) =
          combine8(align8(rz[0], rz[1], sz, vm), align8(rr[0], rr[1], sr, vm), __ldg(az + bc),
                   __ldg(bz + bc), __ldg(ar + bc), __ldg(br + bc));
    }
  }
  sc = scaled ? reinterpret_cast<const float*>(stage + CF::RAW_BYTES)[lane] : 1.f;
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) d[mt][nt][0] = d[mt][nt][1] = d[mt][nt][2] = d[mt][nt][3] = 0.f;
    // ldmatrix.x4.trans: matrix j = lanes 8j..8j+7 point at channel rows
    // 16 ks + (lane & 7) + 8 (j >> 1) of voxel chunk 2 mt + (j & 1), which
    // gives a[j] of the row-major A (voxels x channels) fragment
    const int j = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < NCM; ++ks) {
      if (16 * ks < C) {
        uint32_t a[4];
        tc::ldsm_x4_trans(tc::smem_u32(As + tc::swz<64>(16 * ks + (lane & 7) + 8 * (j >> 1),
                                                        2 * mt + (j & 1))),
                          a);
#pragma unroll
        for (int nt = 0; nt < NK; ++nt) tc::mma_bf16(d[mt][nt], a, head.b[nt][ks][0], head.b[nt][ks][1]);
      }
    }
  }
}

// The exit's fp32 rows: class n of the segment's voxel v at E[n * EPI_PITCH
// + v]; the lane's fragment values are (voxel 16 mt + g (+ 8), class 8 nt +
// 2 t (+ 1)).
template <int NK>
__device__ __forceinline__ void stage_exit(float* E, const float (&v)[2][NK][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
      float* e = E + (8 * nt + 2 * t) * EPI_PITCH + 16 * mt + g;
      e[0] = v[mt][nt][0];
      e[EPI_PITCH] = v[mt][nt][1];
      e[8] = v[mt][nt][2];
      e[EPI_PITCH + 8] = v[mt][nt][3];
    }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p[e] = round(v[e]) to bf16 for the elements whose bit is set in vm.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8], uint32_t vm) {
  if (vm == 0xffu && aligned16(p)) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                              pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if ((vm >> e) & 1u) p[e] = __float2bfloat16(v[e]);
}

// The 8 fp32 values of class n, voxels 8 j .. 8 j + 7, of the exit's rows.
__device__ __forceinline__ void read_exit(const float* E, int n, int j, float (&v)[8]) {
  const float4* e = reinterpret_cast<const float4*>(E + n * EPI_PITCH + 8 * j);
  const float4 a = e[0], b = e[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

struct HeadTcArgs {
  const __nv_bfloat16* z;  // (B, C, V)
  const __nv_bfloat16* r;
  const float* az;  // (B, C)
  const float* bz;
  const float* ar;
  const float* br;
  const __nv_bfloat16* kout;  // (K, C)
  const float* bias;          // (K,)
  const float* scale;         // (B, 1, V) or null
  __nv_bfloat16* out;         // (B, K, V)
  int C, K;
  int V;
  int nvs;   // segments per batch element
  int nseg;  // B * nvs
};

// K3's passes: one per segment, the warp's segments in stride order.
struct HeadWalk {
  const HeadTcArgs& p;
  int seg, stride;
  Digits at;  // (run of the batch element, batch element)

  __device__ __forceinline__ HeadWalk(const HeadTcArgs& args, int first, int step)
      : p(args), seg(first), stride(step), at(first, step, args.nvs, 1 << 30) {}

  __device__ __forceinline__ Pass next() {
    Pass q{-1, 0, 0, 0, 0, 0u, 0, 0};
    if (seg < p.nseg) {
      const int b = at.v1, v0 = SEG * at.v0;
      const int n = p.V - v0 < SEG ? p.V - v0 : SEG;
      q = Pass{seg, b, v0, 0, 0, n == SEG ? FULL : (1u << n) - 1u,
               (long long)b * p.C * p.V + v0, (long long)b * p.V + v0};
      seg += stride;
      at.advance();
    }
    return q;
  }
};

// The loop of a warp: passes copied STAGES - 1 ahead of the one it
// computes; ``issued(pass)`` after the copies of the first pass of each
// segment are issued (in the same commit group), ``enter(pass)`` before that
// pass is computed, ``exit(pass, next pass, d, sc, E)`` after each pass.
template <int NCM, int NK, typename Walk, typename Issued, typename Enter, typename Exit>
__device__ __forceinline__ void run_passes(Walk& walk, const __nv_bfloat16* z,
                                           const __nv_bfloat16* r, long long plane,
                                           const float* scale, const float* az, const float* bz,
                                           const float* ar, const float* br, int C,
                                           const Head<NCM, NK>& head, unsigned char* ws,
                                           int lane, Issued&& issued, Enter&& enter,
                                           Exit&& exit) {
  using CF = Cfg<NCM, NK>;
  constexpr int S = CF::STAGES;
  unsigned char* As = ws + S * CF::STAGE_BYTES;
  Pass queue[S];
  int last = -1;  // the segment of the pass issued last
#pragma unroll
  for (int k = 0; k < S - 1; ++k) {
    queue[k] = walk.next();
    issue<NCM, NK>(queue[k], z, r, plane, scale, C, ws + k * CF::STAGE_BYTES, lane);
    if (queue[k].seg >= 0 && queue[k].seg != last) issued(queue[k]);
    last = queue[k].seg;
    tc::cp_async_commit();
  }
  for (int i = 0, seg = -1; queue[0].seg >= 0; ++i) {
    if (queue[0].seg != seg) enter(queue[0]);
    seg = queue[0].seg;
    tc::cp_async_wait<S - 2>();  // this lane's copies of pass i have landed
    __syncwarp();                // ... and every lane's; stage (i - 1) % S is read
    queue[S - 1] = walk.next();
    issue<NCM, NK>(queue[S - 1], z, r, plane, scale, C, ws + ((i + S - 1) % S) * CF::STAGE_BYTES,
                   lane);
    if (queue[S - 1].seg >= 0 && queue[S - 1].seg != last) issued(queue[S - 1]);
    last = queue[S - 1].seg;
    tc::cp_async_commit();  // one group per pass, empty once the walk ends
    float d[2][NK][4];
    float sc;
    pass_head<NCM, NK>(queue[0], z, r, plane, scale != nullptr, az, bz, ar, br, C,
                       ws + (i % S) * CF::STAGE_BYTES, As, head, lane, d, sc);
    __syncwarp();  // the pass's ldmatrix reads are done before an exit or the next staging
    exit(queue[0], queue[1], d, sc, reinterpret_cast<float*>(As));
#pragma unroll
    for (int k = 0; k < S - 1; ++k) queue[k] = queue[k + 1];
  }
  tc::cp_async_wait<0>();
}

template <int NCM, int NK>
__global__ void __launch_bounds__(NTHREADS) outhead_tc_kernel(const HeadTcArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  Head<NCM, NK> head;
  head.load(p.kout, p.bias, p.C, lane);
  HeadWalk walk(p, blockIdx.x * WARPS + warp, gridDim.x * WARPS);
  const int K = p.K;
  run_passes<NCM, NK>(
      walk, p.z, p.r, p.V, p.scale, p.az, p.bz, p.ar, p.br, p.C, head,
      smem + warp * Cfg<NCM, NK>::WARP_BYTES, lane, [](const Pass&) {}, [](const Pass&) {},
      [&](const Pass& q, const Pass&, float (&d)[2][NK][4], float sc, float* E) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float s0 = __shfl_sync(FULL, sc, 16 * mt + g);
          const float s1 = __shfl_sync(FULL, sc, 16 * mt + g + 8);
#pragma unroll
          for (int nt = 0; nt < NK; ++nt) {
            d[mt][nt][0] = __fmul_rn(__fadd_rn(d[mt][nt][0], head.bias[nt][0]), s0);
            d[mt][nt][1] = __fmul_rn(__fadd_rn(d[mt][nt][1], head.bias[nt][1]), s0);
            d[mt][nt][2] = __fmul_rn(__fadd_rn(d[mt][nt][2], head.bias[nt][0]), s1);
            d[mt][nt][3] = __fmul_rn(__fadd_rn(d[mt][nt][3], head.bias[nt][1]), s1);
          }
        }
        stage_exit<NK>(E, d, lane);
        __syncwarp();
#pragma unroll
        for (int m = 0; m < NK; ++m) {  // item (class, 8-voxel chunk): NK * 8 * 4 of them
          const int i = lane + 32 * m, cls = i >> 2, j = i & 3;
          const uint32_t vm = (q.bm >> (8 * j)) & 0xffu;
          if (vm) {
            float v[8];
            read_exit(E, cls, j, v);
            store8(p.out + ((long long)q.b * K + cls) * p.V + q.x0 + 8 * j, v, vm);
          }
        }
        __syncwarp();  // E is read before the next pass's staging
      });
}

struct RowTcArgs {
  const __nv_bfloat16* z;  // (B, C, rd, rh, rw)
  const __nv_bfloat16* r;
  const float* az;  // (B, C)
  const float* bz;
  const float* ar;
  const float* br;
  const __nv_bfloat16* kout;  // (K, C)
  const float* bias;          // (K,)
  const float* scale;         // (B, 1, rd, rh, rw)
  void* acc;                  // (K, Dp, Hp, Wp) fp32 or bf16
  int B, C, K;
  int rd, rh, rw;
  int Dp, Hp, Wp;
  int box0[3];  // bounding box of the batch's windows: origin and extent
  int box[3];
  int xa;       // x of the first segment of a row: box0[2] rounded down to 8
  int nsx;      // segments per box row
  int nseg;
  int starts[MAXB][3];
};

// K4's passes: per segment of the warp's, in stride order, the windows that
// cover it, in window order.
struct RowWalk {
  const RowTcArgs& p;
  int seg, stride, b;
  Digits at;  // (x-segment of the box row, box row y, box row z)

  __device__ __forceinline__ RowWalk(const RowTcArgs& args, int first, int step)
      : p(args), seg(first), stride(step), b(0), at(first, step, args.nsx, args.box[1]) {}

  __device__ __forceinline__ Pass next() {
    const long long V = (long long)p.rd * p.rh * p.rw;
    while (seg < p.nseg) {
      const int gx0 = p.xa + SEG * at.v0, gh = p.box0[1] + at.v1, gd = p.box0[0] + at.v2;
      for (; b < p.B; ++b) {
        const int ld = gd - p.starts[b][0], lh = gh - p.starts[b][1];
        const int lw0 = gx0 - p.starts[b][2];  // the segment's voxel 0 in the window's x
        const int lo = lw0 < 0 ? -lw0 : 0, hi = p.rw - lw0 < SEG ? p.rw - lw0 : SEG;
        if (ld < 0 || ld >= p.rd || lh < 0 || lh >= p.rh || lo >= hi) continue;
        const long long row = ((long long)ld * p.rh + lh) * p.rw + lw0;
        const uint32_t bm = (hi - lo == SEG ? FULL : (1u << (hi - lo)) - 1u) << lo;
        const Pass q{seg, b, gx0, gh, gd, bm, (long long)b * p.C * V + row, b * V + row};
        ++b;
        return q;
      }
      seg += stride;
      at.advance();
      b = 0;
    }
    return Pass{-1, 0, 0, 0, 0, 0u, 0, 0};
  }
};

template <int NCM, int NK, typename A>
__global__ void __launch_bounds__(NTHREADS) outhead_row_tc_kernel(const RowTcArgs p) {
  using CF = Cfg<NCM, NK, sizeof(A)>;
  constexpr int S = CF::STAGES, EPC = 16 / sizeof(A);  // accumulator values per 16-byte chunk
  constexpr int ACC_COPIES = (NK * 8 * CF::ACC_CHUNKS + 31) / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2;
  Head<NCM, NK> head;
  head.load(p.kout, p.bias, p.C, lane);
  RowWalk walk(p, blockIdx.x * WARPS + warp, gridDim.x * WARPS);
  const long long VA = (long long)p.Dp * p.Hp * p.Wp;
  A* acc = static_cast<A*>(p.acc);
  unsigned char* ws = smem + warp * CF::WARP_BYTES;
  unsigned char* slots = ws + S * CF::STAGE_BYTES + CF::AE_BYTES;
  float sum[2][NK][4];  // the segment's windows, summed in window order
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) sum[mt][nt][0] = sum[mt][nt][1] = sum[mt][nt][2] = sum[mt][nt][3] = 0.f;
  uint32_t cov = 0;  // bit v: some window covers voxel v of the segment
  int n_issued = 0, n_entered = 0;  // segments whose accumulator rows were copied, entered
  const unsigned char* slot = slots;  // the entered segment's
  long long row_a = 0;                // its voxel 0 in a class plane of acc
  run_passes<NCM, NK>(
      walk, p.z, p.r, (long long)p.rd * p.rh * p.rw, p.scale, p.az, p.bz, p.ar, p.br, p.C, head,
      ws, lane,
      [&](const Pass& q) {
        // the segment's accumulator rows, every class, copied with its first
        // pass: the chunks holding a voxel of the row (x < Wp); the slot
        // ring holds as many segments as can be open at once, one per stage
        unsigned char* dst = slots + (n_issued++ % S) * CF::SLOT_BYTES;
        const long long row = ((long long)q.z0 * p.Hp + q.y0) * p.Wp + q.x0;
        const int n_in = p.Wp - q.x0 < SEG ? p.Wp - q.x0 : SEG;
        const uint32_t in_row = n_in == SEG ? FULL : (1u << n_in) - 1u;
#pragma unroll
        for (int m = 0; m < ACC_COPIES; ++m) {
          const int i = lane + 32 * m, cls = i / CF::ACC_CHUNKS, j = i - cls * CF::ACC_CHUNKS;
          if (cls < 8 * NK) {
            const uintptr_t addr = reinterpret_cast<uintptr_t>(acc + cls * VA + row);
            const int s = (int)((addr & 15u) / sizeof(A));
            if (in_row & chunk_voxels<EPC>(j, s))
              tc::cp_async16(tc::smem_u32(dst + (cls * CF::ACC_CHUNKS + j) * 16),
                             reinterpret_cast<const void*>((addr & ~(uintptr_t)15) + 16 * j));
          }
        }
      },
      [&](const Pass& q) {
        slot = slots + (n_entered++ % S) * CF::SLOT_BYTES;
        row_a = ((long long)q.z0 * p.Hp + q.y0) * p.Wp + q.x0;
      },
      [&](const Pass& q, const Pass& next, float (&d)[2][NK][4], float sc, float* E) {
        cov |= q.bm;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int v0 = 16 * mt + g, v1 = v0 + 8;
          const float s0 = __shfl_sync(FULL, sc, v0), s1 = __shfl_sync(FULL, sc, v1);
          const bool c0 = (q.bm >> v0) & 1u, c1 = (q.bm >> v1) & 1u;
#pragma unroll
          for (int nt = 0; nt < NK; ++nt) {
            if (c0) {
              sum[mt][nt][0] = __fadd_rn(sum[mt][nt][0], __fmul_rn(__fadd_rn(d[mt][nt][0], head.bias[nt][0]), s0));
              sum[mt][nt][1] = __fadd_rn(sum[mt][nt][1], __fmul_rn(__fadd_rn(d[mt][nt][1], head.bias[nt][1]), s0));
            }
            if (c1) {
              sum[mt][nt][2] = __fadd_rn(sum[mt][nt][2], __fmul_rn(__fadd_rn(d[mt][nt][2], head.bias[nt][0]), s1));
              sum[mt][nt][3] = __fadd_rn(sum[mt][nt][3], __fmul_rn(__fadd_rn(d[mt][nt][3], head.bias[nt][1]), s1));
            }
          }
        }
        if (next.seg == q.seg) return;  // the segment's next window follows
        stage_exit<NK>(E, sum, lane);
        __syncwarp();
        // one voxel per lane, all classes: its accumulator value from the
        // slot (the run starts s values into its first chunk), one rounding,
        // one write; a warp's write is 32 consecutive values of a class plane
        if ((cov >> lane) & 1u) {
#pragma unroll
          for (int cls = 0; cls < 8 * NK; ++cls) {
            A* dst = acc + cls * VA + row_a;
            const int s = (int)((reinterpret_cast<uintptr_t>(dst) & 15u) / sizeof(A));
            const A old = reinterpret_cast<const A*>(slot + cls * CF::ACC_CHUNKS * 16)[s + lane];
            dst[lane] = from_float<A>(__fadd_rn(to_float<A>(old), E[cls * EPI_PITCH + lane]));
          }
        }
        __syncwarp();  // E and the slot are read before the next pass's staging
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NK; ++nt) sum[mt][nt][0] = sum[mt][nt][1] = sum[mt][nt][2] = sum[mt][nt][3] = 0.f;
        cov = 0;
      });
}

// As many blocks as fit the SMs (at most one warp per segment), after
// allowing the kernel its dynamic shared memory.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int device, int smem, int nseg, int& blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (e != cudaSuccess) return e;
  const int want = (nseg + WARPS - 1) / WARPS, fit = (per_sm > 0 ? per_sm : 1) * sms;
  blocks = want < fit ? want : fit;
  if (blocks < 1) blocks = 1;
  return cudaSuccess;
}

template <int NCM, int NK>
cudaError_t launch_head(const HeadTcArgs& p, int device, cudaStream_t st) {
  constexpr int smem = Cfg<NCM, NK>::BLOCK_BYTES;
  int blocks = 0;
  cudaError_t e = persistent_grid(outhead_tc_kernel<NCM, NK>, device, smem, p.nseg, blocks);
  if (e != cudaSuccess) return e;
  outhead_tc_kernel<NCM, NK><<<blocks, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int NCM, int NK, typename A>
cudaError_t launch_row(const RowTcArgs& p, int device, cudaStream_t st) {
  constexpr int smem = Cfg<NCM, NK, sizeof(A)>::BLOCK_BYTES;
  int blocks = 0;
  cudaError_t e = persistent_grid(outhead_row_tc_kernel<NCM, NK, A>, device, smem, p.nseg, blocks);
  if (e != cudaSuccess) return e;
  outhead_row_tc_kernel<NCM, NK, A><<<blocks, NTHREADS, smem, st>>>(p);
  return cudaGetLastError();
}

// the instantiated widths: C in 16-channel slices (NCM slots; K3 up to 64,
// K4 up to 32, the routed feature sizes), K_pad = 8 * NK
template <int NCM>
cudaError_t dispatch_head_k(const HeadTcArgs& p, int device, cudaStream_t st) {
  switch (p.K) {
    case 8: return launch_head<NCM, 1>(p, device, st);
    case 16: return launch_head<NCM, 2>(p, device, st);
    case 32: return launch_head<NCM, 4>(p, device, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int NCM, typename A>
cudaError_t dispatch_row_k(const RowTcArgs& p, int device, cudaStream_t st) {
  switch (p.K) {
    case 8: return launch_row<NCM, 1, A>(p, device, st);
    case 16: return launch_row<NCM, 2, A>(p, device, st);
    case 32: return launch_row<NCM, 4, A>(p, device, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename A>
cudaError_t dispatch_row(const RowTcArgs& p, int device, cudaStream_t st) {
  if (p.C == 16) return dispatch_row_k<1, A>(p, device, st);
  if (p.C == 32) return dispatch_row_k<2, A>(p, device, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace medseg

extern "C" {

// K3 on the tensor cores. Returns a cudaError_t value: 0 when the kernel was
// launched. z, res, kout and the logits are bfloat16; scale may be null.
int medseg_outhead_tc(int device, const void* z, const void* r, const float* az, const float* bz,
                      const float* ar, const float* br, const void* kout, const float* bias,
                      const float* scale, void* out, int B, int C, int K, long long V,
                      void* stream) {
  const long long nvs = (V + medseg::SEG - 1) / medseg::SEG;  // segments are counted in int
  if (B < 1 || C < 16 || C > 64 || C % 16 || V < 1 || (long long)B * nvs > INT_MAX - (1 << 20))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  using bf = __nv_bfloat16;
  medseg::HeadTcArgs p{};
  p.z = static_cast<const bf*>(z);
  p.r = static_cast<const bf*>(r);
  p.az = az;
  p.bz = bz;
  p.ar = ar;
  p.br = br;
  p.kout = static_cast<const bf*>(kout);
  p.bias = bias;
  p.scale = scale;
  p.out = static_cast<bf*>(out);
  p.C = C;
  p.K = K;
  p.V = (int)V;
  p.nvs = (int)nvs;
  p.nseg = B * p.nvs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 16) e = medseg::dispatch_head_k<1>(p, device, st);
  else if (C == 32) e = medseg::dispatch_head_k<2>(p, device, st);
  else e = medseg::dispatch_head_k<4>(p, device, st);  // 48 and 64
  return (int)e;
}

// K4 on the tensor cores. Returns a cudaError_t value: 0 when the kernel was
// launched. z, res and kout are bfloat16, acc fp32 (acc_bf16 == 0) or
// bfloat16. starts: B host triples (d, h, w), each window inside acc;
// box0/box: the windows' bounding box.
int medseg_outhead_row_tc(int device, int acc_bf16, const void* z, const void* r,
                          const float* az, const float* bz, const float* ar, const float* br,
                          const void* kout, const float* bias, const float* scale, void* acc,
                          int B, int C, int K, int rd, int rh, int rw, int Dp, int Hp, int Wp,
                          const int* starts, const int* box0, const int* box, void* stream) {
  const int xa = box0[2] - (box0[2] & 7);
  const int nsx = (box0[2] + box[2] - xa + medseg::SEG - 1) / medseg::SEG;
  const long long nseg = (long long)box[0] * box[1] * nsx;  // segments are counted in int
  if (B < 1 || B > medseg::MAXB || nseg > INT_MAX - (1 << 20)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  using bf = __nv_bfloat16;
  medseg::RowTcArgs p{};
  p.z = static_cast<const bf*>(z);
  p.r = static_cast<const bf*>(r);
  p.az = az;
  p.bz = bz;
  p.ar = ar;
  p.br = br;
  p.kout = static_cast<const bf*>(kout);
  p.bias = bias;
  p.scale = scale;
  p.acc = acc;
  p.B = B;
  p.C = C;
  p.K = K;
  p.rd = rd;
  p.rh = rh;
  p.rw = rw;
  p.Dp = Dp;
  p.Hp = Hp;
  p.Wp = Wp;
  for (int i = 0; i < 3; ++i) {
    p.box0[i] = box0[i];
    p.box[i] = box[i];
  }
  for (int b = 0; b < B; ++b)
    for (int i = 0; i < 3; ++i) p.starts[b][i] = starts[3 * b + i];
  p.xa = xa;
  p.nsx = nsx;
  p.nseg = (int)nseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = acc_bf16 ? medseg::dispatch_row<bf>(p, device, st)
               : medseg::dispatch_row<float>(p, device, st);
  return (int)e;
}

}  // extern "C"
