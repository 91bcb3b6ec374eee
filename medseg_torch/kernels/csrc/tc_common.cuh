// Building blocks of the tensor-core conv kernels (conv_tc.cu, wgrad_tc.cu):
// channels-last bf16 staging of an NCDHW box in shared memory (through
// registers, with the AFFINE and COMBINE prologues, or from a box that
// cp.async landed channel-major), its swizzle, and the PTX of ldmatrix,
// mma.sync m16n8k16 (bf16 in, fp32 sums) and cp.async (with zero fill).
//
// Staging. A box of voxels is held in shared memory as rows of CH bf16
// channels (CH * 2 bytes, a multiple of 32), one row per voxel, voxels in
// (z, y, x) order. A row of 16 channels is one k-slice of an m16n8k16 step,
// so a tap's shifted voxel row is a whole-row offset and every 8-channel
// chunk is 16-byte aligned for ldmatrix (NCDHW rows shifted by one voxel
// are not). ldmatrix reads 8 rows of one 16-byte chunk at a time; at a row
// stride of 32 or 64 bytes those rows would share banks, so chunk c of row v
// is stored at chunk c ^ f(v & 7) (``swz``): any 8 consecutive rows then hit
// 8 distinct 16-byte bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace medseg {
namespace tc {

// Byte offset of 16-byte chunk c of row v, rows of ROW_BYTES bytes.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swz(int v, int c) {
  static_assert(ROW_BYTES == 32 || ROW_BYTES == 64 || ROW_BYTES == 128, "32, 64 or 128 B rows");
  constexpr int SHIFT = ROW_BYTES == 32 ? 2 : (ROW_BYTES == 64 ? 1 : 0);
  return (uint32_t)(v * ROW_BYTES + ((c ^ ((v & 7) >> SHIFT)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// cp.async of ``bytes`` (16; 4 for the .ca form) with zero fill: the
// remaining bytes of the destination are written 0 (src_bytes 0: all of them,
// ``src`` not read).
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// Waits until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// leaky(a * v + b) of both bf16 halves of w, rounded back to bf16 (the
// AFFINE prologue, applied once per staged value).
__device__ __forceinline__ uint32_t affine_pair(uint32_t w, float a0, float b0, float a1,
                                                float b1) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(leaky(lo * a0 + b0), leaky(hi * a1 + b1));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// leaky(ay * y + by + ax * x + bx) of both bf16 halves of y and x (channels
// 0 and 1 of the coefficients), rounded back to bf16 (the COMBINE prologue,
// applied once per staged value).
__device__ __forceinline__ uint32_t combine_pair(uint32_t y, uint32_t x, float ay0, float by0,
                                                 float ax0, float bx0, float ay1, float by1,
                                                 float ax1, float bx1) {
  const float ylo = __uint_as_float(y << 16), yhi = __uint_as_float(y & 0xffff0000u);
  const float xlo = __uint_as_float(x << 16), xhi = __uint_as_float(x & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(leaky(ylo * ay0 + by0 + xlo * ax0 + bx0),
                                                 leaky(yhi * ay1 + by1 + xhi * ax1 + bx1));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Stages the NCDHW box [z0, z0+BZ) x [y0, y0+BY) x [x0, x0+BX) of CH
// channels channels-last in shared memory, in two steps so that a caller
// can overlap the global loads with its MMAs: ``load`` issues the loads into
// registers, ``store`` (optionally applying the AFFINE prologue) or
// ``store_combine`` (the COMBINE prologue) writes the swizzled rows. The box
// may reach outside the volume (a halo): those voxels are staged as 0, in
// the transformed space. One item is one 8-channel chunk of one voxel;
// neighbouring threads take neighbouring voxels, so each of the 8 loads of
// an item is coalesced along x.
template <int BZ, int BY, int BX, int CH, int NT>
struct BoxStage {
  static constexpr int NVOX = BZ * BY * BX;
  static constexpr int CHUNKS = CH / 8;
  static constexpr int ITEMS = NVOX * CHUNKS;
  static constexpr int PER = (ITEMS + NT - 1) / NT;
  static constexpr int BYTES = NVOX * CH * 2;
  static_assert(CH % 16 == 0 && PER <= 32, "rows of 16-channel multiples, a 32-bit valid mask");

  uint4 raw[PER];
  uint4 xraw[PER];     // COMBINE, x of the same channels: its values at the same items
  uint32_t xone[PER];  // COMBINE, x of one channel: its value at each item's voxel
  uint32_t valid;      // bit k: item k lies inside the volume

  __device__ __forceinline__ static uint4 pack(const uint32_t (&h)[8]) {
    return make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                      h[6] | (h[7] << 16));
  }

  // x: channel 0 of the box's (b, c0) in an NCDHW tensor; V = D * H * W.
  // Every item's 8 loads are issued without a branch (an item outside the
  // volume reads channel 0..7 of voxel 0 of the box's plane, a valid
  // address, and is masked to 0 afterwards), so that all PER * 8 loads can
  // be in flight together. XS: COMBINE's x stream, loaded beside at the same
  // items: 0 none; 8 the same 8 channels of ``xs`` (the x tensor at the
  // box's channel 0) into ``xraw``; 1 its one channel (``xs``: the x tensor
  // at its channel 0) into ``xone``, one load per item, broadcast to all 8
  // channels by the prologue.
  template <int XS = 0>
  __device__ __forceinline__ void load(const __nv_bfloat16* x, long long V, int D, int H, int W,
                                       int z0, int y0, int x0,
                                       const __nv_bfloat16* xs = nullptr) {
    static_assert(XS == 0 || XS == 1 || XS == 8, "x stream: none, one channel or 8 channels");
    const unsigned short* src = reinterpret_cast<const unsigned short*>(x);
    const unsigned short* xsrc = reinterpret_cast<const unsigned short*>(xs);
    const unsigned short* q[PER];
    const unsigned short* xq[PER];
    valid = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      const int c = i / NVOX, v = i - c * NVOX;
      const int vz = v / (BY * BX), r = v - vz * (BY * BX);
      const int vy = r / BX, vx = r - vy * BX;
      const int gz = z0 + vz, gy = y0 + vy, gx = x0 + vx;
      const bool ok =
          i < ITEMS && gz >= 0 && gz < D && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const long long vox = ((long long)gz * H + gy) * W + gx;
      q[k] = ok ? src + (long long)c * 8 * V + vox : src;
      if constexpr (XS != 0)
        xq[k] = ok ? xsrc + (XS == 8 ? (long long)c * 8 * V : 0LL) + vox : xsrc;
      valid |= ok ? 1u << k : 0u;
    }
    uint32_t h[PER][8];
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) h[k][j] = __ldg(q[k] + j * V);
    if constexpr (XS == 8) {
      uint32_t g[PER][8];
#pragma unroll
      for (int k = 0; k < PER; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[k][j] = __ldg(xq[k] + j * V);
#pragma unroll
      for (int k = 0; k < PER; ++k) xraw[k] = pack(g[k]);
    }
    if constexpr (XS == 1) {
#pragma unroll
      for (int k = 0; k < PER; ++k) xone[k] = __ldg(xq[k]);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      raw[k] = pack(h[k]);
      if (!(valid & (1u << k))) raw[k] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // a, b: the box's CH per-channel prologue coefficients (AFFINE only;
  // 16-byte aligned: the caller's (B, C) rows start at a multiple of 16).
  template <bool AFFINE>
  __device__ __forceinline__ void store(unsigned char* dst, const float* a, const float* b) const {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < ITEMS) {
        const int c = i / NVOX, v = i - c * NVOX;
        uint4 w = raw[k];
        if constexpr (AFFINE) {
          if (valid & (1u << k)) {  // the chunk's 8 (a, b) pairs in four 16-byte loads
            const float4* ac = reinterpret_cast<const float4*>(a + c * 8);
            const float4* bc = reinterpret_cast<const float4*>(b + c * 8);
            const float4 a0 = __ldg(ac), a1 = __ldg(ac + 1), b0 = __ldg(bc), b1 = __ldg(bc + 1);
            w.x = affine_pair(w.x, a0.x, b0.x, a0.y, b0.y);
            w.y = affine_pair(w.y, a0.z, b0.z, a0.w, b0.w);
            w.z = affine_pair(w.z, a1.x, b1.x, a1.y, b1.y);
            w.w = affine_pair(w.w, a1.z, b1.z, a1.w, b1.w);
          }
        }
        *reinterpret_cast<uint4*>(dst + swz<CH * 2>(v, c)) = w;
      }
    }
  }

  // COMBINE: leaky(ay * y + by + ax * x + bx) of the loaded values (y) and
  // the x stream's (``load<XS>``, XS 1 or 8), per channel coefficients as in
  // ``store``. Items outside the volume stay 0: the mask comes before the
  // prologue, whose value at y = x = 0 is not 0.
  template <int XS>
  __device__ __forceinline__ void store_combine(unsigned char* dst, const float* ay,
                                                const float* by, const float* ax,
                                                const float* bx) const {
    static_assert(XS == 1 || XS == 8, "x stream: one channel or 8 channels");
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < ITEMS) {
        const int c = i / NVOX, v = i - c * NVOX;
        uint4 w = raw[k];
        if (valid & (1u << k)) {
          uint4 xv;
          if constexpr (XS == 1) {  // both bf16 halves of each word: x's one channel
            const uint32_t x2 = xone[k] | (xone[k] << 16);
            xv = make_uint4(x2, x2, x2, x2);
          } else {
            xv = xraw[k];
          }
          float4 ya[2], yb[2], xa[2], xb[2];  // the chunk's 8 channels, four at a time
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            ya[q] = __ldg(reinterpret_cast<const float4*>(ay + c * 8) + q);
            yb[q] = __ldg(reinterpret_cast<const float4*>(by + c * 8) + q);
            xa[q] = __ldg(reinterpret_cast<const float4*>(ax + c * 8) + q);
            xb[q] = __ldg(reinterpret_cast<const float4*>(bx + c * 8) + q);
          }
          w.x = combine_pair(w.x, xv.x, ya[0].x, yb[0].x, xa[0].x, xb[0].x, ya[0].y, yb[0].y,
                             xa[0].y, xb[0].y);
          w.y = combine_pair(w.y, xv.y, ya[0].z, yb[0].z, xa[0].z, xb[0].z, ya[0].w, yb[0].w,
                             xa[0].w, xb[0].w);
          w.z = combine_pair(w.z, xv.z, ya[1].x, yb[1].x, xa[1].x, xb[1].x, ya[1].y, yb[1].y,
                             xa[1].y, xb[1].y);
          w.w = combine_pair(w.w, xv.w, ya[1].z, yb[1].z, xa[1].z, xb[1].z, ya[1].w, yb[1].w,
                             xa[1].w, xb[1].w);
        }
        *reinterpret_cast<uint4*>(dst + swz<CH * 2>(v, c)) = w;
      }
    }
  }
};

// The channels-last rows of a box staged channel-major by cp.async
// (conv_tc.cu's asynchronous staging): ``box`` holds, per channel c of 16
// and z-y row zy of BZ x BY, a row of PITCH bf16 in which voxel vx of the
// BX staged (x = the box's x origin + vx) sits at element OFF + vx (OFF odd;
// the row may spill into the next one's first elements). ``dst`` gets BZ *
// BY * BX swizzled rows of 16 channels, as BoxStage lays them out. Item p of
// (8-channel chunk, zy) reads the 32-bit word of each of its 8 channels that
// holds voxels 2p - 1 (low half) and 2p (high half): 8 loads, two 16-byte
// stores (one at the ends). Nothing stays in registers past the item.
template <int BZ, int BY, int BX, int PITCH, int OFF, int NT>
__device__ __forceinline__ void box_to_rows(const unsigned char* box, unsigned char* dst, int tid) {
  static_assert(BX % 2 == 0 && PITCH % 2 == 0 && OFF % 2 == 1, "voxel pairs across words");
  constexpr int WORDS = BX / 2 + 1, ROWS = BZ * BY;
  constexpr int ITEMS = 2 * ROWS * WORDS;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(box);
#pragma unroll
  for (int k = 0; k < (ITEMS + NT - 1) / NT; ++k) {
    const int i = tid + k * NT;
    if (i < ITEMS) {
      const int c = i / (ROWS * WORDS), r = i - c * (ROWS * WORDS);
      const int zy = r / WORDS, p = r - zy * WORDS;
      uint32_t w[8];  // channel 8c + j at voxels 2p - 1 (low half) and 2p (high half)
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = src[((8 * c + j) * ROWS + zy) * (PITCH / 2) + OFF / 2 + p];
      const int v = zy * BX + 2 * p;
      if (p > 0) {
        const uint4 lo = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                                    __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
        *reinterpret_cast<uint4*>(dst + swz<32>(v - 1, c)) = lo;
      }
      if (p < BX / 2) {
        const uint4 hi = make_uint4(__byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
                                    __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
        *reinterpret_cast<uint4*>(dst + swz<32>(v, c)) = hi;
      }
    }
  }
}

}  // namespace tc
}  // namespace medseg
