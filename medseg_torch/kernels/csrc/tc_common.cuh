// Building blocks of the tensor-core conv kernels (conv_tc.cu, wgrad_tc.cu):
// channels-last bf16 staging of an NCDHW box in shared memory, its swizzle,
// and the PTX of ldmatrix, mma.sync m16n8k16 (bf16 in, fp32 sums) and
// cp.async.
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

// leaky(a * v + b) of both bf16 halves of w, rounded back to bf16 (the
// AFFINE prologue, applied once per staged value).
__device__ __forceinline__ uint32_t affine_pair(uint32_t w, float a0, float b0, float a1,
                                                float b1) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xffff0000u);
  const __nv_bfloat162 r = __floats2bfloat162_rn(leaky(lo * a0 + b0), leaky(hi * a1 + b1));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Stages the NCDHW box [z0, z0+BZ) x [y0, y0+BY) x [x0, x0+BX) of CH
// channels channels-last in shared memory, in two steps so that a caller
// can overlap the global loads with its MMAs: ``load`` issues the loads into
// registers, ``store`` (optionally applying the AFFINE prologue) writes the
// swizzled rows. The box may reach outside the volume (a halo): those
// voxels are staged as 0, in the transformed space. One item is one 8-channel
// chunk of one voxel; neighbouring threads take neighbouring voxels, so each
// of the 8 loads of an item is coalesced along x.
template <int BZ, int BY, int BX, int CH, int NT>
struct BoxStage {
  static constexpr int NVOX = BZ * BY * BX;
  static constexpr int CHUNKS = CH / 8;
  static constexpr int ITEMS = NVOX * CHUNKS;
  static constexpr int PER = (ITEMS + NT - 1) / NT;
  static constexpr int BYTES = NVOX * CH * 2;
  static_assert(CH % 16 == 0 && PER <= 32, "rows of 16-channel multiples, a 32-bit valid mask");

  uint4 raw[PER];
  uint32_t valid;  // bit k: item k lies inside the volume

  // x: channel 0 of the box's (b, c0) in an NCDHW tensor; V = D * H * W.
  // Every item's 8 loads are issued without a branch (an item outside the
  // volume reads channel 0..7 of voxel 0 of the box's plane, a valid
  // address, and is masked to 0 afterwards), so that all PER * 8 loads can
  // be in flight together.
  __device__ __forceinline__ void load(const __nv_bfloat16* x, long long V, int D, int H, int W,
                                       int z0, int y0, int x0) {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(x);
    const unsigned short* q[PER];
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
      q[k] = ok ? src + (long long)c * 8 * V + ((long long)gz * H + gy) * W + gx : src;
      valid |= ok ? 1u << k : 0u;
    }
    uint32_t h[PER][8];
#pragma unroll
    for (int k = 0; k < PER; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) h[k][j] = __ldg(q[k] + j * V);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      raw[k] = make_uint4(h[k][0] | (h[k][1] << 16), h[k][2] | (h[k][3] << 16),
                          h[k][4] | (h[k][5] << 16), h[k][6] | (h[k][7] << 16));
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
};

}  // namespace tc
}  // namespace medseg
