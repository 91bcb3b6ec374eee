// The fused DiceCE pair of the CT training loss (softmax over the classes,
// one-hot target from int32 labels), class-major NCDHW logits (B, K, V),
// fp32 or bf16, fp32 math.
//
// Replaces the TPU kernels of medseg/kernels/loss_of.py:
//   - dice_ce_sums (K7, _sums / _loss_fwd_kernel): per voxel a softmax over
//     the K classes and the one-hot of the label; per (b, k) the sums
//     I = sum p*g, P = sum p, G = sum g, and per b the CE sum
//     sum -log p[label]. The scalar loss is assembled from these few numbers
//     on the host side of the autograd Function.
//   - dice_ce_bwd (K8, _bwd / _loss_bwd_kernel): dlogits in one read and one
//     write, the softmax recomputed:
//       u_k  = ca[b,k]*g_k + cb[b,k]          (the dice quotient's dL/dp)
//       dl_k = cec[b]*(p_k - g_k) + p_k*(u_k - sum_j p_j*u_j)
//
// What bounds them on the H100: device memory. Per voxel K7 reads K logits
// and one label (28 + 4 B in bf16 at K = 14) and K8 also writes K dlogits;
// about 10 operations and one exp per class are far below the card's
// balance, but at 3.35 TB/s an SM has only ~2 clocks per voxel of K7, so the
// instructions per voxel count too. The design:
//   - 16-byte accesses: a thread takes a group of VEC consecutive voxels
//     (8 in bf16, 4 in fp32) and loads the group's 16-byte word of each class
//     plane and its labels as int4, all before any arithmetic, so that
//     (K + 2) * 16 B per thread are in flight; K8 writes its dlogits back
//     into the same registers and stores them as 16-byte words. The words
//     are all aligned when V % VEC == 0 and the tensors start on 16 bytes
//     (the wrapper's vec); otherwise (a ragged V) the same kernel takes a
//     scalar route, one voxel per unit, over every voxel.
//   - Registers sized by K: K is a template argument for the class counts
//     the callers route (14, 2) and one generic instantiation holds up to
//     16 classes.
//   - Arithmetic: exp2 of log2e-scaled logits and log2 (ex2/lg2.approx), one
//     reciprocal of z per voxel; p[label] and ca[label] are looked up, not
//     selected per class.
//   - Fewer accumulators: P and CE stay in registers; I and G are keyed by
//     the label and go into the thread's own column of shared memory (one
//     read-modify-write per voxel, no atomics).
//   - A fixed-order reduction: a block reduces its columns and registers in
//     a fixed order and writes its 3K + 1 partial sums to scratch; a second
//     small kernel adds the blocks' partials in block order. The sums are
//     bitwise reproducible from run to run, and nothing needs zeroing.
//   - The grid is a grid-stride walk over the groups of one batch element
//     (blockIdx.y), sized by the wrapper once per shape from the occupancy
//     of the instantiation (medseg_dice_ce_grid).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int LMAXK = 16;  // classes of the generic instantiation
constexpr int LTHREADS = 256;
constexpr int LWARPS = LTHREADS / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t word_of(const uint4& r, int w) {
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

__device__ __forceinline__ void set_word(uint4& r, int w, uint32_t v) {
  if (w == 0) r.x = v;
  else if (w == 1) r.y = v;
  else if (w == 2) r.z = v;
  else r.w = v;
}

// How a 32-bit word holds the compute dtype: PW voxels.
template <typename T>
struct Words;
template <>
struct Words<float> {
  static constexpr int PW = 1;
  static __device__ __forceinline__ float get(uint32_t w, int) { return __uint_as_float(w); }
  static __device__ __forceinline__ uint32_t put(const float* v) { return __float_as_uint(v[0]); }
};
template <>
struct Words<__nv_bfloat16> {
  static constexpr int PW = 2;
  static __device__ __forceinline__ float get(uint32_t w, int s) {
    return __uint_as_float(s == 0 ? w << 16 : w & 0xffff0000u);
  }
  static __device__ __forceinline__ uint32_t put(const float* v) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);  // round to nearest even
    return *reinterpret_cast<uint32_t*>(&h);
  }
};

// One voxel's softmax: l[k] (the logits, overwritten by e_k = exp(l_k - m)),
// y its label. Returns 1/z, with m, mz = m*log2e and l_y.
template <int KR, int KT>
__device__ __forceinline__ float softmax_exp(float (&l)[KR], int K, int y, float& m, float& mz,
                                             float& ly, float& z) {
  m = l[0];
  ly = 0.f;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (KT || k < K) {
      m = fmaxf(m, l[k]);
      ly = k == y ? l[k] : ly;
    }
  }
  mz = m * kLog2e;
  z = 0.f;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (KT || k < K) {
      l[k] = ex2(fmaf(l[k], kLog2e, -mz));
      z += l[k];
    }
  }
  return __fdividef(1.f, z);
}

// K7: per block, partial[b][blockIdx.x][0..3K] = I (K), P (K), G (K), CE.
template <typename T, int KT>
__global__ void __launch_bounds__(LTHREADS, 2)
    dice_ce_sums_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                        float* __restrict__ partial, int K_rt, long long V, int vec) {
  constexpr int KR = KT ? KT : LMAXK;
  constexpr int PW = Words<T>::PW;
  constexpr int VEC = 4 * PW;  // voxels per 16-byte word
  const int K = KT ? KT : K_rt;
  __shared__ float2 s_ig[KR][LTHREADS];  // each thread's own column: (I, G) by label
  __shared__ float s_w[LWARPS][KR + 1];  // each warp's P and CE
  const int tid = threadIdx.x, b = blockIdx.y;
  const T* lg = logits + (long long)b * K * V;
  const int* lab = labels + (long long)b * V;
#pragma unroll
  for (int k = 0; k < KR; ++k) s_ig[k][tid] = make_float2(0.f, 0.f);
  float sp[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) sp[k] = 0.f;
  float sce = 0.f;

  auto voxel = [&](float (&l)[KR], int y) {
    float m, mz, ly, z;
    const float rz = softmax_exp<KR, KT>(l, K, y, m, mz, ly, z);
#pragma unroll
    for (int k = 0; k < KR; ++k)
      if (KT || k < K) sp[k] = fmaf(l[k], rz, sp[k]);
    sce += fmaf(lg2(z), kLn2, m - ly);  // -log p[label] = log z + m - l_y
    if ((unsigned)y < (unsigned)K) {
      float2 c = s_ig[y][tid];
      c.x += ex2(fmaf(ly, kLog2e, -mz)) * rz;
      c.y += 1.f;
      s_ig[y][tid] = c;
    }
  };

  const long long units = vec ? V / VEC : V;
  const long long stride = (long long)gridDim.x * LTHREADS;
  for (long long u = (long long)blockIdx.x * LTHREADS + tid; u < units; u += stride) {
    if (vec) {
      uint4 raw[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k)
        if (KT || k < K) raw[k] = __ldcs(reinterpret_cast<const uint4*>(lg + k * V) + u);
      int y[VEC];
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const int4 t = __ldcs(reinterpret_cast<const int4*>(lab) + u * (VEC / 4) + i);
        y[4 * i] = t.x;
        y[4 * i + 1] = t.y;
        y[4 * i + 2] = t.z;
        y[4 * i + 3] = t.w;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
#pragma unroll
        for (int s = 0; s < PW; ++s) {
          float l[KR];
#pragma unroll
          for (int k = 0; k < KR; ++k)
            if (KT || k < K) l[k] = Words<T>::get(word_of(raw[k], w), s);
          voxel(l, y[w * PW + s]);
        }
      }
    } else {
      const int y = lab[u];
      float l[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k)
        if (KT || k < K) l[k] = to_float<T>(lg[k * V + u]);
      voxel(l, y);
    }
  }

  // P and CE: a warp's lanes by xor shuffles, then the warps in order
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (KT || k < K) {
      const float v = warp_sum(sp[k]);
      if (lane == 0) s_w[warp][k] = v;
    }
  }
  const float e = warp_sum(sce);
  if (lane == 0) s_w[warp][KR] = e;
  __syncthreads();
  float* out = partial + ((long long)b * gridDim.x + blockIdx.x) * (3 * K + 1);
  // I and G: a warp per row, each lane its 8 columns in order, then the lanes
  for (int j = warp; j < 2 * K; j += LWARPS) {
    const int k = j % K;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < LTHREADS / 32; ++i) {
      const float2 c = s_ig[k][lane + 32 * i];
      s += j < K ? c.x : c.y;
    }
    s = warp_sum(s);
    if (lane == 0) out[j < K ? k : 2 * K + k] = s;
  }
  if (tid <= K) {
    const int r = tid < K ? tid : KR;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < LWARPS; ++w) s += s_w[w][r];
    if (tid < K)
      out[K + tid] = s;
    else
      out[3 * K] = s;
  }
}

// K7's finish: out = ce (B), inter (B, K), pred (B, K), ground (B, K), each
// the sum of the blocks' partials in block order. A warp per (b, value):
// lane i adds blocks i, i + 32, ... in order, then the lanes by shuffles.
__global__ void __launch_bounds__(LTHREADS)
    dice_ce_sums_finish_kernel(const float* __restrict__ partial, float* __restrict__ out, int B,
                               int K, int blocks) {
  const int n = 3 * K + 1;
  const int task = blockIdx.x * LWARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (task >= B * n) return;
  const int b = task / n, j = task % n;
  float s = 0.f;
  for (int bx = lane; bx < blocks; bx += 32) s += partial[((long long)b * blocks + bx) * n + j];
  s = warp_sum(s);
  if (lane != 0) return;
  if (j == 3 * K)
    out[b] = s;
  else
    out[B + (j / K) * B * K + b * K + j % K] = s;
}

// K8: dl_k = p_k*(cb_k + cec - pu) + [k == y]*(p_y*ca_y - cec),
// pu = sum_k p_k*cb_k + p_y*ca_y.
template <typename T, int KT>
__global__ void __launch_bounds__(LTHREADS, 2)
    dice_ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                       const float* __restrict__ ca, const float* __restrict__ cb,
                       const float* __restrict__ cec, T* __restrict__ dlogits, int K_rt,
                       long long V, int vec) {
  constexpr int KR = KT ? KT : LMAXK;
  constexpr int PW = Words<T>::PW;
  constexpr int VEC = 4 * PW;
  const int K = KT ? KT : K_rt;
  __shared__ float s_a[KR];
  const int tid = threadIdx.x, b = blockIdx.y;
  if (tid < K) s_a[tid] = ca[b * K + tid];
  const T* lg = logits + (long long)b * K * V;
  T* dl = dlogits + (long long)b * K * V;
  const int* lab = labels + (long long)b * V;
  float c[KR];
#pragma unroll
  for (int k = 0; k < KR; ++k) c[k] = KT || k < K ? cb[b * K + k] : 0.f;
  const float ce_coef = cec[b];
  __syncthreads();

  // l: the voxel's logits, overwritten by its dlogits
  auto voxel = [&](float (&l)[KR], int y) {
    float m, mz, ly, z;
    const float rz = softmax_exp<KR, KT>(l, K, y, m, mz, ly, z);
    float pu = 0.f;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      if (KT || k < K) {
        l[k] *= rz;
        pu = fmaf(l[k], c[k], pu);
      }
    }
    const bool valid = (unsigned)y < (unsigned)K;
    const float py = ex2(fmaf(ly, kLog2e, -mz)) * rz;
    const float ay = valid ? s_a[y] : 0.f;
    pu = fmaf(py, ay, pu);
    const float t = ce_coef - pu, corr = fmaf(py, ay, -ce_coef);
#pragma unroll
    for (int k = 0; k < KR; ++k)
      if (KT || k < K) l[k] = fmaf(l[k], c[k] + t, k == y ? corr : 0.f);
  };

  const long long units = vec ? V / VEC : V;
  const long long stride = (long long)gridDim.x * LTHREADS;
  for (long long u = (long long)blockIdx.x * LTHREADS + tid; u < units; u += stride) {
    if (vec) {
      uint4 raw[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k)
        if (KT || k < K) raw[k] = __ldcs(reinterpret_cast<const uint4*>(lg + k * V) + u);
      int y[VEC];
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(lab) + u * (VEC / 4) + i);
        y[4 * i] = q.x;
        y[4 * i + 1] = q.y;
        y[4 * i + 2] = q.z;
        y[4 * i + 3] = q.w;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float v[PW][KR];
#pragma unroll
        for (int s = 0; s < PW; ++s) {
#pragma unroll
          for (int k = 0; k < KR; ++k)
            if (KT || k < K) v[s][k] = Words<T>::get(word_of(raw[k], w), s);
          voxel(v[s], y[w * PW + s]);
        }
#pragma unroll
        for (int k = 0; k < KR; ++k) {
          if (KT || k < K) {
            float pair[PW];
#pragma unroll
            for (int s = 0; s < PW; ++s) pair[s] = v[s][k];
            set_word(raw[k], w, Words<T>::put(pair));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KR; ++k)
        if (KT || k < K) __stcs(reinterpret_cast<uint4*>(dl + k * V) + u, raw[k]);
    } else {
      const int y = lab[u];
      float l[KR];
#pragma unroll
      for (int k = 0; k < KR; ++k)
        if (KT || k < K) l[k] = to_float<T>(lg[k * V + u]);
      voxel(l, y);
#pragma unroll
      for (int k = 0; k < KR; ++k)
        if (KT || k < K) dl[k * V + u] = from_float<T>(l[k]);
    }
  }
}

// The instantiation of a kernel for K: 14 and 2 (the routed class counts),
// else the generic one.
template <typename T, int KT>
const void* kernel_fn(int which) {
  return which == 0 ? reinterpret_cast<const void*>(&dice_ce_sums_kernel<T, KT>)
                    : reinterpret_cast<const void*>(&dice_ce_bwd_kernel<T, KT>);
}

template <typename T>
const void* kernel_for(int which, int K) {
  return K == 14 ? kernel_fn<T, 14>(which) : K == 2 ? kernel_fn<T, 2>(which)
                                                    : kernel_fn<T, 0>(which);
}

template <typename T, int KT>
cudaError_t launch_sums_k(const void* logits, const int* labels, float* out, float* partial,
                          int B, int K, long long V, int vec, int blocks, cudaStream_t st) {
  dice_ce_sums_kernel<T, KT><<<dim3(blocks, B), LTHREADS, 0, st>>>(
      static_cast<const T*>(logits), labels, partial, K, V, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tasks = B * (3 * K + 1);
  dice_ce_sums_finish_kernel<<<(tasks + LWARPS - 1) / LWARPS, LTHREADS, 0, st>>>(partial, out, B,
                                                                                K, blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sums(const void* logits, const int* labels, float* out, float* partial, int B,
                        int K, long long V, int vec, int blocks, cudaStream_t st) {
  if (K == 14) return launch_sums_k<T, 14>(logits, labels, out, partial, B, K, V, vec, blocks, st);
  if (K == 2) return launch_sums_k<T, 2>(logits, labels, out, partial, B, K, V, vec, blocks, st);
  return launch_sums_k<T, 0>(logits, labels, out, partial, B, K, V, vec, blocks, st);
}

template <typename T, int KT>
cudaError_t launch_bwd_k(const void* logits, const int* labels, const float* ca, const float* cb,
                         const float* cec, void* dlogits, int B, int K, long long V, int vec,
                         int blocks, cudaStream_t st) {
  dice_ce_bwd_kernel<T, KT><<<dim3(blocks, B), LTHREADS, 0, st>>>(
      static_cast<const T*>(logits), labels, ca, cb, cec, static_cast<T*>(dlogits), K, V, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, const int* labels, const float* ca, const float* cb,
                       const float* cec, void* dlogits, int B, int K, long long V, int vec,
                       int blocks, cudaStream_t st) {
  if (K == 14)
    return launch_bwd_k<T, 14>(logits, labels, ca, cb, cec, dlogits, B, K, V, vec, blocks, st);
  if (K == 2)
    return launch_bwd_k<T, 2>(logits, labels, ca, cb, cec, dlogits, B, K, V, vec, blocks, st);
  return launch_bwd_k<T, 0>(logits, labels, ca, cb, cec, dlogits, B, K, V, vec, blocks, st);
}

}  // namespace
}  // namespace medseg

extern "C" {

// Blocks per batch element (the grid's x extent) of K7 (which 0) or K8
// (which 1) for this dtype, K, B and V: the blocks resident on the card at
// once (K8: four times as many), shared by the B batch elements, at most
// one per 256 groups.
int medseg_dice_ce_grid(int device, int which, int bf16, int K, int B, long long V, int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || K > medseg::LMAXK || B < 1 || V < 1) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const void* fn = bf16 ? medseg::kernel_for<__nv_bfloat16>(which, K)
                        : medseg::kernel_for<float>(which, K);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, medseg::LTHREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const long long vec = bf16 ? 8 : 4;
  const long long groups = (V + vec - 1) / vec;
  const long long work = (groups + medseg::LTHREADS - 1) / medseg::LTHREADS;
  // K8 has no per-block reduction, and four waves of blocks balance its
  // tail better than one; K7's reduction and partials per block make one
  // wave its best (both measured at 1, 2 and 4 waves on the H100)
  const long long waves = which == 1 ? 4 : 1;
  const long long fill = (waves * per_sm * sms + B - 1) / B;
  *blocks = (int)(work < fill ? work : fill);
  if (*blocks < 1) *blocks = 1;
  return 0;
}

// Both return a cudaError_t value: 0 when the kernels were launched. Logits
// and dlogits are (B, K, V) in the compute dtype (bf16 != 0: bfloat16),
// labels (B, V) int32 in [0, K); vec != 0 takes the 16-byte words, which the
// caller may ask for only where V is a multiple of 8 (bf16) or 4 (fp32) and
// every tensor starts on 16 bytes (loss_of.vector_route); blocks is the
// grid's x extent per batch element (medseg_dice_ce_grid). dice_ce_sums
// writes out = ce (B), inter, pred, ground (B, K each), in that order,
// through partial (B, blocks, 3K + 1) of scratch; nothing needs zeroing.
int medseg_dice_ce_sums(int device, int bf16, const void* logits, const int* labels, float* out,
                        float* partial, int B, int K, long long V, int vec, int blocks,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || K > medseg::LMAXK || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::launch_sums<__nv_bfloat16>(logits, labels, out, partial, B, K, V, vec,
                                                blocks, st)
           : medseg::launch_sums<float>(logits, labels, out, partial, B, K, V, vec, blocks, st);
  return (int)e;
}

int medseg_dice_ce_bwd(int device, int bf16, const void* logits, const int* labels,
                       const float* ca, const float* cb, const float* cec, void* dlogits, int B,
                       int K, long long V, int vec, int blocks, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || K > medseg::LMAXK || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::launch_bwd<__nv_bfloat16>(logits, labels, ca, cb, cec, dlogits, B, K, V,
                                               vec, blocks, st)
           : medseg::launch_bwd<float>(logits, labels, ca, cb, cec, dlogits, B, K, V, vec, blocks,
                                       st);
  return (int)e;
}

}  // extern "C"
