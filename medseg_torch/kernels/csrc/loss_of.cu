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
// the ~10 FLOP and one exp per class are far below the card's balance. So
// one thread per voxel, consecutive threads on consecutive voxels (every
// class plane is read coalesced), the K <= 16 class values in registers, a
// max-subtracted exp and an exact logf (no pad classes exist here, so no
// finite stand-in for -inf is needed). K7 keeps each thread's 3*K + 1 sums
// in registers over a grid-stride loop, reduces them per block (warp
// shuffles, then shared memory) and adds one atomic per block and value into
// zeroed (B, K) and (B,) buffers: the order of those few atomics varies, so
// the sums are reproducible to rounding, not bitwise. The grid is sized to
// the SMs by the wrapper; blockIdx.y is the batch element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace medseg {
namespace {

constexpr int LMAXK = 16;  // classes held in registers
constexpr int LTHREADS = 256;
constexpr int LWARPS = LTHREADS / 32;
constexpr int NSUMS = 3 * LMAXK + 1;  // I, P, G per class, and CE

// Softmax of voxel v over the K classes into p; m is the largest logit, z
// the sum of exp(l - m), l_y the logit of class y.
template <typename T>
__device__ __forceinline__ void load_softmax(const T* __restrict__ lg, long long V, long long v,
                                             int K, int y, float (&p)[LMAXK], float& m, float& z,
                                             float& l_y) {
  l_y = 0.f;
#pragma unroll
  for (int k = 0; k < LMAXK; ++k) {
    if (k < K) {
      p[k] = to_float<T>(lg[k * V + v]);
      m = k == 0 ? p[0] : fmaxf(m, p[k]);
      if (k == y) l_y = p[k];
    }
  }
  z = 0.f;
#pragma unroll
  for (int k = 0; k < LMAXK; ++k) {
    if (k < K) {
      p[k] = expf(p[k] - m);
      z += p[k];
    }
  }
#pragma unroll
  for (int k = 0; k < LMAXK; ++k)
    if (k < K) p[k] = p[k] / z;
}

template <typename T>
__global__ void __launch_bounds__(LTHREADS)
    dice_ce_sums_kernel(const T* __restrict__ logits, const int* __restrict__ labels, float* ce,
                        float* inter, float* pred, float* ground, int K, long long V) {
  __shared__ float s_red[LWARPS][NSUMS];
  const int b = blockIdx.y;
  const T* lg = logits + (long long)b * K * V;
  const int* lab = labels + (long long)b * V;
  float si[LMAXK], sp[LMAXK], sg[LMAXK];
#pragma unroll
  for (int k = 0; k < LMAXK; ++k) si[k] = sp[k] = sg[k] = 0.f;
  float sce = 0.f;

  for (long long v = (long long)blockIdx.x * LTHREADS + threadIdx.x; v < V;
       v += (long long)gridDim.x * LTHREADS) {
    const int y = lab[v];
    float p[LMAXK], m, z, l_y;
    load_softmax<T>(lg, V, v, K, y, p, m, z, l_y);
    sce += logf(z) + m - l_y;  // -log p[label]
#pragma unroll
    for (int k = 0; k < LMAXK; ++k) {
      if (k < K) {
        sp[k] += p[k];
        if (k == y) {
          si[k] += p[k];
          sg[k] += 1.f;
        }
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < LMAXK; ++k) {
    if (k < K) {
      const float a = warp_sum(si[k]), c = warp_sum(sp[k]), d = warp_sum(sg[k]);
      if (lane == 0) {
        s_red[warp][k] = a;
        s_red[warp][LMAXK + k] = c;
        s_red[warp][2 * LMAXK + k] = d;
      }
    }
  }
  const float e = warp_sum(sce);
  if (lane == 0) s_red[warp][3 * LMAXK] = e;
  __syncthreads();
  const int j = threadIdx.x;
  if (j < NSUMS && (j % LMAXK < K || j == 3 * LMAXK)) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < LWARPS; ++w) s += s_red[w][j];
    const int k = j % LMAXK;
    if (j == 3 * LMAXK)
      atomicAdd(&ce[b], s);
    else if (j < LMAXK)
      atomicAdd(&inter[b * K + k], s);
    else if (j < 2 * LMAXK)
      atomicAdd(&pred[b * K + k], s);
    else
      atomicAdd(&ground[b * K + k], s);
  }
}

template <typename T>
__global__ void __launch_bounds__(LTHREADS)
    dice_ce_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ labels,
                       const float* ca, const float* cb, const float* cec, T* __restrict__ dlogits,
                       int K, long long V) {
  const int b = blockIdx.y;
  const T* lg = logits + (long long)b * K * V;
  T* dl = dlogits + (long long)b * K * V;
  const int* lab = labels + (long long)b * V;
  float a[LMAXK], c[LMAXK];
#pragma unroll
  for (int k = 0; k < LMAXK; ++k) {
    a[k] = k < K ? ca[b * K + k] : 0.f;
    c[k] = k < K ? cb[b * K + k] : 0.f;
  }
  const float ce_coef = cec[b];

  for (long long v = (long long)blockIdx.x * LTHREADS + threadIdx.x; v < V;
       v += (long long)gridDim.x * LTHREADS) {
    const int y = lab[v];
    float p[LMAXK], m, z, l_y;
    load_softmax<T>(lg, V, v, K, y, p, m, z, l_y);
    float pu = 0.f;
#pragma unroll
    for (int k = 0; k < LMAXK; ++k)
      if (k < K) pu += p[k] * (k == y ? a[k] + c[k] : c[k]);
#pragma unroll
    for (int k = 0; k < LMAXK; ++k) {
      if (k < K) {
        const float g = k == y ? 1.f : 0.f;
        const float u = a[k] * g + c[k];
        dl[k * V + v] = from_float<T>(ce_coef * (p[k] - g) + p[k] * (u - pu));
      }
    }
  }
}

template <typename T>
cudaError_t launch_sums(const void* logits, const int* labels, float* ce, float* inter,
                        float* pred, float* ground, int B, int K, long long V, int blocks,
                        cudaStream_t st) {
  const dim3 grid(blocks, B);
  dice_ce_sums_kernel<T><<<grid, LTHREADS, 0, st>>>(static_cast<const T*>(logits), labels, ce,
                                                     inter, pred, ground, K, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* logits, const int* labels, const float* ca, const float* cb,
                       const float* cec, void* dlogits, int B, int K, long long V, int blocks,
                       cudaStream_t st) {
  const dim3 grid(blocks, B);
  dice_ce_bwd_kernel<T><<<grid, LTHREADS, 0, st>>>(static_cast<const T*>(logits), labels, ca, cb,
                                                    cec, static_cast<T*>(dlogits), K, V);
  return cudaGetLastError();
}

}  // namespace
}  // namespace medseg

extern "C" {

// Both return a cudaError_t value: 0 when the kernel was launched. Logits
// and dlogits are (B, K, V) in the compute dtype (bf16 != 0: bfloat16),
// labels (B, V) int32 in [0, K); blocks is the grid's x extent per batch
// element. dice_ce_sums adds into ce (B,), inter / pred / ground (B, K),
// which the caller zeroes.
int medseg_dice_ce_sums(int device, int bf16, const void* logits, const int* labels, float* ce,
                        float* inter, float* pred, float* ground, int B, int K, long long V,
                        int blocks, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || K > medseg::LMAXK || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::launch_sums<__nv_bfloat16>(logits, labels, ce, inter, pred, ground, B, K, V,
                                                blocks, st)
           : medseg::launch_sums<float>(logits, labels, ce, inter, pred, ground, B, K, V, blocks,
                                        st);
  return (int)e;
}

int medseg_dice_ce_bwd(int device, int bf16, const void* logits, const int* labels,
                       const float* ca, const float* cb, const float* cec, void* dlogits, int B,
                       int K, long long V, int blocks, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || K > medseg::LMAXK || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = bf16 ? medseg::launch_bwd<__nv_bfloat16>(logits, labels, ca, cb, cec, dlogits, B, K, V,
                                               blocks, st)
           : medseg::launch_bwd<float>(logits, labels, ca, cb, cec, dlogits, B, K, V, blocks, st);
  return (int)e;
}

}  // extern "C"
